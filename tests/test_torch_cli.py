"""The PyTorch port's command line on the CPU (``--backend cpu``): the
reference's CLI cases (``tests/test_engine.py:149-230`` and ``:302-330``,
``tests/test_window.py:83-140``) with the port, the port's own rules
(no CPU fallback, multi-device not ported, a ``.py`` kernel module
that fails to load, ``--debug-nans``), and the slice against the JAX package's CLI on the
same PNG within one u8 code (the goldens' bound)."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from reforge_tpu import utils as jutils
from reforge_tpu.cli import main as jmain
from reforge_tpu_torch import utils
from reforge_tpu_torch.benchmarks import DEMO_CONFIG, FLAGSHIP_CONFIG, GLSL_GRAPHS, REPO_DIR
from reforge_tpu_torch.cli import main
from reforge_tpu_torch.io import encode

from test_torch_glsl_graph import _quiet_and_fresh_synthesis  # noqa: F401

HALF_SHADER = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    imageStore(output_image, p, imageLoad(input_image, p) * 0.5);
}
"""
NAN_SHADER = HALF_SHADER.replace("imageLoad(input_image, p) * 0.5",
                                 "vec4(sqrt(-1.0 - imageLoad(input_image, p).r))")


@pytest.fixture(autouse=True)
def _quiet_from_the_root(monkeypatch):
    """Quiet diagnostics, and the repository root as the working directory
    (the default shader path ``shaders`` is relative, as for a user)."""
    utils.print_warnings = False
    jutils.print_warnings = False
    monkeypatch.chdir(REPO_DIR)
    yield


def _image(path, h, w, seed, opaque=True):
    rgba = np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    if opaque:
        rgba[..., 3] = 255
    encode(str(path), rgba)
    return rgba


def _read(path):
    return np.asarray(Image.open(str(path)).convert("RGBA"))


def test_headless_end_to_end(tmp_path):
    """The default passthrough config is lossless."""
    rgba = _image(tmp_path / "in.png", 32, 48, seed=3)
    outp = tmp_path / "out.png"
    assert main(["-i", str(tmp_path / "in.png"), "-o", str(outp), "--backend", "cpu"]) == 0
    np.testing.assert_array_equal(_read(outp), rgba)


def test_headless_with_config(tmp_path):
    _image(tmp_path / "in.png", 16, 16, seed=1)
    cfg = tmp_path / "g.rf"
    cfg.write_text("input -> invert -> output")
    outp = tmp_path / "out.png"
    assert main(["-i", str(tmp_path / "in.png"), "-o", str(outp), "--config", str(cfg),
                 "--shader-path", str(tmp_path), "--backend", "cpu"]) == 0
    assert _read(outp).shape == (16, 16, 4)


def test_width_keeps_the_aspect(tmp_path):
    """``--width`` alone: get_dim scales the height, Lanczos resizes."""
    _image(tmp_path / "in.png", 24, 32, seed=2)
    outp = tmp_path / "out.png"
    assert main(["-i", str(tmp_path / "in.png"), "-o", str(outp), "--width", "64",
                 "--backend", "cpu"]) == 0
    assert _read(outp).shape == (48, 64, 4)


def test_conflicting_args():
    assert main(["shader.comp", "--config", "x.rf", "--backend", "cpu"]) == 1


def test_missing_input_file(tmp_path):
    assert main(["-i", str(tmp_path / "missing.png"), "-o", str(tmp_path / "y.png"),
                 "--backend", "cpu"]) == 1


def test_reference_style_positionals(tmp_path):
    """``reforge <input-file> [output-file]`` (reference main.rs:45-48)."""
    rgba = _image(tmp_path / "in.png", 16, 24, seed=5)
    outp = tmp_path / "out.png"
    assert main([str(tmp_path / "in.png"), str(outp), "--backend", "cpu"]) == 0
    np.testing.assert_array_equal(_read(outp), rgba)


def test_shader_plus_image_positionals(tmp_path):
    """A ``.comp`` kernel given positionally runs single-shader mode, as
    the JAX CLI runs it."""
    _image(tmp_path / "in.png", 8, 8, seed=6)
    shp = tmp_path / "half.comp"
    shp.write_text(HALF_SHADER)
    outs = [tmp_path / "port.png", tmp_path / "jax.png"]
    assert main([str(shp), str(tmp_path / "in.png"), str(outs[0]), "--backend", "cpu"]) == 0
    assert jmain([str(shp), str(tmp_path / "in.png"), str(outs[1]), "--backend", "cpu"]) == 0
    assert np.abs(_read(outs[0]).astype(int) - _read(outs[1]).astype(int)).max() <= 1


def test_py_kernel_is_not_ported(tmp_path):
    """A .py kernel module that fails to load: exit 1, no output, and the
    loader's diagnostic (the working .py path is in test_torch_pykernel.py)."""
    _image(tmp_path / "in.png", 8, 8, seed=7)
    shp = tmp_path / "half.py"
    shp.write_text("raise RuntimeError('a broken kernel module')\n")
    outp = tmp_path / "out.png"
    assert main([str(shp), str(tmp_path / "in.png"), str(outp), "--backend", "cpu"]) == 1
    assert not outp.exists()
    assert any("Error loading kernel module" in w and "a broken kernel module" in w
               for w in utils.recent_warnings())


def test_positional_conflicts():
    assert main(["a.png", "-i", "b.png", "--backend", "cpu"]) == 1
    assert main(["a.png", "b.png", "c.png", "--backend", "cpu"]) == 1
    assert main(["x.comp", "y.comp", "--backend", "cpu"]) == 1
    assert main(["a.png", "out.png", "-o", "z.png", "--backend", "cpu"]) == 1


@pytest.mark.parametrize("flags,rc", [(["--shard", "2"], 1), (["--shard", "3"], 1),
                                      (["--shard", "1"], 0), (["--shard", "0"], 0)])
def test_multi_device_is_not_ported(tmp_path, capsys, flags, rc):
    """``--shard N`` past the devices (the CPU is one) exits 1 with the
    reference's message and writes nothing: nothing runs unsharded in its
    place; ``--shard 1`` renders the one-slab sharded program, equal to the
    unsharded render."""
    _image(tmp_path / "in.png", 8, 8, seed=8)
    outp = tmp_path / "o.png"
    argv = ["-i", str(tmp_path / "in.png"), "-o", str(outp), "--backend", "cpu"]
    assert main(argv + flags) == rc
    if rc:
        n = flags[1]
        assert f"requested {n} devices, have 1" in capsys.readouterr().err
        assert not outp.exists()
    else:
        plain = tmp_path / "plain.png"
        assert main(["-i", str(tmp_path / "in.png"), "-o", str(plain), "--backend", "cpu"]) == 0
        assert outp.read_bytes() == plain.read_bytes()


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_the_card_without_a_gpu_returns_1(tmp_path, capsys, backend):
    """No CPU fallback: without a CUDA device the card's backends print a
    diagnostic and return 1, and nothing is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _image(tmp_path / "in.png", 8, 8, seed=9)
    outp = tmp_path / "o.png"
    argv = ["-i", str(tmp_path / "in.png"), "-o", str(outp)]
    assert main(argv + (["--backend", backend] if backend != "auto" else [])) == 1
    assert "CUDA device" in capsys.readouterr().err and not outp.exists()


def test_python_m_entry_point(tmp_path):
    """``python -m reforge_tpu_torch``: the card by default (exit 1 and a
    diagnostic without one), the CPU when asked."""
    _image(tmp_path / "in.png", 8, 8, seed=10)
    outp = tmp_path / "o.png"
    base = [sys.executable, "-m", "reforge_tpu_torch", "-i", str(tmp_path / "in.png"),
            "-o", str(outp)]
    env = dict(os.environ, PYTHONPATH=str(REPO_DIR))
    if not torch.cuda.is_available():
        proc = subprocess.run(base, capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode == 1 and "CUDA device" in proc.stderr
    proc = subprocess.run(base + ["--backend", "cpu"], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _read(outp).shape == (8, 8, 4)


def test_batch_directory(tmp_path):
    """Five images in a directory, each equal within one code to the
    single-image render (batch runs the strip tier, a single image the
    one-shot per node)."""
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    for i in range(5):
        _image(indir / f"f{i}.png", 16, 24, seed=20 + i)
    cfg = tmp_path / "g.rf"
    cfg.write_text(FLAGSHIP_CONFIG)
    common = ["--config", str(cfg), "--shader-path", str(tmp_path), "--backend", "cpu"]
    assert main(["-i", str(indir), "-o", str(outdir)] + common) == 0
    assert sorted(p.name for p in outdir.iterdir()) == [f"f{i}.png" for i in range(5)]
    single = tmp_path / "single.png"
    assert main(["-i", str(indir / "f2.png"), "-o", str(single)] + common) == 0
    assert np.abs(_read(outdir / "f2.png").astype(int) - _read(single).astype(int)).max() <= 1


def test_batch_glob_with_a_pattern(tmp_path):
    for i in range(2):
        _image(tmp_path / f"shot{i}.png", 8, 8, seed=30 + i)
    pattern = str(tmp_path / "out_{}.png")
    assert main(["-i", str(tmp_path / "shot*.png"), "-o", pattern, "--backend", "cpu"]) == 0
    assert (tmp_path / "out_shot0.png").exists() and (tmp_path / "out_shot1.png").exists()


def test_batch_requires_output(tmp_path):
    for i in range(2):
        _image(tmp_path / f"f{i}.png", 8, 8, seed=40 + i)
    assert main(["-i", str(tmp_path), "--backend", "cpu"]) == 1


def test_live_loop_in_a_window(tmp_path, monkeypatch):
    """The live loop with pygame's dummy driver: three frames, shown
    through read_output_scaled, then the window closed."""
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    _image(tmp_path / "in.png", 32, 40, seed=50)
    try:
        assert main(["-i", str(tmp_path / "in.png"), "--preview", "window", "--frames", "3",
                     "--backend", "cpu"]) == 0
        assert not pygame.display.get_init()
    finally:
        if pygame.display.get_init():
            pygame.display.quit()


def test_live_loop_kitty(tmp_path, capsys):
    _image(tmp_path / "in.png", 16, 20, seed=51)
    assert main(["-i", str(tmp_path / "in.png"), "--preview", "kitty", "--frames", "2",
                 "--backend", "cpu"]) == 0
    captured = capsys.readouterr()
    assert captured.out.count("\x1b_Ga=T,f=32,s=20,v=16,o=z") == 2
    assert captured.err.count("Frame:") == 2


def test_profile_writes_trace(tmp_path):
    _image(tmp_path / "in.png", 16, 20, seed=52)
    tdir = tmp_path / "trace"
    assert main(["-i", str(tmp_path / "in.png"), "-o", str(tmp_path / "out.png"),
                 "--profile", str(tdir), "--backend", "cpu"]) == 0
    assert glob.glob(str(tdir / "*.json")), "no profiler trace written"


@pytest.mark.parametrize("mode", ["one-shot", "per-node live loop"])
def test_debug_nans_names_the_node(tmp_path, mode):
    _image(tmp_path / "in.png", 8, 8, seed=53)
    (tmp_path / "nan.comp").write_text(NAN_SHADER)
    cfg = tmp_path / "g.rf"
    cfg.write_text("input -> nan -> inv -> output\ninv: invert {}")
    argv = ["-i", str(tmp_path / "in.png"), "--config", str(cfg), "--shader-path",
            str(tmp_path), "--backend", "cpu"]
    if mode == "one-shot":
        argv += ["-o", str(tmp_path / "out.png")]
        node = "inv"  # the frame's output: the node that wrote it
    else:
        argv += ["--preview", "none", "--frames", "1", "--timing", "per-node"]
        node = "nan"  # per node: the first node with a NaN
    assert main(argv) == 0  # checked only under the flag
    with pytest.raises(FloatingPointError, match=f"node '{node}'"):
        main(argv + ["--debug-nans"])


SLICE_CASES = {
    "flagship rgba32f": (FLAGSHIP_CONFIG, "rgba32f", "empty"),
    "flagship rgba16f": (FLAGSHIP_CONFIG, "rgba16f", "empty"),
    "demo rgba32f": (DEMO_CONFIG, "rgba32f", "empty"),
    "glsl_chain rgba32f": (GLSL_GRAPHS["glsl_chain"], "rgba32f", "shaders"),
}


@pytest.mark.parametrize("case", SLICE_CASES)
def test_slice_matches_the_jax_cli(case, tmp_path, _quiet_and_fresh_synthesis):  # noqa: F811
    """The same 64x48 PNG through ``reforge_tpu.cli.main`` and the port's
    ``main`` (both ``--backend cpu``, one-shot), both files read with
    Pillow: within one u8 code."""
    text, fmt, shaders = SLICE_CASES[case]
    _image(tmp_path / "in.png", 48, 64, seed=60, opaque=False)
    cfg = tmp_path / "g.rf"
    cfg.write_text(text)
    (tmp_path / "empty").mkdir()
    shader_path = str(tmp_path / "empty") if shaders == "empty" else "shaders"
    outs = [tmp_path / "port.png", tmp_path / "jax.png"]
    for fn, out in zip((main, jmain), outs):
        assert fn(["-i", str(tmp_path / "in.png"), "-o", str(out), "--config", str(cfg),
                   "--shader-path", shader_path, "--shader-format", fmt, "--backend", "cpu"]) == 0
    d = np.abs(_read(outs[0]).astype(int) - _read(outs[1]).astype(int))
    assert d.max() <= 1, (case, int(d.max()), int((d > 1).sum()))


@pytest.mark.parametrize("dims", [(800, 600, None, None), (1920, 1080, 3840, None),
                                  (1920, 1080, None, 720), (3, 1000, 1, None),
                                  (64, 48, 17, 11)])
def test_utils_match_the_reference(dims):
    """get_dim and moving_avg: the port's copies behave as the JAX
    package's."""
    assert utils.get_dim(*dims) == jutils.get_dim(*dims)
    avg, javg = 0.0, 0.0
    for v in dims[:2]:
        avg, javg = utils.moving_avg(avg, v), jutils.moving_avg(javg, v)
    assert avg == javg and utils.MOVING_AVG_WINDOW == jutils.MOVING_AVG_WINDOW
