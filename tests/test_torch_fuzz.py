"""Seeded random graphs and shaders through the PyTorch port, on the CPU:
the port's counterpart of tests/test_fuzz.py, with its generators on its
seeds.

Random DAGs of the builtin kernels (its ``_random_config``) render through
the port on the tier the planner picks, per node and as a sequence, against
the JAX package per node, in every storage format (half of its seeds here,
the other half and the sharded graphs in tests/test_torch_fuzz_graphs.py).
Every shipped GLSL
shader renders finite values under its adversarial parameter draws, and
where its op list lowers (glsl/lower.py) the list is bit-equal to the
interpreter under them.  Random tap-sum shaders are recovered by the port's
conv synthesis and its nonlinear, time- and coordinate-dependent impostors
refused.  The expression and loop shaders of the same file run in
tests/test_torch_fuzz_glsl.py.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu import utils as jutils
from reforge_tpu.config import parse as jparse
from reforge_tpu.graph import build_graph as jbuild
from reforge_tpu.graph import make_program as jmake
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import REPO_DIR
from reforge_tpu_torch.config import parse
from reforge_tpu_torch.glsl import affine, lower, translate_shader
from reforge_tpu_torch.glsl.affine import ConvSynth, synthesize_conv
from reforge_tpu_torch.graph import build_graph, make_program
from reforge_tpu_torch.kernels.base import KernelContext, ParamKind
from reforge_tpu_torch.kernels.loader import load_kernel_file

import test_fuzz as ref

H, W = ref.H, ref.W


@pytest.fixture(autouse=True)
def _quiet(tmp_path, monkeypatch):
    tutils.print_warnings = False
    jutils.print_warnings = False
    monkeypatch.setattr(affine, "CACHE_DIR", tmp_path / "convsynth")
    affine._SYNTH_CACHE.clear()
    yield
    affine._SYNTH_CACHE.clear()


def _image():
    return np.random.default_rng(0).random((4, H, W), dtype=np.float32)


def _port(cfg_text: str, fmt: str):
    cfg = parse(cfg_text, expects_input=True)
    assert cfg is not None, (cfg_text, tutils.recent_warnings())
    prog = make_program(build_graph(cfg), W, H, fmt, device="cpu")
    assert prog is not None, cfg_text
    return prog


def _jax_per_node(cfg_text: str, fmt: str, img: np.ndarray, t: float) -> np.ndarray:
    jprog = jmake(jbuild(jparse(cfg_text, expects_input=True)), W, H, fmt)
    out = jprog._forward_nostrip(jnp.asarray(img), jnp.float32(t))
    return np.asarray(out.astype(jnp.float32))


def _close(fmt: str, got: np.ndarray, want: np.ndarray, what: str) -> None:
    """The port against the JAX package per node: rgba32f the reference
    test's 1e-4 between its own execution modes (relative past 1, where
    adversarial gains make large values); rgba16f one bf16 step of the
    value and rgba8 one code, a flip of one rounding carried through at
    most two more nodes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape == (4, H, W), what
    assert np.isfinite(got).all(), f"non-finite output:\n{what}"
    d = np.abs(got - want)
    if fmt == "rgba32f":
        assert (d <= 1e-4 * np.maximum(1.0, np.abs(want))).all(), (what, float(d.max()))
    elif fmt == "rgba16f":
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        assert (d <= 3 * step + 1e-6).all(), (what, float(d.max()))
    else:
        assert d.max() <= 3.0 / 255.0 + 1e-6, (what, float(d.max()))


def check_random_graph(seed: int) -> None:
    """test_fuzz.py's random graph of seed 1000 + ``seed`` in rgba32f: the
    planned tier, per node and frame 0 of a sequence against the JAX
    package per node."""
    cfg_text = ref._random_config(np.random.default_rng(1000 + seed))
    prog, img = _port(cfg_text, "rgba32f"), _image()
    x = torch.from_numpy(img.copy())
    want = _jax_per_node(cfg_text, "rgba32f", img, 0.25)
    _close("rgba32f", prog(x, 0.25).numpy(), want, cfg_text)
    _close("rgba32f", prog.run_unfused(x, 0.25).numpy(), want, cfg_text)
    seq = prog.render_sequence(x, 0.25, 0.016, 1, stack=True)
    _close("rgba32f", seq[0].numpy(), want, cfg_text)


# The reference's seeds 0-23, half here and half in tests/test_torch_fuzz_graphs.py
# (the JAX package per node, eager, takes most of a file's minute).
@pytest.mark.parametrize("seed", range(12))
def test_random_graph_renders(seed):
    check_random_graph(seed)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("fmt", ["rgba8", "rgba16f"])
def test_random_graph_formats(seed, fmt):
    """test_fuzz.py's random graphs (seeds 2000 + k) in rgba8 and rgba16f,
    on the planned tier against the JAX package per node."""
    cfg_text = ref._random_config(np.random.default_rng(2000 + seed))
    prog, img = _port(cfg_text, fmt), _image()
    x = torch.from_numpy(img.copy()).to(prog.storage_dtype)
    want = _jax_per_node(cfg_text, fmt, np.asarray(x.float().numpy()), 0.25)
    _close(fmt, prog(x, 0.25).float().numpy(), want, cfg_text)


def _shader_specs():
    out = {}
    for path in sorted(glob.glob(os.path.join(REPO_DIR, "shaders", "*.comp")) + sorted(
            glob.glob(os.path.join(REPO_DIR, "shaders", "*.frag")))):
        spec = load_kernel_file(path)
        assert spec is not None, path
        out[os.path.basename(path)] = spec
    return out


@pytest.mark.parametrize("seed", range(6))
def test_shader_param_fuzz(seed):
    """Every shipped GLSL shader that reads images only renders finite
    values through the port's interpreter under test_fuzz.py's draws
    (seeds 3000 + k, the same draws in the same order); where its op list
    lowers under them, the list is bit-equal to the interpreter."""
    rng = np.random.default_rng(3000 + seed)
    img = torch.from_numpy(rng.random((4, H, W), dtype=np.float32))
    lowered = 0
    for name, spec in _shader_specs().items():
        if spec.ssbos_in or spec.ssbos_out:
            continue
        if set(spec.images_in) - {"input_image", "input_image2"}:
            continue
        params = {}
        for pname, decl in spec.params.items():
            if pname.endswith("_rf_time") or rng.random() < 0.3:
                continue
            if decl.kind is ParamKind.FLOAT:
                params[pname] = float(rng.choice(ref.FLOAT_DRAWS))
            elif decl.kind is ParamKind.INT:
                params[pname] = int(rng.choice(ref.INT_DRAWS))
            else:
                params[pname] = bool(rng.random() < 0.5)
        ins = {"input_image": img}
        if "input_image2" in spec.images_in:
            ins["input_image2"] = img.flip(1)
        params = spec.resolve_params(params)
        ctx = KernelContext(width=W, height=H, time=0.5, device="cpu")
        outs = spec(ctx, ins, params)
        for out_name, v in outs.items():
            assert torch.isfinite(v).all(), (name, params, out_name)
        prog = lower.lower_point(spec, params, W, H)
        if isinstance(prog, str):
            continue
        gy = torch.arange(H).view(-1, 1).expand(H, W)
        gx = torch.arange(W).view(1, -1).expand(H, W)
        plain = lower.point_program_plain(prog, [ins[n] for n in spec.images_in], gy, gx, 0.5)
        torch.testing.assert_close(plain, outs["output_image"], rtol=0, atol=0,
                                   msg=f"{name} {params}")
        lowered += 1
    assert lowered >= 7  # the shipped point shaders, mandelbrot.s loop among them


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_conv_synthesis_recovers_random_tap_sums(seed):
    """test_fuzz.py's random separable tap-sums (seeds 1000 + k): the
    port's conv synthesis recovers each, and the recovered plan reproduces
    the shader on a fresh image, borders included."""
    rng = np.random.default_rng(1000 + seed)
    src, (ry, rx) = ref._conv_shader_src(rng)
    spec = translate_shader(src, f"fuzzconv{seed}", path=f"fz{seed}.comp")
    params = spec.resolve_params({})
    s = synthesize_conv(spec, params)
    assert isinstance(s, ConvSynth), f"seed {seed}: synthesis failed"
    h, w = 4 * max(ry, rx) + 21, 4 * max(ry, rx) + 27
    img = torch.from_numpy(rng.random((4, h, w), dtype=np.float32))
    ctx = KernelContext(width=w, height=h, time=0.0, device="cpu")
    want = spec(ctx, {"input_image": img}, params)["output_image"].numpy()
    x = img.numpy().astype(np.float64)
    rh, rw = len(s.wh) // 2, len(s.ww) // 2
    xp = np.pad(x, ((0, 0), (rh, rh), (0, 0)), mode="edge")
    acc = sum(wv * xp[:, i:i + h, :] for i, wv in enumerate(s.wh))
    accp = np.pad(acc, ((0, 0), (0, 0), (rw, rw)), mode="edge")
    out = sum(wv * accp[:, :, j:j + w] for j, wv in enumerate(s.ww))
    got = (np.asarray(s.scale)[:, None, None] * out
           + np.asarray(s.passthrough)[:, None, None] * x
           + np.asarray(s.offset)[:, None, None])
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_conv_synthesis_rejects_nonlinear(seed):
    rng = np.random.default_rng(2000 + seed)
    src, _ = ref._conv_shader_src(rng)
    wrap = ref.NONLINEAR_WRAPS[seed % len(ref.NONLINEAR_WRAPS)]
    src = src.replace("imageStore(output_image", wrap + "\n    imageStore(output_image")
    spec = translate_shader(src, f"fuzznl{seed}", path=f"fznl{seed}.comp")
    assert synthesize_conv(spec, spec.resolve_params({})) is None


def test_fuzz_conv_synthesis_rejects_time_and_coord_dependence():
    """The reference test's two impostors, read from its source: a tap
    weight that follows the frame time and one that follows the row."""
    src = (REPO_DIR / "tests" / "test_fuzz.py").read_text()
    shaders = src.split('"""#version 450')[1:]
    impostors = ["#version 450" + s.split('"""')[0] for s in shaders
                 if "_rf_time" in s.split('"""')[0] or "pos.y) / float(hi.y)" in s.split('"""')[0]]
    assert len(impostors) == 2
    for k, text in enumerate(impostors):
        spec = translate_shader(text, f"dep{k}", path=f"dep{k}.comp")
        assert synthesize_conv(spec, spec.resolve_params({})) is None
