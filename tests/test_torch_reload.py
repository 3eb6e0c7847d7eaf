"""Live reload with keep-last-good in the PyTorch port's Engine, on the CPU:
the cases of ``tests/test_engine.py`` (config and kernel edits, bad edits,
the async form, rapid edits, a soak of mixed edits, the spec cache, the
preview downscale), with GLSL kernel files where the reference's use
``.py`` kernels, plus resize, two builds at once and the file watcher.
"""

import os
import sys
import threading
import time
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu.engine import Engine as JEngine
from reforge_tpu.engine import RenderInfo as JRenderInfo
from reforge_tpu_torch import utils
from reforge_tpu_torch.engine import Engine, RenderInfo
from reforge_tpu_torch.graph import program
from reforge_tpu_torch.kernels import cuda_ops, loader
from reforge_tpu_torch.runtime import watcher

GAIN_SHADER = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
layout (binding = 2) uniform UBO { float gain; };
void main() {
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    imageStore(output_image, p, imageLoad(input_image, p) * (gain + %s));
}
"""


@pytest.fixture(autouse=True)
def _quiet():
    utils.print_warnings = False
    yield


def write(path, text, bump_from=None):
    with open(path, "w") as f:
        f.write(text)
    if bump_from is not None:
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, bump_from + 1_000_000))


def bump(path, text):
    write(str(path), text, bump_from=utils.get_modified_time(str(path)))


def make_engine(tmp_path, config_text, w=24, h=16, input_image=True, **kw):
    cfg = tmp_path / "graph.rf"
    write(str(cfg), config_text)
    eng = Engine(RenderInfo(w, h, "cpu", config_path=str(cfg), shader_path=str(tmp_path),
                            has_input_image=input_image, **kw))
    if input_image:
        eng.load_input(np.random.default_rng(0).integers(0, 256, (h, w, 4), dtype=np.uint8))
    return eng, str(cfg)


def frame(eng):
    return eng.render_frame_blocking(0.0).numpy()


def settle(eng, done, seconds=60.0):
    """Poll and render until ``done(frame)`` or the deadline."""
    deadline = time.time() + seconds
    while time.time() < deadline:
        eng.trigger_reloads()
        if done(frame(eng)):
            return True
        time.sleep(0.01)
    return False


def test_render_frame_and_counters(tmp_path):
    eng, _ = make_engine(tmp_path, "input -> invert -> output", num_frames=3)
    assert eng.render_frame_blocking(0.0).shape == (4, 16, 24)
    eng.render_frame(0.1)
    assert eng.frame_index == 2
    assert eng.gpu_times_str().startswith("graph: ") and eng.gpu_times_str().endswith("ms")
    eng.close()


def test_config_reload_swaps_program(tmp_path):
    eng, cfg = make_engine(tmp_path, "input -> invert -> output")
    out1 = frame(eng)
    bump(cfg, "input -> passthrough -> output")
    assert eng.trigger_reloads() is True
    assert eng.frame_index == 0 and eng.last_gpu_times == {}
    out2 = frame(eng)
    assert not np.allclose(out1, out2)
    np.testing.assert_allclose(out2, eng._input_planar.numpy(), atol=1e-6)


def test_bad_edit_keeps_last_good(tmp_path):
    eng, cfg = make_engine(tmp_path, "input -> invert -> output")
    out1 = frame(eng)
    utils.clear_warnings()
    bump(cfg, "input -> invert -> @@@garbage")
    assert eng.trigger_reloads() is False
    assert any("Invalid token" in w for w in utils.recent_warnings())
    np.testing.assert_array_equal(frame(eng), out1)
    bump(cfg, "input -> passthrough -> output")
    assert eng.trigger_reloads() is True


def test_unchanged_config_no_reload(tmp_path):
    eng, _ = make_engine(tmp_path, "input -> invert -> output")
    assert eng.trigger_reloads() is False


def test_kernel_file_edit_rebuilds_with_the_same_config(tmp_path):
    kpath = tmp_path / "gainer.comp"
    kpath.write_text(GAIN_SHADER % "0.0")
    eng, _ = make_engine(tmp_path, "input -> g -> output\ng: gainer { gain: 2.0 }")
    config = eng.config
    inp = eng._input_planar.numpy()
    np.testing.assert_allclose(frame(eng), inp * 2.0, atol=1e-6)
    bump(kpath, GAIN_SHADER % "1.0")
    assert eng.trigger_reloads() is True
    assert eng.config is config
    np.testing.assert_allclose(frame(eng), inp * 3.0, atol=1e-6)


def test_broken_kernel_edit_keeps_last_good(tmp_path):
    kpath = tmp_path / "halver.comp"
    kpath.write_text(GAIN_SHADER % "0.0")
    eng, _ = make_engine(tmp_path, "input -> h -> output\nh: halver { gain: 0.5 }")
    out1 = frame(eng)
    utils.clear_warnings()
    bump(kpath, "this is not glsl !!!")
    assert eng.trigger_reloads() is False
    assert any("Error compiling GLSL kernel" in w for w in utils.recent_warnings())
    np.testing.assert_array_equal(frame(eng), out1)


def test_config_edit_keeps_an_unchanged_shaders_spec(tmp_path):
    """The loader reuses an unchanged shader's spec (no new translation or
    reflection) across a rebuild; an edited one gets a new spec."""
    kpath = tmp_path / "gainer.comp"
    kpath.write_text(GAIN_SHADER % "0.0")
    eng, cfg = make_engine(tmp_path, "input -> g -> output\ng: gainer { gain: 2.0 }")
    spec = eng.program.graph.nodes["g"].spec
    bump(cfg, "input -> g -> output\ng: gainer { gain: 4.0 }")
    assert eng.trigger_reloads() is True
    assert eng.program.graph.nodes["g"].spec is spec
    np.testing.assert_allclose(frame(eng), eng._input_planar.numpy() * 4.0, atol=1e-6)
    assert loader.load_kernel_file(str(kpath)) is spec
    kpath.write_text(GAIN_SHADER % "0.5")
    assert loader.load_kernel_file(str(kpath)) is not spec


def test_async_compile_swap(tmp_path):
    """The poll that sees the edit only starts the build; the old program
    renders until a later poll adopts the new one."""
    eng, cfg = make_engine(tmp_path, "input -> invert -> output", async_compile=True)
    frame(eng)
    bump(cfg, "input -> passthrough -> output")
    t0 = time.perf_counter()
    first = eng.trigger_reloads()
    assert time.perf_counter() - t0 < 5.0
    inp = eng._input_planar.numpy()
    assert first or settle(eng, lambda out: np.allclose(out, inp, atol=1e-6))
    np.testing.assert_allclose(frame(eng), inp, atol=1e-6)
    eng.close()


def test_async_build_never_stalls_a_frame(tmp_path):
    """A slow build (here a second) runs on its own thread: the poll
    returns at once, frames keep coming from the old program meanwhile,
    and the new one lands afterwards."""
    eng, cfg = make_engine(tmp_path, "input -> invert -> output", async_compile=True)
    old = frame(eng)
    build = eng._build_program
    threads = []

    def slow_build(config):
        threads.append(threading.current_thread())
        time.sleep(1.0)
        return build(config)

    eng._build_program = slow_build
    bump(cfg, "input -> passthrough -> output")
    t0 = time.perf_counter()
    assert eng.trigger_reloads() is False
    assert time.perf_counter() - t0 < 0.5
    frames = 0
    while time.perf_counter() - t0 < 0.6:
        np.testing.assert_array_equal(frame(eng), old)
        frames += 1
    assert frames >= 3
    assert threads and threads[0] is not threading.main_thread()
    eng.wait_for_compiles()
    np.testing.assert_allclose(frame(eng), eng._input_planar.numpy(), atol=1e-6)
    eng.close()


def test_async_bad_edit_keeps_rendering(tmp_path):
    eng, cfg = make_engine(tmp_path, "input -> invert -> output", async_compile=True)
    out1 = frame(eng)
    bump(cfg, "totally broken @@@")
    assert eng.trigger_reloads() is False
    eng.wait_for_compiles()
    np.testing.assert_array_equal(frame(eng), out1)
    eng.close()


def test_rapid_edits_settle_on_last(tmp_path):
    eng, cfg = make_engine(tmp_path, "input -> invert -> output", async_compile=True)
    frame(eng)
    edits = [
        "input -> passthrough -> output",
        "input -> gs -> output\ngs: gaussian { sigma: 1.0 }",
        "broken @@@ config",
        "input -> invert -> output",
        "input -> gamma -> output\ngamma: gamma { value: 2.0 }",
    ]
    for text in edits:
        bump(cfg, text)
        eng.trigger_reloads()
        frame(eng)
        time.sleep(0.02)
    ref = eng._input_planar.numpy()
    assert settle(eng, lambda out: np.allclose(out[:3], ref[:3] ** 0.5, atol=1e-5))
    assert "gamma" in eng.config.graph_pipelines
    eng.close()


def test_rapid_mixed_edits_soak(tmp_path):
    """Valid and broken configs, a missing kernel and a broken shader in a
    burst: frames keep coming, all finite, and the last valid graph wins."""
    kpath = tmp_path / "soak.comp"
    kpath.write_text(GAIN_SHADER % "0.0")
    eng, cfg = make_engine(tmp_path, "input -> soak -> output\nsoak: soak { gain: 1.0 }",
                           async_compile=True)
    frame(eng)
    edits = [
        "input -> soak -> output\nsoak: soak { gain: 2.0 }",
        "broken @@@ config",
        "input -> soak -> invert -> output\nsoak: soak { gain: 2.0 }",
        "input -> nonexistent_kern -> output",
        "input -> soak -> output\nsoak: soak { gain: 3.0 }",
        "input -> soak -> @@@",
        "input -> soak -> output\nsoak: soak { gain: 4.0 }",
    ]
    for i, text in enumerate(edits):
        bump(cfg, text)
        if i == 3:
            bump(kpath, "void main() { !!! }")
        if i == 5:
            bump(kpath, GAIN_SHADER % "0.0")
        eng.trigger_reloads()
        assert np.isfinite(frame(eng)).all()
    inp = eng._input_planar.numpy()
    assert settle(eng, lambda out: np.allclose(out, inp * 4.0, atol=1e-5))
    eng.close()


def test_two_engines_rebuild_at_once(tmp_path):
    """Two engines whose build threads run at the same time (each edit a
    new GLSL spec and an affine probe) both land their own last edit."""
    engines = []
    for k in range(2):
        d = tmp_path / f"e{k}"
        d.mkdir()
        (d / "gainer.comp").write_text(GAIN_SHADER % "0.0")
        engines.append(make_engine(d, "input -> g -> output\ng: gainer { gain: 1.0 }",
                                   async_compile=True))
    for k, (eng, cfg) in enumerate(engines):
        bump(cfg, f"input -> g -> output\ng: gainer {{ gain: {2.0 + k} }}")
    for eng, _ in engines:
        eng.trigger_reloads()
    for k, (eng, _) in enumerate(engines):
        eng.wait_for_compiles()
        np.testing.assert_allclose(frame(eng), eng._input_planar.numpy() * (2.0 + k), atol=1e-6)
        eng.close()


def test_first_use_kernel_build_is_locked(monkeypatch):
    """Threads reaching the kernels' first use at once (16, more than the
    cores, with a short switch interval) build them once: the others wait
    for the first's library."""
    monkeypatch.setattr(cuda_ops, "_lib", None)
    calls = []

    def slow_build():
        calls.append(threading.current_thread().name)
        time.sleep(0.1)
        return "librf_kernels_test.so"

    monkeypatch.setattr(cuda_ops, "build_library", slow_build)
    monkeypatch.setattr(cuda_ops.ctypes, "CDLL", lambda path: mock.MagicMock(name=path))
    got = []
    threads = [threading.Thread(target=lambda: got.append(cuda_ops.load_library()))
               for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert len(calls) == 1 and len(got) == 16 and all(lib is got[0] for lib in got)


def test_resize_rebuilds_at_the_new_extent(tmp_path):
    """Without an input image a resize rebuilds at the new extent (inline,
    or adopted on a later poll with async_compile); with one, the extent
    stays the image's."""
    eng, _ = make_engine(tmp_path, "checkerboard -> output", input_image=False)
    assert eng.resize(24, 16) is False  # the current extent
    assert eng.resize(40, 20) is True
    assert eng.render_frame_blocking(0.0).shape == (4, 20, 40)
    assert (eng.info.width, eng.info.height) == (40, 20)
    (tmp_path / "async").mkdir()
    eng_async, _ = make_engine(tmp_path / "async", "checkerboard -> output", input_image=False,
                               async_compile=True)
    assert eng_async.resize(32, 8) is False
    assert eng_async.render_frame_blocking(0.0).shape == (4, 16, 24)  # the old extent meanwhile
    eng_async.wait_for_compiles()
    assert eng_async.render_frame_blocking(0.0).shape == (4, 8, 32)
    eng_async.close()
    with_image, _ = make_engine(tmp_path, "input -> invert -> output")
    assert with_image.resize(40, 20) is False


def test_read_output_scaled_matches_the_reference():
    """The preview downscale: a box average in linear light on the device,
    then the sRGB encode; the full frame where the bound covers it.
    Against a float64 box filter on the host and the JAX Engine's, within
    one code."""
    eng = Engine(RenderInfo(64, 32, "cpu", num_frames=1, has_input_image=True))
    jeng = JEngine(JRenderInfo(width=64, height=32, num_frames=1, has_input_image=True))
    out = np.random.default_rng(11).random((4, 32, 64), dtype=np.float32)
    t = torch.from_numpy(out)
    assert eng.read_output_scaled(t, None).shape == (32, 64, 4)
    np.testing.assert_array_equal(eng.read_output_scaled(t, 64), eng.read_output(t))
    for target, shape in ((32, (16, 32, 4)), (20, (10, 21, 4)), (1, (1, 2, 4))):
        small = eng.read_output_scaled(t, target)
        assert small.shape == shape, target
        step = 64 // shape[1]
        hc, wc = shape[:2]
        cells = out[:, :hc * step, :wc * step].astype(np.float64)
        cells = cells.reshape(4, hc, step, wc, step).mean(axis=(2, 4))
        want = eng.read_output(torch.from_numpy(cells.astype(np.float32)))
        assert np.abs(small.astype(int) - want.astype(int)).max() <= 1, target
        jsmall = np.asarray(jeng.read_output_scaled(jnp.asarray(out), target))
        assert np.abs(small.astype(int) - jsmall.astype(int)).max() <= 1, target


def test_watcher_sees_edits_and_falls_back_to_polling(tmp_path, monkeypatch):
    """The native watcher reports an edit in a watched directory once; a
    checkout that cannot build it polls mtimes every frame, with one
    warning."""
    path = tmp_path / "graph.rf"
    path.write_text("x")
    fw = watcher.FileWatcher([str(path)])
    assert fw.active and fw.poll() is False
    path.write_text("y")
    assert fw.poll() is True and fw.poll() is False
    fw.close()
    monkeypatch.setattr(watcher, "_lib", None)
    monkeypatch.setattr(watcher, "_lib_tried", False)
    monkeypatch.setattr(watcher, "LIB_PATH", tmp_path / "none" / "libreforge_watch.so")
    monkeypatch.setattr("shutil.which", lambda _name: None)
    utils.clear_warnings()
    fallback = watcher.FileWatcher([str(path)])
    assert not fallback.active and fallback.poll() is True and fallback.poll() is True
    watcher.FileWatcher([str(path)])
    assert sum("File watcher" in w for w in utils.recent_warnings()) == 1
    eng, cfg = make_engine(tmp_path, "input -> invert -> output")
    assert eng._watcher is None
    bump(cfg, "input -> passthrough -> output")
    assert eng.trigger_reloads() is True


# ---- the program caches across rebuilds ---------------------------------------

FIVE_NODES = ("input -> a -> b -> c -> d -> e -> output\n"
              "a: gaussian { sigma: 2.0 }\nb: sobel {}\nc: tonemap { exposure: %s }\n"
              "d: invert {}\ne: vignette {}\n")
HALF_PY = ("from reforge_tpu_torch.kernels import kernel\n"
           "@kernel('half', register=False)\n"
           "def half(ctx, input_image):\n"
           "    return input_image%s * 0.5\n")


@pytest.fixture
def cold_caches(monkeypatch):
    """Empty program and node-check caches, and counts of the shape checks
    and plannings that run."""
    monkeypatch.setattr(program, "_PROGRAMS", {})
    monkeypatch.setattr(program, "_NODE_CHECKS", {})
    calls = {"check": 0, "plan": 0}
    check, plan = program.GraphProgram._check_shapes, program.GraphProgram._plan_strip_fusion

    def counted_check(self):
        calls["check"] += 1
        return check(self)

    def counted_plan(self):
        calls["plan"] += 1
        return plan(self)

    monkeypatch.setattr(program.GraphProgram, "_check_shapes", counted_check)
    monkeypatch.setattr(program.GraphProgram, "_plan_strip_fusion", counted_plan)
    return calls


def _cold_frame(tmp_path, config_text, kernel_file=None):
    """A frame of ``config_text`` from a fresh engine with every cache
    empty (in a directory of its own, with a copy of ``kernel_file``)."""
    d = tmp_path / "cold"
    d.mkdir()
    if kernel_file is not None:
        (d / kernel_file.name).write_text(kernel_file.read_text())
    saved = dict(program._PROGRAMS), dict(program._NODE_CHECKS), dict(loader._spec_cache)
    program._PROGRAMS.clear()
    program._NODE_CHECKS.clear()
    loader._spec_cache.clear()
    try:
        eng, _ = make_engine(d, config_text)
        assert not eng.program.from_cache
        return frame(eng)
    finally:
        program._PROGRAMS.update(saved[0])
        program._NODE_CHECKS.update(saved[1])
        loader._spec_cache.update(saved[2])


def test_config_edit_back_hits_the_program_cache(tmp_path, cold_caches):
    """A -> B -> A: the second A takes the first A's checked and planned
    program (no shape check, no planning) and renders bit-equal to a cold
    build of A; B checks only the node it changed."""
    a, b = FIVE_NODES % "1.0", FIVE_NODES % "1.5"
    eng, cfg = make_engine(tmp_path, a)
    assert not eng.program.from_cache and eng.program.nodes_checked == 5
    assert eng.program._strip_plan[0] == "mc" and cold_caches == {"check": 1, "plan": 1}
    first = frame(eng)
    bump(cfg, b)
    assert eng.trigger_reloads() is True
    assert not eng.program.from_cache and eng.program.nodes_checked == 1
    assert cold_caches == {"check": 2, "plan": 2}
    assert not np.array_equal(frame(eng), first)
    bump(cfg, a)
    assert eng.trigger_reloads() is True
    assert eng.program.from_cache and eng.program.nodes_checked == 0
    assert cold_caches == {"check": 2, "plan": 2}
    np.testing.assert_array_equal(frame(eng), first)
    np.testing.assert_array_equal(_cold_frame(tmp_path, a), first)


def test_shader_edit_back_hits_the_program_cache(tmp_path, cold_caches):
    """A -> B -> A of a shader's text: the loader gives the second A the
    first A's spec, so the program cache hits, and the frame is bit-equal
    to a cold build."""
    kpath = tmp_path / "gainer.comp"
    kpath.write_text(GAIN_SHADER % "0.0")
    config = "input -> g -> output\ng: gainer { gain: 2.0 }"
    eng, _ = make_engine(tmp_path, config)
    spec = eng.program.graph.nodes["g"].spec
    first = frame(eng)
    bump(kpath, GAIN_SHADER % "1.0")
    assert eng.trigger_reloads() is True and not eng.program.from_cache
    assert eng.program.nodes_checked == 1
    bump(kpath, GAIN_SHADER % "0.0")
    assert eng.trigger_reloads() is True
    assert eng.program.graph.nodes["g"].spec is spec
    assert eng.program.from_cache and cold_caches["check"] == 2
    np.testing.assert_array_equal(frame(eng), first)
    np.testing.assert_array_equal(_cold_frame(tmp_path, config, kpath), first)


def test_edit_of_one_node_of_five_checks_one_node(tmp_path, cold_caches):
    eng, cfg = make_engine(tmp_path, FIVE_NODES % "1.0")
    for k, exposure in enumerate(("1.25", "0.75", "1.5")):
        bump(cfg, FIVE_NODES % exposure)
        assert eng.trigger_reloads() is True
        assert eng.program.nodes_checked == 1 and cold_caches["check"] == 2 + k
    # A rewiring checks the node it rewires: e reads c's output now.
    bump(cfg, FIVE_NODES.replace("d -> e", "e").replace("d: invert {}\n", "") % "1.0")
    assert eng.trigger_reloads() is True and eng.program.nodes_checked == 1


def test_bad_edit_is_still_rejected(tmp_path, cold_caches):
    """A changed node keeps its check: a .py kernel edited to return the
    wrong shape is refused with its diagnostic, again on a second bad edit
    (a failed check is never remembered), while the last good program
    renders; the good text back hits the cache."""
    kpath = tmp_path / "half.py"
    kpath.write_text(HALF_PY % "")
    eng, _ = make_engine(tmp_path, "input -> gs -> half -> output\ngs: gaussian { sigma: 1.0 }")
    good = frame(eng)
    for _ in range(2):
        utils.clear_warnings()
        bump(kpath, HALF_PY % "[:, :8]")
        assert eng.trigger_reloads() is False
        assert any("Graph build failed" in w and "kernel 'half' output 'output_image' has shape"
                   in w for w in utils.recent_warnings()), utils.recent_warnings()
        np.testing.assert_array_equal(frame(eng), good)
    bump(kpath, HALF_PY % "")
    assert eng.trigger_reloads() is True and eng.program.from_cache
    np.testing.assert_array_equal(frame(eng), good)


def test_program_cache_drops_its_oldest_half(cold_caches):
    """Past 64 graph signatures the oldest 32 go (the reference's bound)."""
    from reforge_tpu_torch.config import parse
    from reforge_tpu_torch.graph import build_graph, make_program

    def build(k):
        text = f"input -> n -> output\nn: exposure {{ stops: {k / 100.0} }}"
        return make_program(build_graph(parse(text, expects_input=True)), 8, 4, device="cpu")

    for k in range(program._PROGRAMS_MAX):
        assert not build(k).from_cache
    assert len(program._PROGRAMS) == program._PROGRAMS_MAX
    assert not build(program._PROGRAMS_MAX).from_cache
    assert len(program._PROGRAMS) == program._PROGRAMS_MAX // 2 + 1
    assert not build(0).from_cache  # dropped
    assert build(program._PROGRAMS_MAX - 1).from_cache and build(program._PROGRAMS_MAX).from_cache
