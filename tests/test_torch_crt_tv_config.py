"""The crt_tv_4k configuration of the benchmark (perfbench/configs/crt_tv_4k:
examples/crt_tv.rf with a frozen shaders/crt.frag) on the CPU: its plain
float64 reference against the port through Engine, the plan it takes, the
reference's float32 geometry against the interpreter's at the full
3840x2160, and the interpreter's ``glsl`` span and ``COUNTS`` on the same
graph with a crt.frag that stays in the interpreter (``PER_NODE_CRT``)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import check, harness
from reforge_tpu_torch import trace, utils
from reforge_tpu_torch.benchmarks import plan_steps
from reforge_tpu_torch.engine import Engine, RenderInfo
from reforge_tpu_torch.glsl import interp, translate_shader
from reforge_tpu_torch.graph import program
from reforge_tpu_torch.kernels.base import KernelContext

CONFIG = "crt_tv_4k"
DIR = harness.config_dir(CONFIG)
# The port's f32 path reads 1.7e-7 to 1.9e-7 against the float64 reference
# at these sizes (values of order 1, a few dozen f32 roundings, the
# geometry bit-equal); its bf16 storage (rgba16f), the next precision
# down, reads 3e-3.  The tolerance sits 10x over the first and 1500x under
# the second.
TOL = 2e-6
# crt.frag with an f16 conversion the op lists lack (packHalf2x16, whose
# bits it adds to alpha as zero): the same frames, but the node runs per
# node in the interpreter, as every crt.frag did before texture() lowered
# to gathers.
PER_NODE_CRT = ("    out_color = vec4(c.rgb * inside * line * vig, 1.0);",
                "    out_color = vec4(c.rgb * inside * line * vig,\n"
                "                     1.0 + 0.0 * float(packHalf2x16(c.rg) & 0u));")


@pytest.fixture(autouse=True)
def _quiet_and_cold(monkeypatch):
    """No warnings, empty program caches and span stores."""
    utils.print_warnings = False
    monkeypatch.setattr(program, "_PROGRAMS", {})
    monkeypatch.setattr(program, "_NODE_CHECKS", {})
    trace.SPANS.clear()
    yield


def _engine(size, fmt="rgba32f", seed=7, shader_path=None):
    cfg = harness.load_config(CONFIG)
    cfg["height"], cfg["width"] = size
    engine = Engine(RenderInfo(width=size[1], height=size[0], device="cpu",
                               config_path=str(DIR / cfg["graph"]),
                               shader_path=shader_path or str(DIR / cfg["shader_path"]),
                               fmt=fmt, has_input_image=True))
    u8 = harness.make_input(seed, *size, torch.device("cpu"))
    engine.load_input(u8.numpy())
    return engine, cfg, u8


def _err(size, seed, fmt="rgba32f"):
    engine, cfg, u8 = _engine(size, fmt, seed)
    frames = engine.program.render_sequence(engine._file_input(), 0.0, 1 / 30, 2, stack=True)
    engine.close()
    ref = harness.config_module(CONFIG, "reference").frame(u8, cfg)
    return max(check.frame_err(f, ref) for f in frames)


@pytest.mark.parametrize("seed", [5, 2**31 + 11, 2**40 + 3])
@pytest.mark.parametrize("size", [(72, 128), (55, 97)])
def test_reference_against_the_port(size, seed):
    assert _err(size, seed) < TOL


@pytest.mark.parametrize("size", [(72, 128), (55, 97)])
def test_the_control_fails_the_tolerance(size):
    assert _err(size, 2**31 + 11, fmt="rgba16f") > 100 * TOL


def test_the_plan_is_a_segment_on_mc_then_crt_per_node():
    """crt.frag's texture() lowers to gathers of its segment's input, so
    crt takes a graph_strip_mc launch of its own after fade and soften's
    (it gathers soften's output, which keeps it out of their launch); with
    an op the lists lack, it runs per node as it did before."""
    engine, _, _ = _engine((72, 128))
    assert plan_steps(engine.program) == [("seg mc", ["fade", "soften"]), ("seg mc", ["crt"])]
    engine.close()


@pytest.fixture
def per_node_crt(tmp_path):
    """A shader path whose crt.frag stays in the interpreter (PER_NODE_CRT)."""
    src = (DIR / "shaders" / "crt.frag").read_text()
    assert src.count(PER_NODE_CRT[0]) == 1
    (tmp_path / "crt.frag").write_text(src.replace(*PER_NODE_CRT))
    engine, _, _ = _engine((72, 128), shader_path=str(tmp_path))
    assert plan_steps(engine.program) == [("seg mc", ["fade", "soften"]), ("node", ["crt"])]
    engine.close()
    program._PROGRAMS.clear()  # the test's own empty caches, as it found them
    program._NODE_CHECKS.clear()
    return str(tmp_path)


def test_the_geometry_at_4k_is_the_interpreters_bit_for_bit(monkeypatch):
    """crt.frag through the interpreter at 3840x2160 on an image of ones:
    ``texture()`` then returns 1 exactly, so the output's red is zero just
    outside the tube (scanline and vignette stay above 0.2), and the floor
    calls inside ``texture()`` see the texel coordinates."""
    h, w = 2160, 3840
    crt = harness.load_config(CONFIG)["params"]["crt"]
    path = DIR / "shaders" / "crt.frag"
    spec = translate_shader(path.read_text(), "crt", str(path))
    seen, state = [], {"in": False}
    real_texture, real_floor = interp.Interp._texture, torch.floor

    def texture(self, *args):
        state["in"] = True
        try:
            return real_texture(self, *args)
        finally:
            state["in"] = False

    def floor(x, *args, **kwargs):
        if state["in"]:
            seen.append(x)
        return real_floor(x, *args, **kwargs)

    ones = torch.ones((), dtype=torch.float32).expand(4, h, w)
    params = {k: v for k, v in crt.items() if k != "kernel"}
    with monkeypatch.context() as m:
        m.setattr(interp.Interp, "_texture", texture)
        m.setattr(torch, "floor", floor)
        red = spec(KernelContext(width=w, height=h, device="cpu"), {"input_image": ones},
                   params)["output_image"][0]
    ref = harness.config_module(CONFIG, "reference").geometry(h, w, crt["curvature"])
    assert len(seen) == 2
    assert torch.equal(seen[0], ref["tx"].expand(h, w))
    assert torch.equal(seen[1], ref["ty"].expand(h, w))
    inside = ref["inside"].expand(h, w)
    assert torch.equal(red != 0, inside)
    assert 0 < int(inside.sum()) < h * w  # the tube cuts the corners


def test_one_glsl_range_a_frame_under_a_profiler_and_none_without(per_node_crt):
    engine, _, _ = _engine((72, 128), shader_path=per_node_crt)
    x = engine._file_input()
    engine.program.render_sequence(x, 0.0, 0.1, 2, stack=True)
    assert not trace.SPANS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.program.render_sequence(x, 0.0, 0.1, 3, stack=True)
    ranges = [e for e in prof.events() if e.name == "rf.glsl"]
    assert len(ranges) == 3
    glsl = [s for s in trace.SPANS if s.name == "glsl"]
    assert len(glsl) == 3
    for sp in glsl:
        assert sp.parent.name == "node" and sp.parent.attrs["node"] == "crt"
        assert sp.attrs["shader"] == "crt" and sp.attrs["stage"] == "fragment"
        assert sp.attrs["ops"] == glsl[0].attrs["ops"] > 0
    engine.close()


def test_the_counter_gains_a_run_a_frame_and_nothing_from_the_shape_check(per_node_crt):
    before = dict(interp.COUNTS)
    gathers = dict(program.GLSL_GATHER_RUNS)
    engine, _, _ = _engine((72, 128), shader_path=per_node_crt)
    assert engine.program.nodes_checked == 3  # the check ran crt.frag on meta
    assert interp.COUNTS == before and program.GLSL_GATHER_RUNS == gathers
    x = engine._file_input()
    per_frame = []
    for i in range(3):
        start = dict(interp.COUNTS)
        engine.program.render_sequence(x, i * 0.1, 0.1, 1, stack=True)
        per_frame.append({k: interp.COUNTS[k] - start[k] for k in start})
    engine.close()
    assert per_frame[0]["runs"] == 1 and per_frame[0]["samples"] == 1
    assert per_frame[0]["ops"] > 0
    assert per_frame == [per_frame[0]] * 3
    # crt, of halo None, counted a frame as the interpreter's
    assert program.GLSL_GATHER_RUNS == {"op_list": gathers["op_list"],
                                        "interpreter": gathers["interpreter"] + 3}
