"""The crt_tv_4k.seq cell on the CPU at a small size (sound, and the
control), its configuration's params against the graph text and its
shader, its least work by hand, and the readers of the interpreter's
counter and span on hand-placed records."""

import pytest

from perfbench import harness
from perfbench.devtrace import Trace
from perfbench.harness import Record

CELL = "crt_tv_4k.seq"
CONFIG = "crt_tv_4k"
SIZE = (72, 128)
FAST = {"warmup": 2, "hold": 3}
PIXELS = 3840 * 2160


def _run(fmt=None):
    return harness.run_cell(CELL, 2**31 + 77, 0.2, False, device="cpu", size=SIZE,
                            mix_overrides=FAST, fmt=fmt)


def test_a_sound_run_is_correct():
    line = _run()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in harness.reported(
        harness.manifest(), CELL, traced=False)} == {"seq_fps", "setup_s"}


def test_the_control_is_not_correct():
    line = _run(fmt="rgba16f")
    assert not line["correct"]
    assert line["checks"]["frame_err"]["value"] > 10 * line["checks"]["frame_err"]["limit"]


def test_params_agree_with_the_graph_text_and_the_shader():
    from reforge_tpu_torch.config import parse_file

    cfg = harness.load_config(CONFIG)
    d = harness.config_dir(CONFIG)
    parsed = parse_file((d / cfg["graph"]).read_text(), True, str(d / cfg["shader_path"]))
    assert set(cfg["params"]) == set(parsed.graph_pipelines) == {"fade", "soften", "crt"}
    for node, params in cfg["params"].items():
        path = parsed.graph_pipelines[node].file_path
        if params["kernel"].endswith(".frag"):
            assert path == str(d / cfg["shader_path"] / params["kernel"])
        else:
            assert path == "" and parsed.pipeline_type_of(node) == params["kernel"]
        given = {k: v.value for k, v in parsed.parameters_of(node).items()}
        assert given == {k: v for k, v in params.items() if k in given}, node
        for key in set(params) - set(given) - {"kernel"}:
            assert any(key in k for k in cfg["assumed"]), (node, key)
    repo = harness.REPO
    assert (d / "graph.rf").read_text() == (repo / "examples" / "crt_tv.rf").read_text()
    assert (d / "shaders" / "crt.frag").read_text() == (repo / "shaders" / "crt.frag").read_text()


def test_least_work_by_hand():
    # fade: the matrix 15 (a multiply and two FMAs a row), the luma 5,
    # y + (rgb - y) s + l on rgb 12.  soften: 7 taps (r = ceil(2.4) = 3), two
    # passes, four channels, an FMA a tap: 112.  crt.frag: the geometry 32
    # (centered 4, dot 3, 1 + k dot 2, warped 2, suv 4, clamp 4, inside 5,
    # texel coordinate 4, floor and weight 4), the bilinear on rgb 27, the
    # scanline 6, the vignette 2, rgb * inside * line * vig 9.
    w = harness.config_module(CONFIG, "work").least_work(harness.load_config(CONFIG))
    assert w["flops"] == PIXELS * (32 + 112 + 32 + 27 + 6 + 2 + 9) == PIXELS * 220
    assert w["bytes"] == PIXELS * 32
    # Bytes-bound on the H100: 0.0792 ms against 0.0272.
    assert w["bytes"] / 3.35e12 == pytest.approx(7.923e-5, rel=1e-3)
    assert w["flops"] / 67e12 == pytest.approx(2.724e-5, rel=1e-3)


@pytest.fixture
def counts(monkeypatch):
    from reforge_tpu_torch.glsl import interp
    from reforge_tpu_torch.graph import program

    def put(ops, in_place, copied):
        monkeypatch.setattr(interp, "COUNTS", {"runs": 0, "ops": ops, "samples": 0})
        monkeypatch.setattr(program, "SEQUENCE_FRAMES", {"in_place": in_place, "copied": copied})

    return put


def test_ops_per_frame_reads_the_counter_over_the_stacked_frames(counts):
    read = harness.reader("interp_ops_per_frame.seq").read
    counts(41 * 96, 0, 96)
    assert read(Record(loop="sequence")) == pytest.approx(41.0)
    counts(41 * 96, 32, 64)
    assert read(Record(loop="sequence")) == pytest.approx(41.0)
    assert read(Record(loop="live")) is None
    counts(0, 0, 96)  # no shader through the interpreter
    assert read(Record(loop="sequence")) is None
    counts(0, 0, 0)
    assert read(Record(loop="sequence")) is None


def _trace(host_extra=()):
    """Two frames in a 10 ms window; crt's runs 1-3 and 6-8.5 ms, a nested
    and an overlapping range inside the second, one outside the window."""
    ms = 1e-3
    host = [(-1.0, 1.0, "perfbench.window"), (0.5 * ms, 4 * ms, "rf.node"),
            (1 * ms, 3 * ms, "rf.glsl"), (6 * ms, 8 * ms, "rf.glsl"),
            (7 * ms, 8.5 * ms, "rf.glsl"), (6.5 * ms, 7 * ms, "rf.glsl"),
            (12 * ms, 13 * ms, "rf.glsl"), *host_extra]
    return Trace(window=(0.0, 10 * ms), frames=2, device=[(0.0, 9 * ms, "k")], host=host)


def test_host_ms_unions_the_glsl_ranges_of_the_window():
    read = harness.reader("interp_host_ms.seq").read
    assert read(Record(loop="sequence", trace=_trace())) == pytest.approx((2.0 + 2.5) / 2)
    assert read(Record(loop="live", trace=_trace())) is None
    assert read(Record(loop="sequence")) is None
    bare = _trace()
    bare.host = [h for h in bare.host if h[2] != "rf.glsl"]
    assert read(Record(loop="sequence", trace=bare)) is None
