"""The port's spans (``reforge_tpu_torch/trace.py``) on the CPU: none on the
frame path without a profiler, their nesting and request numbers under
``torch.profiler``, one child a step of a segments plan, the build records
(phases, ``nodes_checked``, ``from_cache``, the build thread) and the
``--profile`` trace."""

import glob
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from reforge_tpu_torch import trace, utils
from reforge_tpu_torch.cli import main
from reforge_tpu_torch.graph import program

from test_torch_cli import _image
from test_torch_reload import FIVE_NODES, bump, make_engine
from test_torch_segments import BLOCKER_MID

FLAGSHIPISH = ("input -> soft -> tone -> vig -> output\n"
               "soft: gaussian { sigma: 2.0 }\ntone: tonemap {}\nvig: vignette {}\n")


@pytest.fixture(autouse=True)
def _quiet_and_cold(monkeypatch):
    """No warnings, empty program caches and span stores."""
    utils.print_warnings = False
    monkeypatch.setattr(program, "_PROGRAMS", {})
    monkeypatch.setattr(program, "_NODE_CHECKS", {})
    trace.SPANS.clear()
    trace.BUILDS.clear()
    yield


def live_step(eng):
    """One iteration of the live loop: poll, render, a downsampled preview."""
    eng.trigger_reloads()
    out = eng.render_frame(0.0)
    return eng.read_output_scaled(out, 12)


def spans_named(name):
    return [s for s in trace.SPANS if s.name == name]


def inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_no_profiler_no_frame_spans_and_no_record_function(tmp_path, monkeypatch):
    eng, _ = make_engine(tmp_path, FLAGSHIPISH)
    calls = []
    real = torch.profiler.record_function

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    for _ in range(3):
        live_step(eng)
    eng.program.render_sequence(eng._file_input(), 0.0, 0.1, 3, stack=True)
    eng.read_output(eng.render_frame_blocking(0.0))
    assert calls == [] and len(trace.SPANS) == 0
    eng.close()


def test_live_step_spans_nest_and_share_the_frame(tmp_path):
    eng, _ = make_engine(tmp_path, FLAGSHIPISH)
    live_step(eng)  # frame 0, untraced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        live_step(eng)
    names = [s.name for s in trace.SPANS]
    assert names == ["poll", "render", "render.dispatch", "forward", "preview",
                     "preview.downsample", "preview.encode", "preview.readback"]
    (poll,), (render,), (dispatch,), (forward,) = (
        spans_named(n) for n in ("poll", "render", "render.dispatch", "forward"))
    (preview,), (down,), (enc,), (read,) = (
        spans_named(n) for n in ("preview", "preview.downsample", "preview.encode",
                                 "preview.readback"))
    assert poll.parent is None and poll.attrs == {"swapped": False}
    assert dispatch.parent is render and forward.parent is dispatch
    assert inside(dispatch, render) and inside(forward, dispatch)
    assert dispatch.attrs["tier"] == forward.attrs["tier"] == eng.program.tier == "single"
    for child in (down, enc, read):
        assert child.parent is preview and inside(child, preview)
    assert preview.attrs["step"] == 2 and read.attrs["bytes"] == 8 * 12 * 4
    assert down.end_ns <= enc.start_ns and enc.end_ns <= read.start_ns
    assert {s.request for s in trace.SPANS} == {1}
    assert all(s.thread == "MainThread" for s in trace.SPANS)
    on_trace = {ev.name for ev in prof.events()}
    assert {trace.PREFIX + n for n in names} <= on_trace
    eng.close()


def test_a_segments_plan_gives_one_child_a_step(tmp_path):
    eng, _ = make_engine(tmp_path, BLOCKER_MID, w=64, h=32)
    steps = eng.program._strip_plan[1]
    assert eng.program.tier == "segments"
    with profile(activities=[ProfilerActivity.CPU]):
        eng.render_frame_blocking(0.0)
    (forward,) = spans_named("forward")
    children = [s for s in trace.SPANS if s.parent is forward]
    assert [s.name for s in children] == ["segment" if st[0] == "seg" else "node"
                                          for st in steps]
    assert [s.attrs.get("node") for s in children if s.name == "node"] == ["px"]
    assert all(inside(s, forward) for s in children)
    eng.close()


# A segments plan whose final output comes from a per-node step.
ENDS_IN_A_NODE = "input -> edge -> px -> output\nedge: sobel {}\npx: pixelate { size: 4 }\n"


@pytest.mark.parametrize("config, tier", [(FLAGSHIPISH, "single"), (ENDS_IN_A_NODE, "segments")])
def test_render_sequence_spans(tmp_path, config, tier):
    """A strip tier writes each frame in its slice of the stack: n forwards
    and no ``sequence.stack``; a tier ending in a node copies each frame
    there after its forward, inside ``sequence.stack``."""
    eng, _ = make_engine(tmp_path, config)
    assert eng.program.tier == tier
    with profile(activities=[ProfilerActivity.CPU]):
        eng.program.render_sequence(eng._file_input(), 0.0, 0.1, 3, stack=True)
    (seq,), stacks = spans_named("sequence"), spans_named("sequence.stack")
    forwards = spans_named("forward")
    assert seq.attrs == {"n": 3} and len(forwards) == 3
    assert all(f.parent is seq and inside(f, seq) for f in forwards + stacks)
    if tier == "single":
        assert stacks == []
    else:
        assert len(stacks) == 3
        assert all(f.end_ns <= s.start_ns for f, s in zip(forwards, stacks))
    eng.close()


def test_the_engines_build_record_holds_its_phases(tmp_path):
    eng, _ = make_engine(tmp_path, FLAGSHIPISH)
    (record,) = trace.BUILDS
    root = record.spans[0]
    assert root.name == "build" and root.parent is None and root.attrs == {"async": False}
    phases = [record.first(n) for n in ("build.config", "build.graph", "build.check",
                                         "build.plan")]
    assert all(p is not None and p.parent is root and inside(p, root) for p in phases)
    assert sum(p.ms for p in phases) <= root.ms
    assert record.first("build.graph").attrs == {"nodes": 3}
    assert record.first("build.plan").attrs == {"tier": "single"}
    assert {s.request for s in record.spans} == {record.number}
    eng.close()


def test_build_check_records_the_cache(tmp_path):
    """A cold build checks every node; a second engine of the same graph
    takes the cached program; a one-node edit checks that node."""
    a, b = FIVE_NODES % "1.0", FIVE_NODES % "1.5"
    (tmp_path / "one").mkdir()
    (tmp_path / "two").mkdir()
    first, _ = make_engine(tmp_path / "one", a)
    second, cfg = make_engine(tmp_path / "two", a)
    checks = [r.first("build.check").attrs for r in trace.BUILDS]
    assert checks == [{"nodes_checked": 5, "from_cache": False},
                      {"nodes_checked": 0, "from_cache": True}]
    assert trace.BUILDS[1].first("build.plan") is None  # the plan came with the program
    bump(cfg, b)
    assert second.trigger_reloads() is True
    parse, rebuild = list(trace.BUILDS)[2:]
    assert [s.name for s in parse.spans] == ["build.config"]
    assert rebuild.spans[0].name == "build"
    assert rebuild.first("build.check").attrs == {"nodes_checked": 1, "from_cache": False}
    first.close()
    second.close()


def test_an_async_rebuilds_spans_are_on_the_build_thread(tmp_path):
    eng, cfg = make_engine(tmp_path, "input -> invert -> output", async_compile=True)
    bump(cfg, "input -> passthrough -> output")
    eng.trigger_reloads()
    eng.wait_for_compiles()
    (record,) = [r for r in trace.BUILDS if r.spans[0].attrs.get("async")]
    root = record.spans[0]
    assert root.name == "build" and root.parent is None
    assert {s.thread for s in record.spans} == {"rf-build"}
    assert all(s.parent in record.spans for s in record.spans[1:])
    assert {s.name for s in record.spans} >= {"build", "build.graph", "build.check",
                                              "build.plan"}
    assert all(inside(s, root) for s in record.spans)
    eng.close()


def test_the_records_are_bounded(tmp_path):
    eng, cfg = make_engine(tmp_path, "input -> invert -> output")
    for i in range(trace.BUILDS_KEPT + 2):
        bump(cfg, "input -> passthrough -> output" if i % 2 else "input -> invert -> output")
        eng.trigger_reloads()
    assert len(trace.BUILDS) == trace.BUILDS_KEPT
    numbers = [r.number for r in trace.BUILDS]
    assert numbers == sorted(numbers) and len(set(numbers)) == len(numbers)
    eng.close()


def test_profile_trace_names_the_frame_spans(tmp_path):
    _image(tmp_path / "in.png", 16, 20, seed=54)
    tdir = tmp_path / "trace"
    assert main(["-i", str(tmp_path / "in.png"), "--profile", str(tdir), "--backend", "cpu",
                 "--preview", "kitty", "--frames", "2"]) == 0
    (path,) = glob.glob(str(tdir / "*.json"))
    with open(path) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"rf.poll", "rf.render", "rf.render.dispatch", "rf.forward", "rf.preview",
            "rf.preview.readback"} <= names


def test_the_gpu_readout_on_the_cpu_is_the_host_time(tmp_path):
    eng, _ = make_engine(tmp_path, FLAGSHIPISH)
    eng.render_frame(0.0)
    (ms,) = eng.last_gpu_times.values()
    assert set(eng.last_gpu_times) == {"graph"} and 0.0 < ms < 60_000.0
    assert eng.frames_rendered == 1 and np.isfinite(ms)
    eng.close()
