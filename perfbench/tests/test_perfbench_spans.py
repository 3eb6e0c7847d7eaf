"""The readers of the program's spans on hand-placed traces: an idle gap
that straddles ``rf.preview.readback`` and ``rf.poll`` is split between the
two ``_idle_`` metrics and counted once; each reader reads None for the
wrong loop or with no spans."""

import pytest

from perfbench import harness, program_spans
from perfbench.devtrace import Trace
from perfbench.harness import Record

SPAN_READERS = ("readback_idle_ms.live", "launch_idle_ms.live", "dispatch_ms.live",
                "inflight_wait_ms.live")


def _frames(host_extra=()):
    """Two frames in a 10 ms window.  Device: the kernel 0-3 and 5-8 ms, a
    copy 3.5-4 ms.  Host: frame 0's readback 3-4.5, frame 1's poll 4.5-4.8
    and render 4.8-5.2 (dispatch 4.8-5.1, its launch lands at 5), a readback
    8-9.5 and the next poll 9.5-10."""
    ms = 1e-3
    device = [(0.0, 3 * ms, "graph_strip"), (3.5 * ms, 4 * ms, "Memcpy DtoH"),
              (5 * ms, 8 * ms, "graph_strip")]
    host = [(-1.0, 1.0, "perfbench.window"),
            (3 * ms, 4.5 * ms, "rf.preview.readback"), (3.1 * ms, 3.2 * ms, "aten::copy_"),
            (4.5 * ms, 4.8 * ms, "rf.poll"),
            (4.8 * ms, 5.2 * ms, "rf.render"), (4.8 * ms, 5.1 * ms, "rf.render.dispatch"),
            (5.1 * ms, 5.2 * ms, "rf.render.inflight_wait"),
            (8 * ms, 9.5 * ms, "rf.preview.readback"), (9.5 * ms, 10 * ms, "rf.poll"),
            *host_extra]
    return Trace(window=(0.0, 10 * ms), frames=2, device=device, host=host)


def _read(name, rec):
    return harness.reader(name).read(rec)


def test_a_gap_across_readback_and_poll_is_split_and_counted_once():
    rec = Record(loop="live", trace=_frames())
    # Idle: 3-3.5 and 4-5 ms (the gap from the copy to the next launch), 8-10 ms.
    readback = _read("readback_idle_ms.live", rec)
    launch = _read("launch_idle_ms.live", rec)
    assert readback == pytest.approx((0.5 + 0.5 + 1.5) / 2)  # 3-3.5, 4-4.5, 8-9.5
    assert launch == pytest.approx((0.3 + 0.2 + 0.5) / 2)    # 4.5-4.8, 4.8-5, 9.5-10
    idle_ms = (1 - rec.trace.busy_s / rec.trace.window_s) * rec.trace.window_s * 1e3 / 2
    assert readback + launch == pytest.approx(idle_ms)


def test_nested_and_overlapping_ranges_count_an_idle_instant_once():
    ms = 1e-3
    # A second rf.render over the same stretch, and a range of a render
    # nested in a poll: the union covers each idle instant once.
    rec = Record(loop="live", trace=_frames(host_extra=[
        (4.6 * ms, 5.0 * ms, "rf.render"), (9.6 * ms, 9.7 * ms, "rf.render")]))
    assert _read("launch_idle_ms.live", rec) == pytest.approx((0.3 + 0.2 + 0.5) / 2)


def test_span_durations():
    rec = Record(loop="live", trace=_frames())
    assert _read("dispatch_ms.live", rec) == pytest.approx(0.3)
    assert _read("inflight_wait_ms.live", rec) == pytest.approx(0.1)


def test_ranges_outside_the_window_are_left_out():
    t = _frames(host_extra=[(20e-3, 30e-3, "rf.render.dispatch")])
    (found,) = program_spans.ranges(t, "render.dispatch")
    assert found == pytest.approx((4.8e-3, 5.1e-3))


@pytest.mark.parametrize("name", SPAN_READERS)
def test_none_for_the_wrong_loop_no_trace_or_no_spans(name):
    assert _read(name, Record(loop="sequence", trace=_frames())) is None
    assert _read(name, Record(loop="live")) is None
    bare = _frames()
    bare.host = [h for h in bare.host if not h[2].startswith("rf.")]
    assert _read(name, Record(loop="live", trace=bare)) is None


def test_interval_arithmetic():
    assert program_spans.union([(2, 3), (0, 1), (0.5, 1.5), (3, 4)]) == [(0, 1.5), (2, 4)]
    assert program_spans.overlap([(0, 2), (3, 5)], [(1, 4)]) == pytest.approx(2.0)
    assert program_spans.overlap([], [(0, 1)]) == 0.0


@pytest.fixture
def builds(monkeypatch):
    trace = pytest.importorskip("reforge_tpu_torch.trace")
    monkeypatch.setattr(trace, "BUILDS", type(trace.BUILDS)(maxlen=trace.BUILDS_KEPT))
    return trace


def _record(trace, number, spans):
    record = trace.Build(number)
    for name, ms in spans:
        record.spans.append(trace.Span(name, 0, None, number, {}, "MainThread",
                                       end_ns=int(ms * 1e6)))
    trace.BUILDS.append(record)


def test_build_readers_take_the_engines_first_build(builds):
    rec = Record(loop="sequence")
    assert _read("build_check_ms", rec) is None and _read("build_plan_ms", rec) is None
    _record(builds, 1, [("build.library", 5.0)])  # the library's load, before the engine
    _record(builds, 2, [("build", 100.0), ("build.check", 60.0), ("build.plan", 20.0),
                        ("build.plan", 5.0)])
    _record(builds, 3, [("build", 50.0), ("build.check", 1.0), ("build.plan", 1.0)])
    assert _read("build_check_ms", rec) == pytest.approx(60.0)
    assert _read("build_plan_ms", rec) == pytest.approx(20.0)


def test_build_readers_read_none_without_the_phase(builds):
    _record(builds, 1, [("build", 100.0), ("build.check", 60.0)])
    assert _read("build_plan_ms", Record(loop="live")) is None
