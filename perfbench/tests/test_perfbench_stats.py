"""The arithmetic from readings to numbers: rates, the nearest-rank p95,
and the union of device intervals and its gaps."""

import pytest

from perfbench import stats
from perfbench.devtrace import Trace
from perfbench.harness import Record


def _live(frame_s):
    return Record(loop="live", frames=len(frame_s), window_s=sum(frame_s), frame_s=frame_s)


def test_rate_and_p95():
    assert stats.rate(1500, 1.5) == 1000.0
    values = [float(i) for i in range(1, 101)]
    assert stats.percentile(values, 95) == 95.0
    assert stats.percentile(values, 100) == 100.0
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_a_stall_moves_the_p95_and_the_rate():
    from perfbench import harness

    fps, p95 = harness.reader("live_fps"), harness.reader("live_frame_ms_p95")
    steady = _live([0.001] * 1000)
    assert fps.read(steady) == pytest.approx(1000.0)
    assert p95.read(steady) == pytest.approx(1.0)
    # 6% of the frames stall at 5 ms: past the 95th percentile.
    stalled = _live([0.001] * 940 + [0.005] * 60)
    assert p95.read(stalled) == pytest.approx(5.0)
    assert fps.read(stalled) == pytest.approx(1000 / (0.94 + 0.30))
    # 4% do not reach it, and still slow the rate.
    few = _live([0.001] * 960 + [0.005] * 40)
    assert p95.read(few) == pytest.approx(1.0)
    assert fps.read(few) < fps.read(steady)


def test_union_counts_overlaps_once_and_clips_to_the_window():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.2, 2.4), (4.0, 6.0)]
    assert stats.union_length(iv, 0.0, 10.0) == pytest.approx(4.5)
    assert stats.union_length(iv, 1.0, 5.0) == pytest.approx(0.5 + 1.0 + 1.0)
    assert stats.gaps(iv, 0.0, 7.0) == [(1.5, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_trace_busy_idle_and_breakdown():
    dev = [(0.0, 0.4, "k"), (0.3, 0.6, "copy"), (0.8, 0.9, "k")]
    host = [(-1.0, 2.0, "perfbench.window"), (0.55, 0.85, "perfbench.preview"),
            (0.61, 0.62, "aten::copy_")]
    t = Trace(window=(0.0, 1.0), frames=2, device=dev, host=host)
    assert t.busy_s == pytest.approx(0.7)
    assert t.window_s == 1.0
    ops = dict(t.device_ops())
    assert ops["k"] == pytest.approx(0.5) and ops["copy"] == pytest.approx(0.3)
    gaps = dict(t.idle_gaps())
    assert gaps["perfbench.preview"] == pytest.approx(0.2)   # 0.6 .. 0.8
    assert gaps["host: no range open"] == pytest.approx(0.1)  # 0.9 .. 1.0
    from perfbench import harness

    rec = Record(loop="sequence", frames=2, window_s=1.0, trace=t,
                 work={"bytes": 3.35e9 * 0.07, "flops": 0}, peak={"hbm_bytes_per_s": 3.35e9,
                                                             "f32_flops_per_s": 1e12})
    assert harness.reader("device_idle_pct.seq").read(rec) == pytest.approx(30.0)
    assert harness.reader("kernel_ms_per_frame.seq").read(rec) == pytest.approx(350.0)
    assert harness.reader("frame_roofline").read(rec) == pytest.approx(20.0)
    assert harness.reader("device_idle_pct.live").read(rec) is None
    assert harness.reader("launches_per_frame.seq").read(rec) is None  # nothing counted
