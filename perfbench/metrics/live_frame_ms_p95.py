"""live_frame_ms_p95: the nearest-rank 95th percentile of every live-loop
iteration's duration in the window (one iteration's start to the next's),
in ms."""

from perfbench import stats


def read(rec):
    if rec.loop != "live" or not rec.frame_s:
        return None
    return stats.percentile(rec.frame_s, 95) * 1e3
