"""live_fps: every live-loop iteration of the window, over the window (its
start to the end of its last iteration)."""

from perfbench import stats


def read(rec):
    return stats.rate(rec.frames, rec.window_s) if rec.loop == "live" else None
