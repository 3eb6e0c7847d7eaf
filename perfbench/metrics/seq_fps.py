"""seq_fps: every frame of the chunks enqueued in the window, over the time
from the window's start to the synchronize after its last chunk."""

from perfbench import stats


def read(rec):
    return stats.rate(rec.frames, rec.window_s) if rec.loop == "sequence" else None
