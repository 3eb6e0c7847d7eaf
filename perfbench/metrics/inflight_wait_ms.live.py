"""inflight_wait_ms.live: the mean duration of the program's
``rf.render.inflight_wait`` ranges in the traced window (the engine's wait
on its oldest frame in flight), in ms."""

from perfbench import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "render.inflight_wait")
