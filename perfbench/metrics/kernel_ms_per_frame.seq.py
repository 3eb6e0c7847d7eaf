"""kernel_ms_per_frame.seq: the union of the device's operations in the
traced window, over the frames it rendered, in ms."""


def read(rec):
    t = rec.trace
    if rec.loop != "sequence" or t is None or t.frames == 0 or t.busy_s <= 0:
        return None
    return t.busy_s / t.frames * 1e3
