"""frame_roofline: a frame's least time over its device time, in %.

The least time is the larger of the graph's least bytes over the card's
memory bandwidth and its least f32 operations over the card's f32 rate
(configs/<config>/work.py, peaks.json); the device time is the union of
the device's operations in the traced window over its frames, copies
included."""


def read(rec):
    t, work, peak = rec.trace, rec.work, rec.peak
    if rec.loop != "sequence" or t is None or not work or not peak or t.busy_s <= 0:
        return None
    least = max(work["bytes"] / peak["hbm_bytes_per_s"], work["flops"] / peak["f32_flops_per_s"])
    return 100.0 * least / (t.busy_s / t.frames)
