"""device_idle_pct.live: the share of the traced window in which no device
operation ran, in %."""


def read(rec):
    t = rec.trace
    if rec.loop != "live" or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
