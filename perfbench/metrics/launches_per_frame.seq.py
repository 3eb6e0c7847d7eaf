"""launches_per_frame.seq: the program's kernel launches in the window
(cuda_ops.LAUNCHES, zeroed before it), over its frames."""


def read(rec):
    total = sum(rec.launches.values())
    if rec.loop != "sequence" or total == 0 or rec.frames == 0:
        return None
    return total / rec.frames
