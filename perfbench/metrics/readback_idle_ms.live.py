"""readback_idle_ms.live: the device's idle time in the traced window that
falls inside the program's ``rf.preview.readback`` ranges (the copy of the
preview to the host in Engine.read_output), over the window's frames, in
ms."""

from perfbench import program_spans


def read(rec):
    return program_spans.idle_ms_per_frame(rec, ("preview.readback",))
