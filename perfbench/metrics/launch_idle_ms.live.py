"""launch_idle_ms.live: the device's idle time in the traced window that
falls inside the program's ``rf.poll`` and ``rf.render`` ranges
(Engine.trigger_reloads, and Engine.render_frame up to the frame's
launches), each idle instant once, over the window's frames, in ms."""

from perfbench import program_spans


def read(rec):
    return program_spans.idle_ms_per_frame(rec, ("poll", "render"))
