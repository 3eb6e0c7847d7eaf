"""interp_host_ms.seq: the host time inside the program's ``rf.glsl``
ranges of the traced window (translate_shader's run: the GLSL
interpreter's run of a shader on a frame), each instant once, over the
window's frames, in ms."""

from perfbench import program_spans


def read(rec):
    t = rec.trace
    if rec.loop != "sequence" or t is None or t.frames == 0:
        return None
    inside = program_spans.union(program_spans.ranges(t, "glsl"))
    if not inside:
        return None
    return sum(e - s for s, e in inside) / t.frames * 1e3
