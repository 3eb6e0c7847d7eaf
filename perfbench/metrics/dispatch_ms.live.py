"""dispatch_ms.live: the mean duration of the program's
``rf.render.dispatch`` ranges in the traced window (the program's call:
GraphProgram._forward and the kernels' host wrappers), in ms."""

from perfbench import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "render.dispatch")
