"""build_check_ms: the engine's first ``build.check`` span (make_program: the
program cache's lookup and the shape check on ``meta`` tensors), from the
program's build records, in ms."""

from perfbench import program_spans


def read(rec):
    return program_spans.build_phase_ms("build.check")
