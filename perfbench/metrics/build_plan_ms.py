"""build_plan_ms: the engine's first ``build.plan`` span (the strip plan's
first evaluation: the affine probe, the op lists' lowering, the strip
program), from the program's build records, in ms."""

from perfbench import program_spans


def read(rec):
    return program_spans.build_phase_ms("build.plan")
