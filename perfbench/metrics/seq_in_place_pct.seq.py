"""seq_in_place_pct.seq: the share of the stacked sequence frames that
their strip kernel wrote in place, in their slice of the chunk's output,
against those copied there (graph.program.SEQUENCE_FRAMES: every chunk of
the run, warm-up and windows), in %.  None where the program keeps no such
count."""


def read(rec):
    if rec.loop != "sequence":
        return None
    from reforge_tpu_torch.graph import program

    frames = getattr(program, "SEQUENCE_FRAMES", None)
    total = sum(frames.values()) if frames else 0
    if total == 0:
        return None
    return 100.0 * frames["in_place"] / total
