"""interp_ops_per_frame.seq: the GLSL interpreter's operations on per-pixel
values (glsl/interp.COUNTS["ops"]) over the stacked frames rendered
(graph.program.SEQUENCE_FRAMES), both counted over the whole run (warm-up
and windows), in operations a frame.  None where the program keeps no
such count or ran no shader through the interpreter."""


def read(rec):
    if rec.loop != "sequence":
        return None
    from reforge_tpu_torch.glsl import interp
    from reforge_tpu_torch.graph import program

    counts = getattr(interp, "COUNTS", None)
    frames = getattr(program, "SEQUENCE_FRAMES", None)
    ops = counts.get("ops", 0) if counts else 0
    total = sum(frames.values()) if frames else 0
    if ops == 0 or total == 0:
        return None
    return ops / total
