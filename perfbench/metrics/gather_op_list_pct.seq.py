"""gather_op_list_pct.seq: of the runs on a frame of GLSL nodes that read
images at computed points (halo None, storage-buffer, atomic and
``shared`` shaders left out), the share that ran as a stage of a
graph_strip_mc launch, their op list, and not in the interpreter per node
(graph.program.GLSL_GATHER_RUNS, over the whole run), in %.  None where
the program keeps no such count or counted no run."""


def read(rec):
    if rec.loop != "sequence":
        return None
    from reforge_tpu_torch.graph import program

    runs = getattr(program, "GLSL_GATHER_RUNS", None)
    total = sum(runs.values()) if runs else 0
    if total == 0:
        return None
    return 100.0 * runs["op_list"] / total
