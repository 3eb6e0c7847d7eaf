"""setup_s: process start to the window's start (the torch import, the CUDA
context, the kernels' library, the engine's build, the input and the
warm-up)."""


def read(rec):
    return rec.setup_s
