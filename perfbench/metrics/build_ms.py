"""build_ms: the host span of Engine(...): parse, kernel files (GLSL
translation and reflection), graph build, shape check, planning (the
affine probe and the op lists' lowering), in ms."""


def read(rec):
    span = rec.spans.get("build")
    return span[0] * 1e3 if span else None
