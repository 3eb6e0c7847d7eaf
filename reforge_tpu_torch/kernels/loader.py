"""Kernel resolution (the port of ``reforge_tpu/kernels/loader.py``).

A node's kernel comes from a source file in the shader path when one
exists, else from the builtin registry.  ``.comp``, ``.frag`` and
``.glsl`` files go through the GLSL compiler (``glsl.translate_shader``);
a shader it cannot run (a syntax error, or a storage buffer, atomic or
``shared`` array, which are not ported yet) warns and gives no spec, so the
graph build fails and the engine keeps its last good program.  A ``.py``
kernel file is JAX code in the reference and gets a "not ported"
diagnostic the same way.
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils import warnln
from .base import KernelSpec, lookup_builtin

# Loaded specs keyed by path, valid while the source text is unchanged: an
# unchanged shader keeps its spec, so its reflection and conv synthesis
# are not redone on a rebuild.
_spec_cache: dict[str, tuple[str, KernelSpec]] = {}


def load_kernel_file(path: str) -> Optional[KernelSpec]:
    ext = os.path.splitext(path)[1]
    if ext == ".py":
        warnln(
            f"Kernel file {path}: .py kernels are not ported to the PyTorch engine yet "
            f"(GLSL and builtin kernels only); remove it from the shader path to use the "
            f"builtin of that name"
        )
        return None
    if ext not in (".comp", ".frag", ".glsl"):
        warnln(f"Unknown kernel source extension '{ext}' for {path}")
        return None
    try:
        with open(path, "r") as f:
            source = f.read()
    except OSError as e:
        warnln(f"Unable to read kernel file {path}: {e}")
        return None
    cached = _spec_cache.get(path)
    if cached is not None and cached[0] == source:
        return cached[1]
    from ..glsl import GlslError, translate_shader  # glsl imports this package: here, not above

    stem = os.path.splitext(os.path.basename(path))[0]
    try:
        spec = translate_shader(source, name=stem, path=path)
    except GlslError as e:
        warnln(f"Error compiling GLSL kernel {path}:\n{e}")
        return None
    _spec_cache[path] = (source, spec)
    return spec


def resolve_kernel(pipeline_type: str, file_path: str) -> Optional[KernelSpec]:
    """Resolve a node's kernel: source file if present, else builtin registry."""
    if file_path:
        return load_kernel_file(file_path)
    spec = lookup_builtin(pipeline_type)
    if spec is None:
        warnln(
            f"No kernel source found for pipeline type '{pipeline_type}' "
            f"(no .comp/.py file in the shader path, not a builtin kernel)"
        )
    return spec
