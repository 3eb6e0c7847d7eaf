"""Kernel resolution (the port of ``reforge_tpu/kernels/loader.py``).

Builtins only, for now.  A node whose kernel comes from a ``.comp``,
``.frag``, ``.glsl`` or ``.py`` file in the shader path gets a "not ported
yet" diagnostic and no spec, so the graph build fails and the engine keeps
its last good program, exactly as for a kernel file that does not compile.
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils import warnln
from .base import KernelSpec, lookup_builtin


def load_kernel_file(path: str) -> Optional[KernelSpec]:
    ext = os.path.splitext(path)[1]
    if ext in (".comp", ".frag", ".glsl", ".py"):
        warnln(
            f"Kernel file {path}: {ext} kernels are not ported to the PyTorch "
            f"engine yet (builtin kernels only); remove it from the shader "
            f"path to use the builtin of that name"
        )
    else:
        warnln(f"Unknown kernel source extension '{ext}' for {path}")
    return None


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
