"""Kernel resolution (the port of ``reforge_tpu/kernels/loader.py``).

A node's kernel comes from a source file in the shader path when one
exists, else from the builtin registry.  Two source kinds:

  * ``.py`` -- executed as a module.  The file imports ``kernel`` (and
    ``KernelContext``, ``KernelSpec``) from ``reforge_tpu_torch.kernels``
    and defines kernels with ``@kernel`` or as bare ``KernelSpec`` values;
    the spec whose name matches the file stem wins, else the first.  A
    kernel body receives f32 ``(4, H, W)`` tensors (buffers as 1-D f32) on
    ``ctx.device`` and returns a tensor or a dict of them.
  * ``.comp``, ``.frag`` and ``.glsl`` -- the GLSL compiler
    (``glsl.translate_shader``).

A file that does not load (an exception in the module, a shader the
compiler rejects) warns and gives no spec, so the graph build fails and the
engine keeps its last good program.
"""

from __future__ import annotations

import os
import traceback
from typing import Optional

from ..utils import remember, warnln
from .base import KernelSpec, lookup_builtin

# Loaded specs keyed by (path, source text): an unchanged file keeps its
# spec, so its reflection and conv synthesis are not redone on a rebuild,
# and an edit back to a text this process has loaded (A -> B -> A) gets
# that text's spec again, which is what lets graph/program.py's caches hit.
# Bounded: past the limit the oldest half goes (``utils.remember``).
_spec_cache: dict[tuple[str, str], KernelSpec] = {}
_SPEC_CACHE_MAX = 128


def load_kernel_file(path: str) -> Optional[KernelSpec]:
    ext = os.path.splitext(path)[1]
    if ext not in (".py", ".comp", ".frag", ".glsl"):
        warnln(f"Unknown kernel source extension '{ext}' for {path}")
        return None
    try:
        with open(path, "r") as f:
            source = f.read()
    except OSError as e:
        warnln(f"Unable to read kernel file {path}: {e}")
        return None
    cached = _spec_cache.get((path, source))
    if cached is not None:
        return cached
    spec = _load_py_kernel(path, source) if ext == ".py" else _load_glsl_kernel(path, source)
    if spec is None:
        return None
    remember(_spec_cache, _SPEC_CACHE_MAX, (path, source), spec)
    return spec


def _load_py_kernel(path: str, source: str) -> Optional[KernelSpec]:
    stem = os.path.splitext(os.path.basename(path))[0]
    namespace: dict = {"__file__": path, "__name__": f"rf_kernel_{stem}"}
    try:
        exec(compile(source, path, "exec"), namespace)
    except Exception:  # any fault in the user's module: keep last good
        warnln(f"Error loading kernel module {path}:\n{traceback.format_exc()}")
        return None
    specs = [v for v in namespace.values() if isinstance(v, KernelSpec)]
    if not specs:
        warnln(f"Kernel module {path} defines no KernelSpec (use @kernel)")
        return None
    spec = next((s for s in specs if s.name == stem), specs[0])
    spec.source_path = path
    return spec


def _load_glsl_kernel(path: str, source: str) -> Optional[KernelSpec]:
    from ..glsl import GlslError, translate_shader  # glsl imports this package: here, not above

    stem = os.path.splitext(os.path.basename(path))[0]
    try:
        return translate_shader(source, name=stem, path=path)
    except GlslError as e:
        warnln(f"Error compiling GLSL kernel {path}:\n{e}")
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
