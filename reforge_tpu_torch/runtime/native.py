"""Host libraries built from C++ sources of the checkout with ``g++`` at
first use, into ``build/reforge_tpu_torch/`` beside the CUDA kernels (the
path comes from the package file, not the working directory)."""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

REPO_DIR = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_DIR / "build" / "reforge_tpu_torch"


class NativeBuildError(Exception):
    """A host library could not be compiled; the message holds why."""


def build_library(source: Path, target: Path, cflags: Sequence[str] = (),
                  libs: Sequence[str] = ()) -> Path:
    """Compile ``source`` into the shared library ``target`` unless a
    library newer than the source is there.  Concurrent builders (threads,
    test workers) each compile to a file of their own and rename it into
    place, so a reader never sees a partial library."""
    if target.exists() and target.stat().st_mtime_ns >= source.stat().st_mtime_ns:
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(f"building {source.name}: no g++ on the PATH")
    target.parent.mkdir(parents=True, exist_ok=True)
    partial = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [cxx, "-O2", "-fPIC", "-std=c++17", "-shared", *cflags, str(source), "-o", str(partial),
         *libs],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise NativeBuildError(f"building {source.name} failed:\n{proc.stderr.strip()}")
    os.replace(partial, target)
    return target
