"""File-change watcher: native inotify fast path, mtime polling fallback
(the port's copy of ``reforge_tpu/runtime/watcher.py``).

The engine polls the config and every file-backed kernel each frame
(reference behaviour, src/render.rs:497-519).  With the native watcher
(``native/watcher.cpp``) the per-frame cost is one non-blocking ``read`` on
an inotify fd; the engine's mtime comparison, which stays the authority,
runs only when the watcher reports directory activity.  The library is
built with ``g++`` at first use into ``build/reforge_tpu_torch/`` of the
checkout (beside the CUDA kernels).  Where it cannot be built or loaded
(no compiler, not Linux), one warning says so and ``poll`` returns True
every frame: pure polling.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Iterable, Optional

from ..utils import warnln
from .native import BUILD_DIR, REPO_DIR, NativeBuildError, build_library

SOURCE = REPO_DIR / "native" / "watcher.cpp"
LIB_PATH = BUILD_DIR / "libreforge_watch.so"

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lock = threading.Lock()


def _build() -> Optional[Path]:
    """Compile native/watcher.cpp unless a library newer than it exists;
    None (and one warning) when that cannot be done."""
    if not SOURCE.exists():
        warnln("File watcher: no native/watcher.cpp; live reload polls file mtimes every frame")
        return None
    try:
        return build_library(SOURCE, LIB_PATH)
    except NativeBuildError as e:
        warnln(f"File watcher: {e}; live reload polls file mtimes every frame")
        return None


def _native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            warnln(f"File watcher: cannot load {path}: {e}; live reload polls file mtimes")
            return None
        lib.rf_watch_create.restype = ctypes.c_int
        lib.rf_watch_add_dir.restype = ctypes.c_int
        lib.rf_watch_add_dir.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.rf_watch_poll.restype = ctypes.c_int
        lib.rf_watch_poll.argtypes = [ctypes.c_int]
        lib.rf_watch_close.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


class FileWatcher:
    """Watches the parent directories of a set of files (an editor's
    save-by-rename replaces the file, not the directory)."""

    def __init__(self, paths: Iterable[str]):
        self._fd = -1
        lib = _native()
        if lib is None:
            return
        dirs = sorted({os.path.dirname(os.path.abspath(p)) or "." for p in paths})
        fd = lib.rf_watch_create()
        if fd < 0:
            return
        added = [lib.rf_watch_add_dir(fd, d.encode()) >= 0 for d in dirs]  # every one
        if not any(added):
            lib.rf_watch_close(fd)
            return
        self._fd = fd

    @property
    def active(self) -> bool:
        return self._fd >= 0

    def poll(self) -> bool:
        """True when a watched directory saw activity (or there is no
        native watcher: the caller then compares mtimes)."""
        if self._fd < 0:
            return True
        rc = _native().rf_watch_poll(self._fd)
        if rc < 0:
            return True  # the watcher broke: poll mtimes
        return rc == 1

    def close(self) -> None:
        if self._fd >= 0:
            _native().rf_watch_close(self._fd)
            self._fd = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
