"""Terminal coloring, warnings and file mtimes (the subset of
``reforge_tpu.utils`` the port uses, with the same behaviour).

``warnln`` prints a yellow warning to stderr after clearing the in-place
status line, and records it so tests and keep-last-good paths can assert
on diagnostics without capturing stderr (reference: src/utils.rs:13-18).
"""

from __future__ import annotations

import collections
import os
import sys
from typing import Deque

TERM_RED = "\x1b[31m"
TERM_YELLOW = "\x1b[33m"
TERM_RESET = "\x1b[0m"
TERM_CLEAR = "\r\x1b[2K"

_recent_warnings: Deque[str] = collections.deque(maxlen=256)

# When False (e.g. under pytest), suppress stderr output but still record.
print_warnings = True


def warnln(msg: str) -> None:
    """Print a yellow warning line to stderr, clearing the status line first."""
    _recent_warnings.append(msg)
    if print_warnings:
        sys.stderr.write(f"{TERM_CLEAR}{TERM_YELLOW}{msg}{TERM_RESET}\n")
        sys.stderr.flush()


def recent_warnings() -> list[str]:
    return list(_recent_warnings)


def clear_warnings() -> None:
    _recent_warnings.clear()


def get_modified_time(path: str) -> int:
    """File mtime in nanoseconds; 0 if the file cannot be stat'ed (live
    reload re-detects a file that disappears and comes back;
    src/utils.rs:33-54, src/render.rs:146-151)."""
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return 0
