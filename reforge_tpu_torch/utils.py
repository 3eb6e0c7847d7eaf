"""Terminal coloring and warnings (the subset of ``reforge_tpu.utils`` the
port uses, with the same behaviour).

``warnln`` prints a yellow warning to stderr after clearing the in-place
status line, and records it so tests and keep-last-good paths can assert
on diagnostics without capturing stderr (reference: src/utils.rs:13-18).
"""

from __future__ import annotations

import collections
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
