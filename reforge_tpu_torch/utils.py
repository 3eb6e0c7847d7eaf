"""Terminal coloring, warnings, file mtimes and the CLI's small helpers
(the port's copy of ``reforge_tpu.utils``, with the same behaviour), and
the bounded caches' insert.

``warnln`` prints a yellow warning to stderr after clearing the in-place
status line, and records it so tests and keep-last-good paths can assert
on diagnostics without capturing stderr (reference: src/utils.rs:13-18).
"""

from __future__ import annotations

import collections
import os
import sys
import time
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


def remember(cache: dict, limit: int, key, value) -> None:
    """``cache[key] = value``, first dropping the oldest half of ``cache``
    (dicts keep insertion order) when it holds ``limit`` entries."""
    if len(cache) >= limit:
        for old in list(cache)[: limit // 2]:
            cache.pop(old, None)  # another build thread may have dropped it
    cache[key] = value


def get_modified_time(path: str) -> int:
    """File mtime in nanoseconds; 0 if the file cannot be stat'ed (live
    reload re-detects a file that disappears and comes back;
    src/utils.rs:33-54, src/render.rs:146-151)."""
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return 0


def get_dim(
    image_width: int,
    image_height: int,
    requested_width: int | None,
    requested_height: int | None,
) -> tuple[int, int]:
    """Aspect-preserving dimension selection.

    If both width and height are requested, use them as-is.  If only one is
    requested, scale the other to preserve the source aspect ratio.  If
    neither, use the source dimensions.  (reference: src/utils.rs:56-74)
    """
    if requested_width is not None and requested_height is not None:
        return requested_width, requested_height
    if requested_width is not None:
        scale = requested_width / image_width
        return requested_width, max(1, round(image_height * scale))
    if requested_height is not None:
        scale = requested_height / image_height
        return max(1, round(image_width * scale)), requested_height
    return image_width, image_height


MOVING_AVG_WINDOW = 60


def moving_avg(avg: float, new_value: float, window: int = MOVING_AVG_WINDOW) -> float:
    """Constant-window moving average (src/utils.rs:76-82)."""
    avg -= avg / window
    avg += new_value / window
    return avg


def get_elapsed_ms(t_start: float) -> float:
    """Milliseconds since ``t_start`` (a time.perf_counter() value)."""
    return (time.perf_counter() - t_start) * 1000.0
