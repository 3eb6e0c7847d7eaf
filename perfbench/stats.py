"""The arithmetic that turns a run's readings into numbers: rates, tails,
and the union of device intervals and its gaps."""

from __future__ import annotations

import math


def rate(count: int, seconds: float) -> float:
    """Work a second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of every value:
    the smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[k - 1]


def union_length(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]:
    overlapping intervals (streams that run at once) count once."""
    total = 0.0
    end = lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in order."""
    out = []
    end = lo
    for s, e in sorted(intervals):
        if s > end and end < hi:
            out.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        out.append((end, hi))
    return out
