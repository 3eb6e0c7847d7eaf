"""Readings of the program's own spans (``reforge_tpu_torch/trace.py``).

On the frame path they are ``rf.<name>`` ranges of the profiler's host
timeline (``rec.trace.host``), so they share the device's clock; the build's
are the tracer's build records, read in the process that ran the cell.  A
program without the tracer, or a trace without the ranges, reads None.
"""

from __future__ import annotations

from perfbench import stats

PREFIX = "rf."


def ranges(trace, name: str) -> list[tuple[float, float]]:
    """The ``rf.<name>`` host ranges that start inside the traced window."""
    lo, hi = trace.window
    full = PREFIX + name
    return [(s, e) for s, e, n in trace.host if n == full and lo <= s < hi]


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Disjoint intervals covering the same instants, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """Length of the intersection of two lists of disjoint, ordered intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_frame(rec, names: tuple[str, ...]) -> float | None:
    """The device's idle time in the traced window that falls inside the
    union of the named ranges, each idle instant once, over the window's
    frames, in ms (live loop only)."""
    t = rec.trace
    if rec.loop != "live" or t is None or t.frames == 0:
        return None
    inside = union([r for name in names for r in ranges(t, name)])
    if not inside:
        return None
    idle = stats.gaps([(s, e) for s, e, _ in t.device], *t.window)
    return overlap(idle, inside) / t.frames * 1e3


def mean_ms(rec, name: str) -> float | None:
    """Mean duration of the ``rf.<name>`` ranges of the traced window, in ms
    (live loop only)."""
    t = rec.trace
    if rec.loop != "live" or t is None:
        return None
    found = ranges(t, name)
    if not found:
        return None
    return sum(e - s for s, e in found) / len(found) * 1e3


def build_phase_ms(name: str) -> float | None:
    """The first ``name`` span of the first build record whose root is a
    ``build`` (the engine's construction), in ms."""
    try:
        from reforge_tpu_torch import trace
    except ImportError:
        return None
    for record in trace.BUILDS:
        if record.spans[0].name == "build":
            span = record.first(name)
            return span.ms if span is not None else None
    return None
