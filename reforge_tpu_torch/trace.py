"""Spans: named host intervals at the port's layer boundaries.

A span records its name, its start and end (``time.perf_counter_ns``), its
parent (the span open on this thread when it opened: a context variable,
so a build thread's spans parent on that thread's own), an identifier
shared by one request (the engine's frame number or the build's number;
a span given none takes its parent's) and a few attributes.

* ``span``: the frame path (poll, render, dispatch, forward, preview and
  their parts).  Recorded, into ``SPANS``, only while a ``torch.profiler``
  session is active on this thread; each then also opens
  ``record_function("rf.<name>")``, which puts it on the profiler's host
  timeline, the clock the device's events are on.  With no profiler a
  span costs one check and returns a shared null context.  The check is
  ``torch._C._autograd._profiler_enabled()`` (about 0.2 us; an unguarded
  ``record_function`` costs some 19 us): it is the per-thread state that
  RecordFunction itself reads, so a span is kept exactly when its range
  would reach a trace.  ``torch.autograd.profiler._is_profiler_enabled``
  is a process-wide bool that only the Python profiler classes set.
* ``build_span``: the build (config, graph, shape check, planning, the
  kernels' library).  Always kept: one opened with no build open on this
  thread starts a build record (``Build``) of its own, and ``BUILDS``
  keeps the last ``BUILDS_KEPT``.  Mirrored to the profiler when one runs.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
from typing import Any, Optional

import torch

PREFIX = "rf."
SPANS_KEPT = 4096
BUILDS_KEPT = 16


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    start_ns: int
    parent: Optional[Span]
    request: Optional[int]
    attrs: dict[str, Any]
    thread: str
    end_ns: int = 0

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


@dataclasses.dataclass(eq=False)
class Build:
    """One build's spans, its root (the span that opened it) first."""

    number: int
    spans: list[Span] = dataclasses.field(default_factory=list)

    def first(self, name: str) -> Optional[Span]:
        return next((s for s in self.spans if s.name == name), None)


SPANS: collections.deque[Span] = collections.deque(maxlen=SPANS_KEPT)
BUILDS: collections.deque[Build] = collections.deque(maxlen=BUILDS_KEPT)

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar("rf_span", default=None)
_build: contextvars.ContextVar[Optional[Build]] = contextvars.ContextVar("rf_build", default=None)
_build_numbers = itertools.count(1)


def span(name: str, request: Optional[int] = None, **attrs):
    """A frame-path span (a context manager yielding the ``Span``, or None
    when no profiler is active on this thread)."""
    if not _profiling():
        return _NULL
    return _open(name, request, attrs, SPANS)


@contextlib.contextmanager
def build_span(name: str, **attrs):
    """A build span, kept in the open build record, or in a new one."""
    record = _build.get()
    token = None
    if record is None:
        record = Build(next(_build_numbers))
        BUILDS.append(record)
        token = _build.set(record)
    try:
        with _open(name, record.number, attrs, record.spans) as sp:
            yield sp
    finally:
        if token is not None:
            _build.reset(token)


@contextlib.contextmanager
def _open(name: str, request: Optional[int], attrs: dict, into):
    parent = _current.get()
    if request is None and parent is not None:
        request = parent.request
    sp = Span(name, time.perf_counter_ns(), parent, request, attrs,
              threading.current_thread().name)
    into.append(sp)
    token = _current.set(sp)
    try:
        if _profiling():
            args = " ".join(f"{k}={v}" for k, v in {"request": request, **attrs}.items())
            with torch.profiler.record_function(PREFIX + name, args):
                yield sp
        else:
            yield sp
    finally:
        sp.end_ns = time.perf_counter_ns()
        _current.reset(token)
