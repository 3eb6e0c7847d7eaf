"""The traced window: device intervals from ``torch.profiler``.

The profiler records the host's operations and the device's (kernels,
copies, sets) over one window the harness marks with a range of its own.
From them come the seconds some device operation ran (the union of their
intervals, so that two streams at once count once), the device time by
operation, and the device's idle stretches named by what the host was
doing when each began.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from perfbench import stats

LABEL = "perfbench."
WINDOW = LABEL + "window"


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]          # seconds, the trace's own clock
    frames: int                          # frames the traced window rendered
    device: list[tuple[float, float, str]]
    host: list[tuple[float, float, str]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return stats.union_length([(s, e) for s, e, _ in self.device], *self.window)

    def device_ops(self, top: int = 10) -> list[list]:
        """[name, seconds] of the device operations that took most time."""
        lo, hi = self.window
        by_name: dict[str, float] = defaultdict(float)
        for s, e, name in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                by_name[name] += e - s
        return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """[host activity, seconds] of the device's idle time, each idle
        stretch named by the innermost host range open where it began."""
        host = sorted(self.host)
        starts = [s for s, _, _ in host]
        by_name: dict[str, float] = defaultdict(float)
        for s, e in stats.gaps([(a, b) for a, b, _ in self.device], *self.window):
            by_name[_host_at(host, starts, s)] += e - s
        return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def _host_at(host, starts, t: float, scan: int = 4000) -> str:
    """The name of the latest-starting host range that covers ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        s, e, name = host[j]
        if e >= t and name != WINDOW:
            return name
    return "host: no range open"


def traced(loop, seconds: float) -> Trace:
    """Run ``loop.window(seconds)`` under the profiler and read its trace.
    The loop's window ends with the device synchronized."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            frames = loop.window(seconds, label=record_function)
    device, host, window = [], [], None
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.events():
        span = (ev.time_range.start * 1e-6, ev.time_range.end * 1e-6, ev.name)
        if ev.device_type == cuda:
            # The profiler mirrors each labelled host range on the device's
            # timeline; those are no device work.
            if not (getattr(ev, "is_user_annotation", False) or ev.name.startswith(LABEL)):
                device.append(span)
        else:
            host.append(span)
            if ev.name == WINDOW:
                window = span[:2]
    if window is None:
        raise RuntimeError("the profiler's trace holds no window range")
    return Trace(window=window, frames=frames, device=device, host=host)
