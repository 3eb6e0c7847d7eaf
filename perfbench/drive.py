"""The one traffic generator: it reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and drives the program's entry points
with them.

Two loops, named by the mix's ``loop``:

* ``sequence`` (the device side of ``--animate``): back-to-back
  ``render_sequence(x, t, dt, chunk, stack=True)`` calls on
  ``Engine.program``, ``_rf_time`` advancing by ``dt``; each stacked chunk
  is held until the next one is enqueued, as the export's writer queue
  holds frames.  The window ends at the synchronize after its last chunk.
* ``live`` (the live preview loop): ``Engine.trigger_reloads``, then
  ``Engine.render_frame`` (``frames_in_flight`` frames in flight), then
  ``Engine.read_output_scaled(out, preview_px)``, whose ``.cpu()`` ends each
  iteration.  An iteration lasts from its start to the next one's.

Each loop keeps a sample of its answers for the comparison, drawn from the
seed (reservoir sampling of ``hold`` items), and spans of the host clock
around each call into the program.  ``warmup`` steps run the same calls
before the window, so that every shape is built and the allocator holds
every block the window takes.
"""

from __future__ import annotations

import contextlib
import random
import time
from collections import defaultdict


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    kind = ""

    def __init__(self, engine, mix: dict, seed: int):
        self.engine = engine
        self.mix = mix
        self.rng = random.Random(seed)
        self.spans: dict[str, list[float]] = defaultdict(list)
        self.frame_s: list[float] = []
        self.window_s = 0.0
        self._held: list = []
        self._offered = 0

    def _offer(self, item) -> None:
        """Reservoir sampling: each item offered so far is held with the
        same chance, ``hold`` of them at once."""
        self._offered += 1
        hold = self.mix["hold"]
        if len(self._held) < hold:
            self._held.append(item)
        else:
            k = self.rng.randrange(self._offered)
            if k < hold:
                self._held[k] = item

    @contextlib.contextmanager
    def _span(self, name: str, label):
        start = time.perf_counter()
        if label is None:
            yield
        else:
            with label(f"perfbench.{name}"):
                yield
        self.spans[name].append(time.perf_counter() - start)

    def warm_up(self) -> None:
        for _ in range(self.mix["warmup"]):
            self.step(None)
        _sync(self.engine.device)
        self.spans.clear()
        self._held.clear()
        self._offered = 0

    def window(self, seconds: float, label=None) -> int:
        """Steps until ``seconds`` have passed, then waits for the device;
        returns the frames rendered.  ``label`` names host ranges in a trace."""
        self.spans.clear()
        starts = []
        frames = 0
        begin = time.perf_counter()
        deadline = begin + seconds
        now = begin
        while now < deadline:
            starts.append(now)
            frames += self.step(label)
            now = time.perf_counter()
        _sync(self.engine.device)
        end = time.perf_counter()
        self.window_s = end - begin
        self.frame_s = [b - a for a, b in zip(starts, starts[1:] + [end])]
        return frames

    def answers(self) -> list:
        """[(frame, preview or None)] held from the last window."""
        raise NotImplementedError

    def step(self, label) -> int:
        raise NotImplementedError


class SequenceLoop(Loop):
    kind = "sequence"

    def __init__(self, engine, mix: dict, seed: int):
        super().__init__(engine, mix, seed)
        self.x = engine._file_input()
        self.done = 0
        self.prev = None

    def step(self, label) -> int:
        n, dt = self.mix["chunk"], self.mix["dt"]
        with self._span("render_sequence", label):
            chunk = self.engine.program.render_sequence(self.x, self.done * dt, dt, n, stack=True)
        self.prev = chunk  # the chunk before it is let go only now
        self.done += n
        self._offer(chunk)
        return n

    def answers(self) -> list:
        return [(frame, None) for chunk in self._held for frame in chunk.unbind(0)]


class LiveLoop(Loop):
    kind = "live"

    def step(self, label) -> int:
        engine = self.engine
        with self._span("poll", label):
            engine.trigger_reloads()
        with self._span("render_frame", label):
            out = engine.render_frame()
        with self._span("preview", label):
            preview = engine.read_output_scaled(out, self.mix["preview_px"])
        self._offer((out, preview))
        return 1

    def answers(self) -> list:
        return list(self._held)


LOOPS = {cls.kind: cls for cls in (SequenceLoop, LiveLoop)}


def make_loop(engine, mix: dict, seed: int) -> Loop:
    return LOOPS[mix["loop"]](engine, mix, seed)
