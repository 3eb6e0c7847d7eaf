"""Benchmark graph definitions and measurement helpers (the port of
``reforge_tpu/benchmarks.py``).

The flagship graph: a separable gaussian and an unsharp mask of the
input, blended, tonemapped and vignetted.  Timings end in
``torch.cuda.synchronize()`` on a GPU: launches are asynchronous, and the
synchronize proves every frame finished.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from .config import parse
from .graph import GraphProgram, build_graph, make_program

FLAGSHIP_CONFIG = """
// 5-node flagship: blur + unsharp fan-in, blended, tonemapped, vignetted.
input -> soften -> mixer -> tone -> vig -> output
input -> crisp -> mixer:input_image2

soften: gaussian { sigma: 4.0 }
crisp:  unsharp  { sigma: 2.0, amount: 0.8 }
mixer:  mix      { factor: 0.5 }
tone:   tonemap  { exposure: 1.1 }
vig:    vignette { strength: 0.4 }
"""


def build_flagship(width: int, height: int, fmt: str = "rgba32f", device="cpu",
                   plan_strips: bool = True) -> GraphProgram:
    cfg = parse(FLAGSHIP_CONFIG, expects_input=True)
    graph = build_graph(cfg) if cfg is not None else None
    program = (
        make_program(graph, width, height, fmt, plan_strips=plan_strips, device=device)
        if graph is not None else None
    )
    if program is None:
        raise RuntimeError("the flagship graph failed to build")
    return program


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def bench_program(program, file_input: torch.Tensor, frames: int = 60, warmup: int = 5) -> dict:
    """Steady-state frames/sec, one ``program(...)`` dispatch per frame."""
    for i in range(warmup):
        program(file_input, float(i) * 0.01)
    _sync(file_input)
    start = _time.perf_counter()
    for i in range(frames):
        program(file_input, 1.0 + i * 0.016)
    _sync(file_input)
    elapsed = _time.perf_counter() - start
    return {
        "frames": frames,
        "seconds": elapsed,
        "fps": frames / elapsed,
        "ms_per_frame": elapsed / frames * 1000.0,
    }


def bench_program_sequenced(program, file_input: torch.Tensor, frames: int = 120,
                            chunk: int = 24, warmup_chunks: int = 2) -> dict:
    """Steady-state frames/sec through ``render_sequence`` in chunks of
    ``chunk`` frames (the multi-frame export path)."""
    frames = max(frames // chunk, 1) * chunk
    for i in range(warmup_chunks):
        program.render_sequence(file_input, float(i), 0.016, chunk)
    _sync(file_input)
    start = _time.perf_counter()
    for c in range(frames // chunk):
        program.render_sequence(file_input, 1.0 + c * chunk * 0.016, 0.016, chunk)
    _sync(file_input)
    elapsed = _time.perf_counter() - start
    return {
        "frames": frames,
        "seconds": elapsed,
        "fps": frames / elapsed,
        "ms_per_frame": elapsed / frames * 1000.0,
    }


def make_test_image(height: int, width: int, seed: int = 0, device="cpu") -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((4, height, width), dtype=np.float32)).to(device)
