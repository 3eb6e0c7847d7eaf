"""The least work of one glsl_chain_4k frame, counted from the graph.

Bytes: the decoded input read once and the output written once, 16 bytes
a pixel each (rgba32f).  Operations: the f32 arithmetic the shaders define
at these parameters, an FMA two, every other operation one, constants
folded: each pass's weights and their sum depend on sigma alone, so a pass
is one FMA a tap on rgb; tonemap.comp is ACES of rgb * exposure.
"""

from __future__ import annotations

import math

FMA = 2
# ACES of rgb * exposure: the scale, a*x+b, x*(.), c*x+d, x*(.)+e, the
# divide and the clamp's two bounds.
ACES = 1 + FMA + 1 + FMA + FMA + 1 + 2


def _taps(sigma: float) -> int:
    return 2 * int(math.ceil(3.0 * max(sigma, 0.001))) + 1


def least_work(cfg: dict) -> dict:
    """{"bytes": ..., "flops": ...} of one frame."""
    p = cfg["params"]
    pixels = cfg["width"] * cfg["height"]
    passes = (_taps(p["gh"]["sigma"]) + _taps(p["gv"]["sigma"])) * FMA * 3
    return {"bytes": pixels * (16 + 16), "flops": pixels * (passes + 3 * ACES)}
