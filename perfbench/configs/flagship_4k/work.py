"""The least work of one flagship_4k frame, counted from the graph.

Bytes: the decoded input read once and the output written once, 16 bytes
a pixel each (rgba32f).  Operations: the f32 arithmetic the nodes define
at these parameters, an FMA two, every other operation (add, multiply,
divide, min, max, sqrt) one; what a node leaves unused is not counted
(unsharp's blur of alpha), and constants are folded.
"""

from __future__ import annotations

import math

FMA = 2
# ACES of rgb * exposure: the scale, a*x+b, x*(.), c*x+d, x*(.)+e, the
# divide and the clamp's two bounds.
ACES = 1 + FMA + 1 + FMA + FMA + 1 + 2
# The fade: nx and ny (an FMA each), d^2 (a multiply and an FMA), sqrt,
# smoothstep (an FMA into [0, 1], the clamp's two bounds, 3 - 2t an FMA,
# two multiplies), 1 - strength * s (an FMA).
FADE = FMA + FMA + 1 + FMA + 1 + FMA + 2 + FMA + 2 + FMA


def _taps(sigma: float) -> int:
    return 2 * int(min(96, max(1, math.ceil(3.0 * sigma)))) + 1


def least_work(cfg: dict) -> dict:
    """{"bytes": ..., "flops": ...} of one frame."""
    p = cfg["params"]
    pixels = cfg["width"] * cfg["height"]
    soften = 2 * _taps(p["soften"]["sigma"]) * FMA * 4   # both axes, four channels
    crisp = 2 * _taps(p["crisp"]["sigma"]) * FMA * 3 + 3 * (1 + FMA)  # blur rgb; x + a*(x - b)
    mixer = 4 * (1 + FMA)                                 # a + (b - a) * f
    tone = 3 * ACES
    vig = FADE + 3                                        # the fade, then rgb * fade
    return {"bytes": pixels * (16 + 16), "flops": pixels * (soften + crisp + mixer + tone + vig)}
