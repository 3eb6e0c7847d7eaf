"""The least work of one crt_tv_4k frame, counted from the graph.

Bytes: the decoded input read once and the output written once, 16 bytes
a pixel each (rgba32f).  Operations: the f32 arithmetic the nodes define
at these parameters, an FMA two, every other operation (add, multiply,
divide, min, max, abs, floor, a step's compare) one; constants are folded
and a value the shader computes twice (``dot(centered, centered)``) is
counted once.  ``uv`` and ``gl_FragCoord`` are the pass's inputs and the
sampler's clamps of integer indices are no f32 arithmetic: none is
counted.
"""

from __future__ import annotations

import math

FMA = 2
# hue_saturation: the 3x3 matrix on rgb (a multiply and two FMAs a row),
# the luma (the same), then y + (rgb - y) * s + l on rgb (a subtract, an
# FMA, an add).
FADE = 3 * (1 + 2 * FMA) + (1 + 2 * FMA) + 3 * (1 + FMA + 1)
# crt.frag's geometry: centered (an FMA an axis), the dot (a multiply and
# an FMA), 1 + k * dot (an FMA), warped (a multiply an axis), suv (an FMA
# an axis), the clamp (min and max an axis), inside (abs and a step an
# axis, their product), the texel coordinate (an FMA an axis), its floor
# and the weight (a subtract) an axis.
GEOMETRY = 2 * FMA + (1 + FMA) + FMA + 2 + 2 * FMA + 2 * 2 + (2 * 2 + 1) + 2 * FMA + 2 * 2
# The bilinear sample of rgb: three lerps a channel, a subtract and an FMA
# each.
BILINEAR = 3 * 3 * (1 + FMA)
# The scanline: y * 0.5, fract (a floor and a subtract), the step, then
# 1 - dark * step (an FMA).  The vignette: 1 - 0.4 * dot (an FMA).  The
# output: rgb * inside * line * vig (three multiplies a channel).
SCANLINE = 1 + 2 + 1 + FMA
VIGNETTE = FMA
OUTPUT = 3 * 3


def _taps(sigma: float) -> int:
    return 2 * int(min(96, max(1, math.ceil(3.0 * sigma)))) + 1


def least_work(cfg: dict) -> dict:
    """{"bytes": ..., "flops": ...} of one frame."""
    p = cfg["params"]
    pixels = cfg["width"] * cfg["height"]
    soften = 2 * _taps(p["soften"]["sigma"]) * FMA * 4   # both axes, four channels
    crt = GEOMETRY + BILINEAR + SCANLINE + VIGNETTE + OUTPUT
    return {"bytes": pixels * (16 + 16), "flops": pixels * (FADE + soften + crt)}
