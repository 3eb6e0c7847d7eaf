"""Plain reference of glsl_chain_4k (graph.rf), in float64.

Written from the three shaders' GLSL (shaders/): gaussian_h.comp and
gaussian_v.comp each average rgb over d = -r..r, r = int(ceil(3 s)),
s = max(sigma, 0.001), with weights exp(-0.5 d^2 / s^2) over their sum,
reading clamped coordinates, and keep the centre pixel's alpha;
tonemap.comp applies ACES to rgb * exposure (1 where exposure <= 0) and
keeps alpha.
"""

from __future__ import annotations

import math

import torch

from perfbench import refmath


def _taps(sigma: float) -> list[float]:
    s = max(sigma, 0.001)
    return refmath.gaussian_taps(s, int(math.ceil(3.0 * s)))


def frame(u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The (4, H, W) float64 output for the (H, W, 4) uint8 input."""
    p = cfg["params"]
    x = refmath.decode_srgb_u8(u8)
    rgb = refmath.correlate(x[:3], _taps(p["gh"]["sigma"]), 2)
    rgb = refmath.correlate(rgb, _taps(p["gv"]["sigma"]), 1)
    ev = p["tm"]["exposure"]
    rgb = refmath.aces(rgb * (1.0 if ev <= 0.0 else ev))
    return torch.cat([rgb, x[3:]])
