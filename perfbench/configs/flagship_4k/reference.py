"""Plain reference of flagship_4k (graph.rf), in float64.

Written from the builtins' definitions: gaussian (clamp-to-edge separable
taps exp(-d^2 / 2 sigma^2) over d = -r..r, r = ceil(3 sigma) capped at 96,
all four channels), unsharp (x + amount * (x - blur(x)) on rgb, alpha
kept), mix (a + (b - a) * factor, four channels), tonemap (ACES of
rgb * exposure) and vignette (rgb * (1 - strength * smoothstep(radius,
1.42, d)), d the distance from the centre in coordinates of -1..1 that
reach the edge pixels' centres).
"""

from __future__ import annotations

import math

import torch

from perfbench import refmath


def _radius(sigma: float) -> int:
    return int(min(96, max(1, math.ceil(3.0 * sigma))))


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    return refmath.separable(x, refmath.gaussian_taps(sigma, _radius(sigma)))


def frame(u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The (4, H, W) float64 output for the (H, W, 4) uint8 input."""
    p = cfg["params"]
    x = refmath.decode_srgb_u8(u8)
    soften = _blur(x, p["soften"]["sigma"])
    blurred = _blur(x[:3], p["crisp"]["sigma"])
    crisp = torch.cat([x[:3] + p["crisp"]["amount"] * (x[:3] - blurred), x[3:]])
    del blurred
    mixed = soften + (crisp - soften) * p["mixer"]["factor"]
    del soften, crisp
    rgb = refmath.aces(mixed[:3] * p["tone"]["exposure"])
    h, w = x.shape[1], x.shape[2]
    ny = torch.arange(h, dtype=refmath.F64, device=x.device) / max(h - 1, 1) * 2.0 - 1.0
    nx = torch.arange(w, dtype=refmath.F64, device=x.device) / max(w - 1, 1) * 2.0 - 1.0
    d = torch.sqrt(nx[None, :] ** 2 + ny[:, None] ** 2)
    vig = p["vig"]
    fade = 1.0 - vig["strength"] * refmath.smoothstep(vig["radius"], 1.42, d)
    return torch.cat([rgb * fade, mixed[3:]])
