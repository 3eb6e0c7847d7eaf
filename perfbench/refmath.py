"""Plain PyTorch arithmetic of the configurations' references, in float64.

Written from the definitions the graphs name, not from the program: the
IEC 61966-2-1 sRGB curves, clamp-to-edge separable correlation, the
Narkowicz ACES curve, GLSL's smoothstep, and the live preview's box
downsample.  It imports torch alone; nothing here reads the program.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def decode_srgb_u8(u8: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 sRGB -> (4, H, W) float64 linear light; alpha is
    linear (x / 255)."""
    x = u8.to(F64).permute(2, 0, 1) / 255.0
    rgb = x[:3]
    lin = torch.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return torch.cat([lin, x[3:]], dim=0)


def encode_srgb(planar: torch.Tensor) -> torch.Tensor:
    """(4, H, W) linear light -> (H, W, 4) sRGB codes in [0, 255], each
    value clamped to [0, 1] first, not yet rounded to a uint8."""
    planar = planar.to(F64)
    rgb = planar[:3].clamp(0.0, 1.0)
    enc = torch.where(rgb <= 0.0031308, rgb * 12.92, 1.055 * rgb ** (1.0 / 2.4) - 0.055)
    alpha = planar[3:].clamp(0.0, 1.0)
    return torch.cat([enc, alpha], dim=0).permute(1, 2, 0) * 255.0


def gaussian_taps(sigma: float, radius: int) -> list[float]:
    """Normalized taps exp(-d^2 / (2 sigma^2)), d = -radius..radius."""
    w = [math.exp(-0.5 * (d / sigma) ** 2) for d in range(-radius, radius + 1)]
    total = sum(w)
    return [v / total for v in w]


def correlate(x: torch.Tensor, taps: list[float], axis: int) -> torch.Tensor:
    """Correlation of (C, H, W) along ``axis`` (1: rows, 2: columns) with
    the edge pixel repeated past the border."""
    r = (len(taps) - 1) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    xp = x.index_select(axis, idx)
    out = torch.zeros_like(x)
    for k, w in enumerate(taps):
        out += w * xp.narrow(axis, k, n)
    return out


def separable(x: torch.Tensor, taps: list[float]) -> torch.Tensor:
    """The same taps along rows and columns."""
    return correlate(correlate(x, taps, 1), taps, 2)


def aces(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz's ACES fit, clamped to [0, 1]."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return ((x * (a * x + b)) / (x * (c * x + d) + e)).clamp(0.0, 1.0)


def smoothstep(e0: float, e1: float, x: torch.Tensor) -> torch.Tensor:
    t = ((x - e0) / (e1 - e0)).clamp(0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def preview_step(h: int, w: int, target_px: int | None) -> int:
    """The integer box step of a preview: the longer edge kept at or above
    ``target_px``, at most the short edge; 1 reads the frame whole."""
    if target_px is None or target_px <= 0:
        return 1
    return max(1, min(max(h, w) // int(target_px), min(h, w)))


def preview(frame: torch.Tensor, target_px: int | None) -> torch.Tensor:
    """The preview the user sees of a (4, H, W) linear frame, as unrounded
    sRGB codes: a box mean of ``step`` x ``step`` cells in linear light,
    then the encode."""
    h, w = frame.shape[1], frame.shape[2]
    step = preview_step(h, w, target_px)
    x = frame.to(F64)
    if step > 1:
        hc, wc = h // step, w // step
        x = x[:, :hc * step, :wc * step].reshape(4, hc, step, wc, step).mean(dim=(2, 4))
    return encode_srgb(x)
