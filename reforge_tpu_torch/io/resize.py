"""Pillow's ``Image.resize(size, Image.LANCZOS)`` of an RGBA image, in torch
on the host, where the reference resizes (``reforge_tpu/io/imagefile.py``
converts to RGBA and resizes with Pillow).

Pillow's 8-bit path, which decides its bits:
  * RGBA is premultiplied first (RGBA -> ``RGBa``: ``MULDIV255``, rounded)
    and unpremultiplied after (``255 * v // a``, truncated; alpha 0 and 255
    keep their colour);
  * coefficients are computed in double for each output (Lanczos-3, support
    ``3 * max(in / out, 1)``, taps normalised to sum 1 per output) and
    stored in fixed point with 22 fractional bits, rounded half away from
    zero;
  * the horizontal pass runs first, accumulating from a half bias and
    clipping ``acc >> 22`` to u8, then the vertical pass over its result.
An axis whose size does not change is not resampled.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SUPPORT = 3.0
PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: float) -> float:
    if -SUPPORT <= x < SUPPORT:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def coefficients(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(first input index of each output, (out_size, ksize) int32 taps in
    fixed point, zero past each output's window): Pillow's
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc``, operation for
    operation in double."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int32)
    one = 1 << PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:  # in order, as C's ``ww += w`` (``sum`` compensates)
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        first[xx] = xmin
        taps[xx, :xmax] = [int(-0.5 + v * one) if v < 0 else int(0.5 + v * one) for v in k]
    return first, taps


def _resample(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """One pass over int32 u8 values along ``dim``."""
    first, taps = coefficients(x.shape[dim], out_size)
    index = torch.from_numpy(first)[:, None] + torch.arange(taps.shape[1])
    index = index.clamp_(max=x.shape[dim] - 1)  # past a window the tap is 0
    weights = torch.from_numpy(taps)
    shape = [1] * x.dim()
    shape[dim] = out_size
    acc = torch.full([out_size if d == dim else s for d, s in enumerate(x.shape)],
                     1 << (PRECISION_BITS - 1), dtype=torch.int32)
    for j in range(taps.shape[1]):
        acc += x.index_select(dim, index[:, j]) * weights[:, j].reshape(shape)
    return (acc >> PRECISION_BITS).clamp_(0, 255)


def resize_lanczos(rgba: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, 4) uint8 RGBA -> (height, width, 4) uint8, as Pillow's
    ``Image.fromarray(rgba, "RGBA").resize((width, height), Image.LANCZOS)``."""
    if rgba.shape[:2] == (height, width):
        return rgba.copy()
    x = torch.from_numpy(np.ascontiguousarray(rgba)).to(torch.int32)
    alpha = x[..., 3:]
    translucent = bool((alpha != 255).any())
    if translucent:
        t = x[..., :3] * alpha + 128
        x = torch.cat([(t + (t >> 8)) >> 8, alpha], dim=-1)
    if width != rgba.shape[1]:
        x = _resample(x, 1, width)
    if height != rgba.shape[0]:
        x = _resample(x, 0, height)
    if translucent:
        a = x[..., 3:]
        keep = (a == 0) | (a == 255)
        rgb = torch.where(keep, x[..., :3], (255 * x[..., :3]) // a.clamp(min=1))
        x = torch.cat([rgb.clamp_(0, 255), a], dim=-1)
    return x.to(torch.uint8).numpy()
