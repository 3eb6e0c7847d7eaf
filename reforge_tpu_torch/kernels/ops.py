"""Shared image math for kernels (the port of ``reforge_tpu/kernels/ops.py``).

All functions take planar ``(C, H, W)`` tensors.  Border policy is
clamp-to-edge, done with clamped index arithmetic.  ``sep_conv``,
``apply_stencil`` and ``conv2d`` send a CUDA tensor to the hand-written
kernels (cuda_ops.py) and a CPU tensor to their plain versions.  The
functions that make tap vectors are numpy, copied from the reference so
both packages produce the same taps bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cuda_ops

AXIS_H = 1
AXIS_W = 2


def pad_edge(x: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """Clamp-to-edge padding of the spatial dims of (C, H, W)."""
    if rh == 0 and rw == 0:
        return x
    h, w = x.shape[-2], x.shape[-1]
    ys = torch.clamp(torch.arange(-rh, h + rh, device=x.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-rw, w + rw, device=x.device), 0, w - 1)
    return x.index_select(-2, ys).index_select(-1, xs)


def conv1d(x: torch.Tensor, weights: np.ndarray, axis: int) -> torch.Tensor:
    """1-D correlation of an f32 (C, H, W) image along ``AXIS_H`` or
    ``AXIS_W`` with clamp-to-edge borders: the ``conv1d_h``/``conv1d_w``
    kernels on the card, their plain version on the CPU."""
    if axis == AXIS_H:
        return cuda_ops.conv1d_h(x, weights)
    if axis == AXIS_W:
        return cuda_ops.conv1d_w(x, weights)
    raise ValueError(f"conv1d: axis must be AXIS_H or AXIS_W, not {axis}")


# Combined (H + W) tap count from which an f32 conv takes the
# ``sep_conv_fused_mxu_x3`` entry point, as the reference routes it
# (reforge_tpu/kernels/ops.py:153-166).  Kept as the reference's routing
# label, so launch counts separate heavy convs from light ones; both
# entries run the same kernel here.
X3_MIN_TAPS = 56
# Largest W radius of the bf16 and x3 entries (the reference's band-matmul
# gates, ops.py:138 and pallas_ops.mxu_x3_tile_h there).
MXU_MAX_RW = 128


def sep_conv(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray,
             prefer_mxu: bool = False) -> torch.Tensor:
    """Separable 2-D convolution: 1-D pass along H then along W; returns
    the input's dtype (f32 for every node input).

    The route follows from the shapes, as the reference's does
    (reforge_tpu/kernels/ops.py:117-170), with a shared-memory tile in
    place of its VMEM models.  A conv whose window fits a tile of the
    fused kernels (``cuda_ops.plans_fit``) takes:
      * ``sep_conv_fused_mxu`` (bf16 reads) for a bf16 input or under
        ``prefer_mxu``, up to W radius ``MXU_MAX_RW``.  Set
        ``prefer_mxu`` only for an input whose every value is already
        bf16-exact (a node input upcast from rgba16f storage): for anything
        derived from it (luma, a product, a stack of such planes) the cast
        rounds, and kuwahara's luma and luma^2 planes move its quadrant
        choice;
      * ``sep_conv_fused_mxu_x3`` for convs of at least ``X3_MIN_TAPS``
        combined taps up to W radius ``MXU_MAX_RW``;
      * ``sep_conv_fused`` otherwise.
    Every other conv, and a conv with a radius-0 axis, runs the two 1-D
    kernels ``conv1d_h`` then ``conv1d_w`` in f32 (the reference's route
    where ``fused_tile_h`` finds no tile)."""
    wh = np.asarray(wh, np.float32)
    ww = np.asarray(ww, np.float32)
    xf = x.to(torch.float32)
    if len(wh) > 1 and len(ww) > 1 and cuda_ops.plans_fit([(wh, ww)]):
        narrow = (len(ww) - 1) // 2 <= MXU_MAX_RW
        if (x.dtype == torch.bfloat16 or prefer_mxu) and narrow:
            return cuda_ops.sep_conv_fused_mxu(x.to(torch.bfloat16), wh, ww).to(x.dtype)
        if len(wh) + len(ww) >= X3_MIN_TAPS and narrow:
            return cuda_ops.sep_conv_fused_mxu_x3(xf, wh, ww).to(x.dtype)
        return cuda_ops.sep_conv_fused(xf, wh, ww).to(x.dtype)
    return conv1d(conv1d(xf, wh, AXIS_H), ww, AXIS_W).to(x.dtype)


def apply_stencil(x: torch.Tensor, rh: int, rw: int, op: "cuda_ops.StencilOp",
                  mode: str = "edge") -> torch.Tensor:
    """Evaluate a per-pixel neighbourhood function over a (C, H, W) f32
    image: ``op`` is a ``cuda_ops.StencilOp`` (a weighted sum of a tap
    table, or the median of 3x3), not a closure, because the CUDA kernel
    evaluates it (the ``stencil_apply`` entry point)."""
    return cuda_ops.stencil_apply(x.contiguous(), rh, rw, op, mode)


def conv2d(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Small dense 2-D correlation (static odd-sized table, edge clamp),
    summed in the reference's order (reforge_tpu/kernels/ops.py:213-242):
    the nonzero taps in ascending (dy, dx), one chain up to 16 terms,
    eight stripes merged pairwise above that."""
    taps = np.asarray(taps, np.float32)
    rh, rw = taps.shape[0] // 2, taps.shape[1] // 2
    if rh == 0 and rw == 0:
        return x * float(taps[0, 0])
    return apply_stencil(x, rh, rw, cuda_ops.wsum(taps))


def gaussian_weights(sigma: float, radius: int | None = None) -> np.ndarray:
    """Normalized 1-D gaussian taps; radius defaults to ceil(3*sigma)."""
    sigma = max(float(sigma), 1e-6)
    if radius is None:
        radius = gaussian_radius(sigma)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (xs / sigma) ** 2)
    return (w / w.sum()).astype(np.float32)


MAX_GAUSSIAN_RADIUS = 96


def gaussian_radius(sigma: float) -> int:
    return int(min(MAX_GAUSSIAN_RADIUS, max(1, math.ceil(3.0 * float(sigma)))))


def gaussian_blur(x: torch.Tensor, sigma: float, prefer_mxu: bool = False) -> torch.Tensor:
    if float(sigma) <= 0.0:
        return x
    w = gaussian_weights(sigma)
    return sep_conv(x, w, w, prefer_mxu=prefer_mxu)


def box_weights(radius: int) -> np.ndarray:
    n = 2 * int(radius) + 1
    return np.full((n,), 1.0 / n, dtype=np.float32)


LUMA_WEIGHTS = (0.2126, 0.7152, 0.0722)  # Rec.709, linear light


def luma(x: torch.Tensor) -> torch.Tensor:
    """(4, H, W) -> (H, W) relative luminance."""
    lr, lg, lb = LUMA_WEIGHTS
    return x[0] * lr + x[1] * lg + x[2] * lb


def with_alpha(rgb: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Stack (3, H, W) color with an (H, W) alpha plane into (4, H, W)."""
    return torch.cat([rgb, alpha[None]], dim=0)


def map_rgb(x: torch.Tensor, f) -> torch.Tensor:
    """Apply f to the color planes, passing alpha through unchanged."""
    return torch.cat([f(x[:3]), x[3:4]], dim=0)


def pixel_coords(h: int, w: int, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """(y, x) integer coordinate planes, each (H, W) int32."""
    ys = torch.arange(h, dtype=torch.int32, device=device).view(h, 1).expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=device).view(1, w).expand(h, w)
    return ys, xs


def grid_coords(ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """Global (y, x) coordinate planes of ``ctx``'s block on its device:
    shapes follow the block (``ctx.local_shape``), values the image (a
    slab's rows start at ``ctx.row_offset``)."""
    h, w = ctx.local_shape
    ys, xs = pixel_coords(h, w, ctx.device)
    if ctx.row_offset != 0:
        ys = ys + ctx.row_offset
    return ys, xs


def sample_nearest(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Gather pixels at integer coords (clamped to edge); ``ys``/``xs`` are
    (H', W') int tensors, the result is (C, H', W')."""
    _c, h, w = x.shape
    ys = torch.clamp(ys, 0, h - 1).long()
    xs = torch.clamp(xs, 0, w - 1).long()
    return x[:, ys, xs]


def sample_bilinear(x: torch.Tensor, yf: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at float pixel coords (edge clamp); (C, H', W')."""
    y0 = torch.floor(yf)
    x0 = torch.floor(xf)
    ty = yf - y0
    tx = xf - x0
    y0 = y0.to(torch.int32)
    x0 = x0.to(torch.int32)
    p00 = sample_nearest(x, y0, x0)
    p01 = sample_nearest(x, y0, x0 + 1)
    p10 = sample_nearest(x, y0 + 1, x0)
    p11 = sample_nearest(x, y0 + 1, x0 + 1)
    top = p00 + (p01 - p00) * tx
    bot = p10 + (p11 - p10) * tx
    return top + (bot - top) * ty


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
