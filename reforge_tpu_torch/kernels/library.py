"""Builtin kernels of the main paths (the port of
``reforge_tpu/kernels/library.py``: the builtins of the flagship, the
demo, edges and chain3 graphs and the reference's mc test graphs).

Every form of each builtin is ported: ``fn``, ``conv_weights``,
``conv_pre``, ``conv_epilogue`` and ``conv_epilogue_cw``, ``cw_fn``,
``cw_coord_plane``, ``cw_plane_fn`` and ``mc_stencil_fn``.  Each node
form the kernels evaluate also has a device form: ``cw_op`` for the
graph_strip kernel's op list, ``mc_op`` for the graph_strip_mc kernel's
stage list (opcodes in cuda_ops.py).  The other builtins of the
reference library are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda_ops as co
from .base import kernel, register_kernel
from .ops import (
    apply_stencil,
    conv2d,
    gaussian_blur,
    gaussian_radius,
    gaussian_weights,
    grid_coords,
    luma,
    map_rgb,
    smoothstep,
)


# ---- identity -----------------------------------------------------------


@kernel("passthrough", doc="Identity copy (reference: shaders/passthrough.comp).")
def passthrough(ctx, input_image):
    return input_image


passthrough.cw_fn = lambda ctx, ci, ins, p: ins["input_image"]
passthrough.cw_op = lambda p, plane: (co.OP_COPY, ())
passthrough.mc_op = lambda p, pre=False: co.McOp(co.MC_COPY)


# ---- colour (channel-mixing) ----------------------------------------------


@kernel("grayscale")
def grayscale(ctx, input_image):
    y = luma(input_image)
    return map_rgb(input_image, lambda rgb: y[None].expand(rgb.shape))


@kernel("saturation")
def saturation(ctx, input_image, *, amount=1.0):
    y = luma(input_image)[None]
    return map_rgb(input_image, lambda rgb: y + (rgb - y) * amount)


@kernel("threshold")
def threshold(ctx, input_image, *, value=0.5):
    y = luma(input_image)
    mask = (y > value).to(input_image.dtype)[None]
    return map_rgb(input_image, lambda rgb: mask.expand(rgb.shape))


grayscale.mc_op = lambda p, pre=False: co.McOp(co.MC_GRAYSCALE)
saturation.mc_op = lambda p, pre=False: co.McOp(co.MC_SATURATION, (p["amount"],))
threshold.mc_op = lambda p, pre=False: co.McOp(co.MC_THRESHOLD, (p["value"],))


# ---- tonemapping --------------------------------------------------------


def _aces(rgb: torch.Tensor) -> torch.Tensor:
    # Narkowicz 2015 ACES filmic approximation.
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((rgb * (a * rgb + b)) / (rgb * (c * rgb + d) + e), 0.0, 1.0)


def _reinhard(rgb: torch.Tensor) -> torch.Tensor:
    return rgb / (1.0 + rgb)


@kernel("tonemap")
def tonemap(ctx, input_image, *, exposure=1.0, aces=True):
    f = _aces if aces else _reinhard
    return map_rgb(input_image, lambda rgb: f(rgb * exposure))


def _tonemap_cw(ctx, ci, ins, p):
    x = ins["input_image"]
    f = _aces if p["aces"] else _reinhard
    return torch.where(ci < 3, f(x * p["exposure"]), x)


tonemap.cw_fn = _tonemap_cw
tonemap.cw_op = lambda p, plane: (
    co.OP_ACES if p["aces"] else co.OP_REINHARD, (p["exposure"],)
)
tonemap.mc_op = lambda p, pre=False: co.McOp(
    co.MC_ACES if p["aces"] else co.MC_REINHARD, (p["exposure"],)
)


# ---- convolutions -------------------------------------------------------


def _sigma_halo(p):
    return gaussian_radius(p["sigma"]) if p["sigma"] > 0 else 0


def _mxu_ok(ctx) -> bool:
    """rgba16f: the conv reads its (bf16-stored) input as bf16."""
    return ctx.fmt == "rgba16f"


@kernel("gaussian", halo=_sigma_halo, doc="Separable gaussian blur.")
def gaussian(ctx, input_image, *, sigma=4.0):
    return gaussian_blur(input_image, sigma, prefer_mxu=_mxu_ok(ctx))


# "blur" is the name the reference README configs use.
@kernel("blur", halo=_sigma_halo)
def blur(ctx, input_image, *, sigma=4.0):
    return gaussian_blur(input_image, sigma, prefer_mxu=_mxu_ok(ctx))


@kernel("unsharp", halo=_sigma_halo)
def unsharp(ctx, input_image, *, sigma=2.0, amount=0.8):
    blurred = gaussian_blur(input_image, sigma, prefer_mxu=_mxu_ok(ctx))
    return map_rgb(input_image, lambda rgb: rgb + amount * (rgb - blurred[:3]))


def _gauss_plan(p):
    if p["sigma"] <= 0:
        return None
    w = gaussian_weights(p["sigma"])
    return (w, w)


def _unsharp_epilogue(ctx, x, blurred, p):
    amount = p["amount"]
    return map_rgb(x, lambda rgb: rgb + amount * (rgb - blurred[:3]))


for _spec in (gaussian, blur):
    _spec.conv_weights = _gauss_plan
    _spec.conv_epilogue = lambda ctx, x, blurred, p: blurred
    _spec.conv_epilogue_cw = lambda ctx, ci, x, b, p: b
    _spec.cw_op = lambda p, plane: (co.OP_TAKE1, ())

unsharp.conv_weights = _gauss_plan
unsharp.conv_epilogue = _unsharp_epilogue
unsharp.conv_epilogue_cw = lambda ctx, ci, x, b, p: torch.where(
    ci < 3, x + p["amount"] * (x - b), x
)
unsharp.cw_op = lambda p, plane: (co.OP_UNSHARP, (p["amount"],))

# mc device forms.  sigma <= 0 has no conv: the node is then a point stage
# that copies its input (x + amount * (x - x) is x for finite images).
for _spec in (gaussian, blur):
    _spec.mc_op = lambda p, pre=False: co.McOp(
        co.MC_CONV_IDENTITY if p["sigma"] > 0 else co.MC_COPY
    )
unsharp.mc_op = lambda p, pre=False: (
    co.McOp(co.MC_CONV_UNSHARP, (p["amount"],)) if p["sigma"] > 0 else co.McOp(co.MC_COPY)
)


# ---- stencils ---------------------------------------------------------------

# Tap tables of the reference's stencil builtins (library.py:180, 249-250,
# 257), held bit-equal to them by tests/test_torch_stencil.py.
SHARPEN_TAPS = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=np.float32)
SOBEL_X_TAPS = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y_TAPS = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)
EMBOSS_TAPS = np.array([[-2, -1, 0], [-1, 1, 1], [0, 1, 2]], dtype=np.float32)


@kernel("sharpen", halo=lambda p: 1)
def sharpen(ctx, input_image, *, amount=1.0):
    """Laplacian unsharp: x + amount * (x - local mean)."""
    high = conv2d(input_image, SHARPEN_TAPS)
    return map_rgb(input_image, lambda rgb: rgb + amount * high[:3])


@kernel("sobel", halo=lambda p: 1)
def sobel(ctx, input_image, *, amount=1.0):
    """Sobel gradient magnitude of luminance."""
    y = luma(input_image)[None]
    gx = conv2d(y, SOBEL_X_TAPS)
    gy = conv2d(y, SOBEL_Y_TAPS)
    mag = torch.sqrt(gx * gx + gy * gy) * amount
    return map_rgb(input_image, lambda rgb: mag.expand(rgb.shape))


@kernel("emboss", halo=lambda p: 1)
def emboss(ctx, input_image, *, amount=1.0):
    return map_rgb(input_image, lambda rgb: conv2d(rgb, EMBOSS_TAPS * amount))


@kernel("median3", halo=lambda p: 1)
def median3(ctx, input_image):
    """3x3 median by a 9-element sorting network per pixel (one
    stencil_apply launch on the card)."""
    med = apply_stencil(input_image, 1, 1, co.MEDIAN9)
    return map_rgb(input_image, lambda rgb: med[:3])


# Multi-channel stencil forms (the mc tier; tap(dy, dx) is a (4, h, w)
# shifted view), in ops.conv2d's ascending (dy, dx) order.  The mc tables
# scale emboss's taps as the reference's mc form does: each weight is the
# Python product w * amount, rounded once to f32.
def _sum_table(tap, table):
    return co.ordered_wsum(tap, co.wsum(table).terms, lambda: tap(1, 1))


def _sobel_mc(ctx, tap, p):
    ys = {}

    def y(dy, dx):
        if (dy, dx) not in ys:
            ys[(dy, dx)] = luma(tap(dy, dx))
        return ys[(dy, dx)]

    gx = _sum_table(y, SOBEL_X_TAPS)
    gy = _sum_table(y, SOBEL_Y_TAPS)
    mag = torch.sqrt(gx * gx + gy * gy) * p["amount"]
    return map_rgb(tap(1, 1), lambda rgb: mag[None].expand(rgb.shape))


def _sharpen_mc(ctx, tap, p):
    high = _sum_table(tap, SHARPEN_TAPS)
    return map_rgb(tap(1, 1), lambda rgb: rgb + p["amount"] * high[:3])


def _emboss_mc_table(p):
    a = p["amount"]
    return np.array([[float(w) * a for w in row] for row in EMBOSS_TAPS], np.float32)


def _emboss_mc(ctx, tap, p):
    out = _sum_table(tap, _emboss_mc_table(p))
    return map_rgb(tap(1, 1), lambda rgb: out[:3])


def _median3_mc(ctx, tap, p):
    med = co.median9_plain([tap(dy, dx) for dy in range(3) for dx in range(3)])
    return map_rgb(tap(1, 1), lambda rgb: med[:3])


sobel.mc_stencil_fn = _sobel_mc
sharpen.mc_stencil_fn = _sharpen_mc
emboss.mc_stencil_fn = _emboss_mc
median3.mc_stencil_fn = _median3_mc
sobel.mc_op = lambda p, pre=False: co.McOp(
    co.MC_SOBEL, (p["amount"],), (SOBEL_X_TAPS, SOBEL_Y_TAPS)
)
sharpen.mc_op = lambda p, pre=False: co.McOp(co.MC_SHARPEN, (p["amount"],), (SHARPEN_TAPS,))
emboss.mc_op = lambda p, pre=False: co.McOp(co.MC_EMBOSS, (), (_emboss_mc_table(p),))
median3.mc_op = lambda p, pre=False: co.McOp(co.MC_MEDIAN3)


# ---- bloom ------------------------------------------------------------------


@kernel("bloom", halo=lambda p: gaussian_radius(p["sigma"]))
def bloom(ctx, input_image, *, threshold=0.7, sigma=8.0, intensity=0.6):
    y = luma(input_image)
    glow_mask = smoothstep(threshold, threshold + 0.2, y)[None]
    glow = gaussian_blur(input_image[:3] * glow_mask, sigma, prefer_mxu=_mxu_ok(ctx))
    return map_rgb(input_image, lambda rgb: rgb + intensity * glow)


# A node-internal pre-map (the threshold mask) feeding the separable
# gaussian, and an epilogue adding the glow back: one conv stage (after a
# pre-map stage) of the mc tier.
def _bloom_pre(ctx, x, p):
    y = luma(x)
    mask = smoothstep(p["threshold"], p["threshold"] + 0.2, y)[None]
    return torch.cat([x[:3] * mask, x[3:4]], dim=0)


def _bloom_mc_op(p, pre=False):
    if pre:
        # smoothstep(t, t + 0.2, y) divides by (t + 0.2) - t taken in double
        # precision, as Python evaluates it in the reference.
        return co.McOp(co.MC_BLOOM_PRE, (p["threshold"], (p["threshold"] + 0.2) - p["threshold"]))
    return co.McOp(co.MC_CONV_BLOOM, (p["intensity"],))


bloom.conv_weights = _gauss_plan
bloom.conv_pre = _bloom_pre
bloom.conv_epilogue = lambda ctx, x, blurred, p: map_rgb(
    x, lambda rgb: rgb + p["intensity"] * blurred[:3]
)
bloom.mc_op = _bloom_mc_op


# ---- multi-input ---------------------------------------------------------


@kernel("mix")
def mix(ctx, input_image, input_image2, *, factor=0.5):
    return input_image + (input_image2 - input_image) * factor


mix.cw_fn = lambda ctx, ci, ins, p: (
    ins["input_image"] + (ins["input_image2"] - ins["input_image"]) * p["factor"]
)
mix.cw_op = lambda p, plane: (co.OP_MIX, (p["factor"],))
mix.mc_op = lambda p, pre=False: co.McOp(co.MC_MIX, (p["factor"],))

# "blend" is the same kernel under the reference README's name.
register_kernel(dataclasses.replace(mix, name="blend"))


# ---- spatial --------------------------------------------------------------


def _vignette_fade(ctx, strength, radius):
    h, w = ctx.height, ctx.width
    ys, xs = grid_coords(ctx)
    ny = (ys.to(torch.float32) / max(h - 1, 1)) * 2.0 - 1.0
    nx = (xs.to(torch.float32) / max(w - 1, 1)) * 2.0 - 1.0
    d = torch.sqrt(nx * nx + ny * ny)
    return 1.0 - strength * smoothstep(radius, 1.42, d)


@kernel("vignette")
def vignette(ctx, input_image, *, strength=0.5, radius=0.75):
    fade = _vignette_fade(ctx, strength, radius)
    return map_rgb(input_image, lambda rgb: rgb * fade[None])


def _vignette_cw(ctx, ci, ins, p):
    x = ins["input_image"]
    fade = _vignette_fade(ctx, p["strength"], p["radius"])
    return torch.where(ci < 3, x * fade, x)


def _fade_plane_cw(ctx, ci, ins, p, plane):
    x = ins["input_image"]
    return torch.where(ci < 3, x * plane, x)


def _vignette_op(p, plane):
    if plane:
        return (co.OP_FADE_PLANE, ())
    # smoothstep(radius, 1.42, d) divides by (1.42 - radius) taken in double
    # precision, as Python evaluates it in the reference.
    return (co.OP_VIGNETTE, (p["strength"], p["radius"], 1.42 - p["radius"]))


vignette.cw_fn = _vignette_cw
vignette.cw_coord_plane = lambda ctx, p: _vignette_fade(ctx, p["strength"], p["radius"])
vignette.cw_plane_fn = _fade_plane_cw
vignette.cw_op = _vignette_op
vignette.mc_op = lambda p, pre=False: co.McOp(
    co.MC_VIGNETTE, (p["strength"], p["radius"], 1.42 - p["radius"])
)
