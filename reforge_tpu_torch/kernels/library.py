"""Builtin kernels (the port of ``reforge_tpu/kernels/library.py``): every
builtin of the reference library but ``lut1d``, which reads a storage
buffer that only a GLSL or ``.py`` kernel can write.

Every form of each builtin is ported: ``fn``, ``conv_weights``,
``conv_pre``, ``conv_epilogue`` and ``conv_epilogue_cw``, ``cw_fn``,
``cw_coord_plane``, ``cw_plane_fn`` and ``mc_stencil_fn``.  Each node
form the kernels evaluate also has a device form: ``cw_op`` for the
graph_strip kernel's op list, ``mc_op`` for the graph_strip_mc kernel's
stage list (opcodes in cuda_ops.py; the channel-local colour builtins
share ``cuda_ops.CHANNEL_OPS``).  Gathers (pixelate, chromatic
aberration, swirl, wave, flip, the motion and radial blurs, halftone) and
generators (checkerboard, solid) are plain PyTorch on the card, as the
reference leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import cuda_ops as co
from . import prng
from .base import kernel, register_kernel, true_divide
from .ops import (
    apply_stencil,
    box_weights,
    conv2d,
    gaussian_blur,
    gaussian_radius,
    gaussian_weights,
    grid_coords,
    luma,
    map_rgb,
    sample_bilinear,
    sample_nearest,
    sep_conv,
    smoothstep,
    with_alpha,
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


# ---- colour grading ---------------------------------------------------------


def _levels_consts(p) -> tuple:
    """(in_black, span, exponent, out_black, output range): ``span``, the
    exponent and the range in double precision, as the reference's Python
    floats."""
    span = max(float(p["in_white"]) - float(p["in_black"]), 1e-6)
    expo = 1.0 / max(float(p["gamma"]), 1e-6)
    return (p["in_black"], span, expo, p["out_black"],
            float(p["out_white"]) - float(p["out_black"]))


def _levels_rgb(x, p):
    """Photoshop-style levels of colour planes ``x``: input range remap,
    gamma, output range."""
    in_black, span, expo, out_black, out_range = _levels_consts(p)
    t = torch.clamp(true_divide(x - in_black, span), 0.0, 1.0)
    return out_black + t ** expo * out_range


@kernel("levels")
def levels(ctx, input_image, *, in_black=0.0, in_white=1.0, gamma=1.0,
           out_black=0.0, out_white=1.0):
    """Photoshop-style levels: input range remap, gamma, output range."""
    p = dict(in_black=in_black, in_white=in_white, gamma=gamma, out_black=out_black,
             out_white=out_white)
    return map_rgb(input_image, lambda rgb: _levels_rgb(rgb, p))


levels.cw_fn = lambda ctx, ci, ins, p: torch.where(
    ci < 3, _levels_rgb(ins["input_image"], p), ins["input_image"]
)
levels.cw_op = lambda p, plane: (co.OP_CH0 + co.CH["levels"], _levels_consts(p))
# An mc stage has four floats: the output range rides as a 1x1 table.
levels.mc_op = lambda p, pre=False: co.McOp(
    co.MC_CH0 + co.CH["levels"], _levels_consts(p)[:4],
    (np.array([[_levels_consts(p)[4]]], np.float32),)
)


# ---- noise ------------------------------------------------------------------


@kernel("noise", halo=lambda p: None)
def noise(ctx, input_image, *, amount=0.1, seed=0, animate=False):
    """Uniform grain in [-amount/2, amount/2), the reference's
    ``jax.random.uniform`` bits (kernels/prng.py); ``animate`` folds the
    frame clock, ``int32(f32(t) * 1000)``, into the key."""
    fold = int(np.float32(ctx.time) * np.float32(1000.0)) if animate else None
    grain = prng.uniform(int(seed), (1, ctx.height, ctx.width), -0.5, 0.5, fold=fold,
                         device=ctx.device)
    return map_rgb(input_image, lambda rgb: rgb + amount * grain)


# ---- edge-preserving / stylized ---------------------------------------------


@kernel("kuwahara", halo=lambda p: max(int(p["radius"]), 1))
def kuwahara(ctx, input_image, *, radius=4):
    """Kuwahara filter: per pixel, the mean of the least-variant of the four
    overlapping (r+1)x(r+1) quadrant windows, from shifted box sums.

    The four quadrant convs run on one (6, H, W) stack (rgba, luma,
    luma^2), in f32 in every format: the stack's luma planes are not
    bf16-exact, so the bf16 conv entry would round them and move the
    quadrant choice (``ops.sep_conv``)."""
    r = max(int(radius), 1)
    half = np.zeros((2 * r + 1,), np.float32)
    half[: r + 1] = 1.0 / (r + 1)
    lead = half[::-1].copy()  # window covering [0, +r]
    lag = half  # window covering [-r, 0]

    y = luma(input_image)[None]
    stacked = torch.cat([input_image, y, y * y], dim=0)
    best_mean = None
    best_var = None
    for wy in (lag, lead):
        for wx in (lag, lead):
            s = sep_conv(stacked, wy, wx)
            m, my, my2 = s[:4], s[4:5], s[5:6]
            var = my2 - my * my
            if best_var is None:
                best_mean, best_var = m, var
            else:
                take = var < best_var
                best_mean = torch.where(take, m, best_mean)
                best_var = torch.where(take, var, best_var)
    return map_rgb(input_image, lambda rgb: best_mean[:3])


@functools.lru_cache(maxsize=64)
def bilateral_op(radius, sigma_space, sigma_range) -> tuple[int, co.ReduceOp]:
    """(r, the ReduceOp) of bilateral's params: the taps of the (2r+1)^2
    window in row-major (dy, dx) order whose spatial weight, computed in
    Python floats as the reference does, is at least 1e-4."""
    r = max(int(radius), 1)
    ss = max(float(sigma_space), 1e-3)
    sr = max(float(sigma_range), 1e-3)
    inv2ss = 1.0 / (2.0 * ss * ss)
    inv2sr = 1.0 / (2.0 * sr * sr)
    taps = []
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            ws = math.exp(-((dy - r) ** 2 + (dx - r) ** 2) * inv2ss)
            if ws >= 1e-4:
                taps.append((dy, dx, ws))
    return r, co.ReduceOp("bilateral", tuple(taps), inv2sr)


@kernel("bilateral", halo=lambda p: int(p["radius"]))
def bilateral(ctx, input_image, *, radius=3, sigma_space=2.0, sigma_range=0.15):
    """Edge-preserving bilateral filter: each tap of the window weighted by
    its spatial gaussian and by luminance similarity to the centre, in one
    ``stencil_reduce_mc`` launch over (r, g, b, luma) on the card."""
    r, op = bilateral_op(radius, sigma_space, sigma_range)
    x = input_image
    stacked = torch.cat([x[:3], luma(x)[None]], dim=0)
    return with_alpha(co.stencil_reduce_mc(stacked, r, r, op), x[3])


@kernel("halftone", halo=lambda p: None)
def halftone(ctx, input_image, *, size=8, angle=0.0):
    """Newspaper halftone: per-cell luminance controls a round dot.  Cell
    indices divide exactly (``true_divide``), so the card and the CPU put
    every pixel in the same cell."""
    cell = max(int(size), 2)
    ys, xs = grid_coords(ctx)
    a = math.radians(float(angle))
    ca, sa = math.cos(a), math.sin(a)
    # Rotated grid coordinates.
    u = xs * ca + ys * sa
    v = -xs * sa + ys * ca
    cu = torch.floor(true_divide(u, cell)) * cell + cell / 2.0
    cv = torch.floor(true_divide(v, cell)) * cell + cell / 2.0
    # Cell centre back in image space (a gather).
    cx = cu * ca - cv * sa
    cy = cu * sa + cv * ca
    sample = sample_bilinear(input_image, cy, cx)
    y = sample[0] * 0.2126 + sample[1] * 0.7152 + sample[2] * 0.0722
    dot_r = torch.sqrt(torch.clamp(1.0 - y, 0.0, 1.0)) * (cell * 0.7)
    du, dv = u - cu, v - cv
    d = torch.sqrt(du * du + dv * dv)
    # Inside the dot (d < r - 1.5) ink is 1, easing to 0 at the rim.
    ink = smoothstep(dot_r, dot_r - 1.5, d)
    return with_alpha((1.0 - ink)[None].expand(3, -1, -1), input_image[3])


# ---- colour (channel-local) ---------------------------------------------------
#
# Each has its fn, the reference's channel form (cw_fn) and one channel op
# of cuda_ops.CHANNEL_OPS as its device form in both strip kernels.


def _cw_rgb(fn):
    """Channel form applying fn to the colour planes, alpha passed through."""

    def cw(ctx, ci, ins, p):
        x = ins["input_image"]
        return torch.where(ci < 3, fn(x, ins, p), x)

    return cw


def _channel_forms(spec, op: str, params=lambda p: ()):
    """The builtin's cw_op and mc_op: channel op ``op`` with ``params(p)``."""
    spec.cw_op = lambda p, plane: (co.OP_CH0 + co.CH[op], tuple(params(p)))
    spec.mc_op = lambda p, pre=False: co.McOp(co.MC_CH0 + co.CH[op], tuple(params(p)))


@kernel("invert")
def invert(ctx, input_image):
    return map_rgb(input_image, lambda rgb: 1.0 - rgb)


@kernel("exposure")
def exposure(ctx, input_image, *, stops=0.0):
    return map_rgb(input_image, lambda rgb: rgb * (2.0 ** stops))


def _gamma_rgb(x, value):
    return torch.clamp_min(x, 0.0) ** (1.0 / max(value, 1e-6))


@kernel("gamma")
def gamma(ctx, input_image, *, value=2.2):
    return map_rgb(input_image, lambda rgb: _gamma_rgb(rgb, value))


@kernel("brightness_contrast")
def brightness_contrast(ctx, input_image, *, brightness=0.0, contrast=1.0):
    return map_rgb(input_image, lambda rgb: (rgb - 0.5) * contrast + 0.5 + brightness)


def _white_balance_gains(p) -> tuple:
    # Python doubles, rounded to f32 where they multiply, as the reference's
    return (1.0 + p["temperature"], 1.0 + p["tint"], 1.0 - p["temperature"], 1.0)


@kernel("white_balance")
def white_balance(ctx, input_image, *, temperature=0.0, tint=0.0):
    """Simple linear-light white-balance nudge: temperature shifts R/B, tint G."""
    gr, gg, gb, _ = _white_balance_gains(dict(temperature=temperature, tint=tint))
    return map_rgb(input_image,
                   lambda rgb: torch.stack([rgb[0] * gr, rgb[1] * gg, rgb[2] * gb]))


def _white_balance_cw(ctx, ci, ins, p):
    x = ins["input_image"]
    gains = torch.tensor(_white_balance_gains(p), dtype=torch.float32, device=x.device)
    return x * gains[ci]


def _levels_minus_one(p) -> int:
    return max(int(p["levels"]), 2) - 1


def _posterize_rgb(x, n1: int):
    return true_divide(torch.round(torch.clamp(x, 0.0, 1.0) * n1), n1)


@kernel("posterize")
def posterize(ctx, input_image, *, levels=6):
    """Quantize color channels to N levels."""
    n1 = _levels_minus_one(dict(levels=levels))
    return map_rgb(input_image, lambda rgb: _posterize_rgb(rgb, n1))


# The reference's 4x4 Bayer matrix, (M + 0.5) / 16 (library.py:655-661 there).
BAYER4 = (np.array([[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]],
                   np.float32) + 0.5) / 16.0


@kernel("dither")
def dither(ctx, input_image, *, levels=2):
    """Ordered dithering with a 4x4 Bayer matrix."""
    n1 = _levels_minus_one(dict(levels=levels))
    ys, xs = grid_coords(ctx)
    thresh = torch.from_numpy(BAYER4).to(ctx.device)[(ys % 4).long(), (xs % 4).long()]
    return map_rgb(input_image, lambda rgb: true_divide(
        torch.floor(torch.clamp(rgb, 0.0, 1.0) * n1 + thresh[None]), n1))


def _dither_cw(ctx, ci, ins, p):
    # The closed-form Bayer matrix of the reference's channel form.
    n1 = _levels_minus_one(p)
    ys, xs = grid_coords(ctx)
    x = ins["input_image"]
    scaled = torch.clamp(x, 0.0, 1.0) * n1
    return torch.where(ci < 3, true_divide(torch.floor(scaled + co.bayer4(ys, xs)), n1), x)


def _scanlines_plane(ctx, p):
    ys, _ = grid_coords(ctx)
    period = max(int(p["period"]), 1)
    return torch.where(ys % period == 0, 1.0 - p["darkness"], 1.0).to(torch.float32)


@kernel("scanlines")
def scanlines(ctx, input_image, *, period=3, darkness=0.35):
    fade = _scanlines_plane(ctx, dict(period=period, darkness=darkness))
    return map_rgb(input_image, lambda rgb: rgb * fade[None])


def _scanlines_cw(ctx, ci, ins, p):
    x = ins["input_image"]
    return torch.where(ci < 3, x * _scanlines_plane(ctx, p), x)


@kernel("add")
def add(ctx, input_image, input_image2, *, scale=1.0):
    return map_rgb(input_image, lambda rgb: rgb + scale * input_image2[:3])


@kernel("multiply")
def multiply(ctx, input_image, input_image2):
    return map_rgb(input_image, lambda rgb: rgb * input_image2[:3])


@kernel("screen")
def screen(ctx, input_image, input_image2):
    return map_rgb(input_image, lambda rgb: 1.0 - (1.0 - rgb) * (1.0 - input_image2[:3]))


def _overlay(x, b):
    return torch.where(x < 0.5, 2.0 * x * b, 1.0 - 2.0 * (1.0 - x) * (1.0 - b))


@kernel("overlay")
def overlay(ctx, input_image, input_image2):
    return map_rgb(input_image, lambda rgb: _overlay(rgb, input_image2[:3]))


@kernel("difference")
def difference(ctx, input_image, input_image2):
    return map_rgb(input_image, lambda rgb: torch.abs(rgb - input_image2[:3]))


invert.cw_fn = _cw_rgb(lambda x, ins, p: 1.0 - x)
exposure.cw_fn = _cw_rgb(lambda x, ins, p: x * (2.0 ** p["stops"]))
gamma.cw_fn = _cw_rgb(lambda x, ins, p: _gamma_rgb(x, p["value"]))
brightness_contrast.cw_fn = _cw_rgb(
    lambda x, ins, p: (x - 0.5) * p["contrast"] + 0.5 + p["brightness"]
)
white_balance.cw_fn = _white_balance_cw
posterize.cw_fn = _cw_rgb(lambda x, ins, p: _posterize_rgb(x, _levels_minus_one(p)))
dither.cw_fn = _dither_cw
scanlines.cw_fn = _scanlines_cw
scanlines.cw_coord_plane = _scanlines_plane
scanlines.cw_plane_fn = _fade_plane_cw
add.cw_fn = _cw_rgb(lambda x, ins, p: x + p["scale"] * ins["input_image2"])
multiply.cw_fn = _cw_rgb(lambda x, ins, p: x * ins["input_image2"])
screen.cw_fn = _cw_rgb(lambda x, ins, p: 1.0 - (1.0 - x) * (1.0 - ins["input_image2"]))
overlay.cw_fn = _cw_rgb(lambda x, ins, p: _overlay(x, ins["input_image2"]))
difference.cw_fn = _cw_rgb(lambda x, ins, p: torch.abs(x - ins["input_image2"]))

_channel_forms(invert, "invert")
_channel_forms(exposure, "scale", lambda p: (2.0 ** p["stops"],))
_channel_forms(gamma, "gamma", lambda p: (1.0 / max(p["value"], 1e-6),))
_channel_forms(brightness_contrast, "brightness_contrast",
               lambda p: (p["contrast"], p["brightness"]))
_channel_forms(white_balance, "gain", _white_balance_gains)
_channel_forms(posterize, "posterize", lambda p: (_levels_minus_one(p),))
_channel_forms(dither, "dither", lambda p: (_levels_minus_one(p),))
_channel_forms(scanlines, "scanlines",
               lambda p: (max(int(p["period"]), 1), 1.0 - p["darkness"]))
_channel_forms(add, "add", lambda p: (p["scale"],))
_channel_forms(multiply, "multiply")
_channel_forms(screen, "screen")
_channel_forms(overlay, "overlay")
_channel_forms(difference, "difference")
# A program that hoists scanlines' fade plane multiplies by it.
scanlines.cw_op = lambda p, plane: (
    (co.OP_FADE_PLANE, ()) if plane
    else (co.OP_CH0 + co.CH["scanlines"], (max(int(p["period"]), 1), 1.0 - p["darkness"]))
)


# ---- colour (channel-mixing): mc point stages ------------------------------------


@kernel("sepia")
def sepia(ctx, input_image, *, amount=1.0):
    """Classic sepia tone matrix, lerped by ``amount``."""
    rgb = input_image[:3]
    toned = co.matrix_rgb(input_image, co.SEPIA_MATRIX)
    return with_alpha(rgb + (torch.clamp(toned, 0.0, 1.0) - rgb) * amount, input_image[3])


def hue_rotate_matrix(degrees: float) -> np.ndarray:
    """Static 3x3 linear-RGB hue-rotation matrix (the CSS/SVG feColorMatrix
    'hueRotate' formulation), built as the reference builds it."""
    a = math.radians(float(degrees))
    c, s = math.cos(a), math.sin(a)
    return np.array(
        [
            [0.213 + c * 0.787 - s * 0.213, 0.715 - c * 0.715 - s * 0.715,
             0.072 - c * 0.072 + s * 0.928],
            [0.213 - c * 0.213 + s * 0.143, 0.715 + c * 0.285 + s * 0.140,
             0.072 - c * 0.072 - s * 0.283],
            [0.213 - c * 0.213 - s * 0.787, 0.715 - c * 0.715 + s * 0.715,
             0.072 + c * 0.928 + s * 0.072],
        ],
        dtype=np.float32,
    )


@kernel("hue_saturation")
def hue_saturation(ctx, input_image, *, hue=0.0, saturation=1.0, lightness=0.0):
    """Hue rotation (degrees) + saturation scale + lightness offset.  The
    matrix product sums r m0 + g m1 + b m2 with explicit products (never
    a matmul, which the card would run on cuBLAS in another order)."""
    m = hue_rotate_matrix(hue)

    def f(rgb):
        out = co.matrix_rgb(rgb, m)
        y = (out[0] * 0.2126 + out[1] * 0.7152 + out[2] * 0.0722)[None]
        return y + (out - y) * saturation + lightness

    return map_rgb(input_image, f)


sepia.mc_op = lambda p, pre=False: co.McOp(co.MC_SEPIA, (p["amount"],))
# The 3x3 matrix does not fit a stage's four floats: it rides as a table.
hue_saturation.mc_op = lambda p, pre=False: co.McOp(
    co.MC_HUE_SAT, (p["saturation"], p["lightness"]), (hue_rotate_matrix(p["hue"]),)
)


# ---- box blur ---------------------------------------------------------------------


@kernel("box_blur", halo=lambda p: max(int(p["radius"]), 0))
def box_blur(ctx, input_image, *, radius=4):
    """Separable box blur.  A radius whose window fits no shared-memory
    tile runs the 1-D kernels (``ops.sep_conv``)."""
    r = max(int(radius), 0)
    if r == 0:
        return input_image
    w = box_weights(r)
    return sep_conv(input_image, w, w, prefer_mxu=_mxu_ok(ctx))


def _box_plan(p):
    if int(p["radius"]) <= 0:
        return None
    w = box_weights(int(p["radius"]))
    return (w, w)


box_blur.conv_weights = _box_plan
box_blur.conv_epilogue = lambda ctx, x, blurred, p: blurred
box_blur.conv_epilogue_cw = lambda ctx, ci, x, b, p: b
box_blur.cw_op = lambda p, plane: (co.OP_TAKE1, ())
box_blur.mc_op = lambda p, pre=False: co.McOp(
    co.MC_CONV_IDENTITY if int(p["radius"]) > 0 else co.MC_COPY
)


# ---- gathers: plain PyTorch on every tier -----------------------------------------


@kernel("pixelate", halo=lambda p: None)
def pixelate(ctx, input_image, *, size=8):
    size = max(int(size), 1)
    ys, xs = grid_coords(ctx)
    return sample_nearest(input_image, (ys // size) * size, (xs // size) * size)


@kernel("chromatic_aberration", halo=lambda p: None)
def chromatic_aberration(ctx, input_image, *, shift=2.0):
    h, w = ctx.height, ctx.width
    ys, xs = grid_coords(ctx)
    yf = ys.to(torch.float32)
    xf = xs.to(torch.float32)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy = true_divide(yf - cy, max(h, 1))
    dx = true_divide(xf - cx, max(w, 1))
    r = sample_bilinear(input_image[0:1], yf + dy * shift, xf + dx * shift)[0]
    b = sample_bilinear(input_image[2:3], yf - dy * shift, xf - dx * shift)[0]
    return torch.stack([r, input_image[1], b, input_image[3]], dim=0)


@kernel("swirl", halo=lambda p: None)
def swirl(ctx, input_image, *, angle=2.0, radius=0.5):
    h, w = ctx.height, ctx.width
    ys, xs = grid_coords(ctx)
    yf = ys.to(torch.float32)
    xf = xs.to(torch.float32)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy, dx = yf - cy, xf - cx
    dist = torch.sqrt(dx * dx + dy * dy)
    rad = radius * min(h, w)
    theta = angle * torch.clamp_min(1.0 - true_divide(dist, rad), 0.0) ** 2
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    sy = cy + dy * cos_t - dx * sin_t
    sx = cx + dy * sin_t + dx * cos_t
    return sample_bilinear(input_image, sy, sx)


@kernel("wave", halo=lambda p: None)
def wave(ctx, input_image, *, amplitude=8.0, frequency=0.02, speed=1.0):
    """Animated horizontal wave distortion driven by _rf_time.  The phase is
    the reference's f32 product time * speed * 2 * pi, step by step."""
    ys, xs = grid_coords(ctx)
    yf = ys.to(torch.float32)
    xf = xs.to(torch.float32)
    phase = np.float32(ctx.time) * np.float32(speed) * np.float32(2.0) * np.float32(math.pi)
    offset = amplitude * torch.sin(yf * (frequency * 2.0 * math.pi) + float(phase))
    return sample_bilinear(input_image, yf, xf + offset)


@kernel("flip", halo=lambda p: None)
def flip(ctx, input_image, *, horizontal=True, vertical=False):
    out = input_image
    if horizontal:
        out = torch.flip(out, dims=(2,))
    if vertical:
        out = torch.flip(out, dims=(1,))
    return out


@kernel("motion_blur", halo=lambda p: None)
def motion_blur(ctx, input_image, *, length=12.0, angle=0.0, samples=0):
    """Directional blur: average samples along the motion vector.

    ``angle`` in degrees (0 = horizontal drag), ``length`` in pixels
    end-to-end; ``samples`` 0 picks one per pixel of length."""
    L = max(float(length), 0.0)
    if L == 0.0:
        return input_image
    n = int(samples) if int(samples) >= 2 else max(int(L), 2)
    th = float(angle) * np.pi / 180.0
    dy, dx = float(np.sin(th)), float(np.cos(th))
    ys, xs = grid_coords(ctx)
    yf = ys.to(torch.float32)
    xf = xs.to(torch.float32)
    acc = None
    for i in range(n):
        t = (i / (n - 1) - 0.5) * L
        s = sample_bilinear(input_image, yf + dy * t, xf + dx * t)
        acc = s if acc is None else acc + s
    return with_alpha(true_divide(acc[:3], n), input_image[3])


@kernel("radial_blur", halo=lambda p: None)
def radial_blur(ctx, input_image, *, strength=0.15, samples=12, center_x=0.5, center_y=0.5):
    """Zoom blur: average samples along the ray toward the center."""
    n = max(int(samples), 2)
    ys, xs = grid_coords(ctx)
    cy = float(center_y) * (ctx.height - 1)
    cx = float(center_x) * (ctx.width - 1)
    acc = None
    for i in range(n):
        t = 1.0 - float(strength) * (i / (n - 1))
        s = sample_bilinear(input_image, cy + (ys - cy) * t, cx + (xs - cx) * t)
        acc = s if acc is None else acc + s
    return with_alpha(true_divide(acc[:3], n), input_image[3])


# ---- generators -------------------------------------------------------------------


@kernel("checkerboard", images_in=(), doc="Generator: checkerboard test pattern.")
def checkerboard(ctx, *, size=32):
    size = max(int(size), 1)
    ys, xs = grid_coords(ctx)
    v = (((ys // size) + (xs // size)) % 2).to(torch.float32)
    return torch.cat([v[None].expand(3, -1, -1), torch.ones_like(v)[None]], dim=0)


@kernel("solid", images_in=(), doc="Generator: constant color.")
def solid(ctx, *, red=0.0, green=0.0, blue=0.0, alpha=1.0):
    shape = (ctx.height, ctx.width)
    return torch.stack([torch.full(shape, c, dtype=torch.float32, device=ctx.device)
                        for c in (red, green, blue, alpha)], dim=0)
