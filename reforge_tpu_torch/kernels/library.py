"""Builtin kernels of the main path (the port of
``reforge_tpu/kernels/library.py``, the subset the flagship graph and the
default config use).

Every form of each builtin is ported: ``fn``, ``conv_weights``,
``conv_epilogue`` and ``conv_epilogue_cw``, ``cw_fn``, ``cw_coord_plane``
and ``cw_plane_fn``.  Each channel-local form also has a ``cw_op``, its
device form in the graph_strip kernel's op list (cuda_ops.OP_*).  The
other builtins of the reference library are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from . import cuda_ops as co
from .base import kernel, register_kernel
from .ops import gaussian_blur, gaussian_radius, gaussian_weights, grid_coords, map_rgb, smoothstep


# ---- identity -----------------------------------------------------------


@kernel("passthrough", doc="Identity copy (reference: shaders/passthrough.comp).")
def passthrough(ctx, input_image):
    return input_image


passthrough.cw_fn = lambda ctx, ci, ins, p: ins["input_image"]
passthrough.cw_op = lambda p, plane: (co.OP_COPY, ())


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


# ---- multi-input ---------------------------------------------------------


@kernel("mix")
def mix(ctx, input_image, input_image2, *, factor=0.5):
    return input_image + (input_image2 - input_image) * factor


mix.cw_fn = lambda ctx, ci, ins, p: (
    ins["input_image"] + (ins["input_image2"] - ins["input_image"]) * p["factor"]
)
mix.cw_op = lambda p, plane: (co.OP_MIX, (p["factor"],))

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
