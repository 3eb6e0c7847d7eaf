"""Plain reference of crt_tv_4k (graph.rf, shaders/crt.frag).

Written from the definitions the graph names:

* fade, ``hue_saturation``: the hue-rotation matrix of the W3C filter
  effects' ``hueRotate`` at ``hue`` degrees on rgb, then
  ``y + (rgb - y) * saturation + lightness``, y the Rec.709 luma (0.2126,
  0.7152, 0.0722) of the rotated rgb; alpha kept.
* soften, ``gaussian``: clamp-to-edge separable taps exp(-d^2 / 2 sigma^2)
  over d = -r..r, r = ceil(3 sigma) (at least 1, at most 96), all four
  channels.
* crt, ``crt.frag`` as a full-screen fragment pass: ``uv`` is
  ``(i + 0.5) / size``, ``gl_FragCoord.y`` is ``y + 0.5``; barrel warp,
  ``texture()`` of the soften output at the warped point, black outside
  the tube, scanlines, vignette, alpha 1.

Departures from the published source, each on purpose:

* The shader's geometry is computed in float32, in the source's order,
  each operation rounded on its own (no contraction): ``uv``, ``centered``,
  ``warped``, ``suv``, the clamp, ``inside``, the texel coordinate
  ``suv * size - 0.5``, its floor and the bilinear weights.  GLSL's
  ``float`` is binary32, so this is the shader's own arithmetic; the tube's
  edge (``step(|warped|, 1)``) and the sampler's cell boundaries are
  decided by it, and a float64 geometry would move pixels across them.
  Every colour value, the scanline and the vignette are float64.
* ``texture()`` follows the project's sampler contract, not GL's
  clamp-to-edge: bilinear, the cell from the floor of the texel
  coordinate, ``x1`` and ``y1`` taken from the clamped ``x0`` and ``y0``
  and the weights from the unclamped floor, so a sample inside the first
  column's or row's outer half texel blends texel 0 with texel 1 where
  clamp-to-edge reads texel 0.
"""

from __future__ import annotations

import math

import torch

from perfbench import refmath

F32 = torch.float32
F64 = refmath.F64


def _hue_matrix(degrees: float) -> list[list[float]]:
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    return [
        [0.213 + c * 0.787 - s * 0.213, 0.715 - c * 0.715 - s * 0.715, 0.072 - c * 0.072 + s * 0.928],
        [0.213 - c * 0.213 + s * 0.143, 0.715 + c * 0.285 + s * 0.140, 0.072 - c * 0.072 - s * 0.283],
        [0.213 - c * 0.213 - s * 0.787, 0.715 - c * 0.715 + s * 0.715, 0.072 + c * 0.928 + s * 0.072],
    ]


def _fade(rgb: torch.Tensor, p: dict) -> torch.Tensor:
    m = _hue_matrix(p.get("hue", 0.0))
    rot = torch.stack([rgb[0] * row[0] + rgb[1] * row[1] + rgb[2] * row[2] for row in m])
    y = rot[0] * 0.2126 + rot[1] * 0.7152 + rot[2] * 0.0722
    return y + (rot - y) * p["saturation"] + p["lightness"]


def _radius(sigma: float) -> int:
    return int(min(96, max(1, math.ceil(3.0 * sigma))))


def geometry(h: int, w: int, curvature: float, device=None) -> dict:
    """crt.frag's geometry at h x w, in float32: ``centered`` (x, y),
    ``inside`` (bool), the texel coordinates ``tx``/``ty`` (``suv * size -
    0.5``), the cells' corners ``x0``, ``x1``, ``y0``, ``y1`` (int64) and
    the weights ``wx``/``wy``.  Planes broadcast to (h, w)."""
    k = torch.tensor(0.12 if curvature <= 0.0 else curvature, dtype=F32, device=device)
    ux = (torch.arange(w, dtype=F32, device=device) + 0.5) / torch.tensor(float(w), dtype=F32,
                                                                          device=device)
    uy = (torch.arange(h, dtype=F32, device=device) + 0.5) / torch.tensor(float(h), dtype=F32,
                                                                          device=device)
    cx = (ux * 2.0 - 1.0)[None, :]
    cy = (uy * 2.0 - 1.0)[:, None]
    scale = 1.0 + k * (cx * cx + cy * cy)
    warped_x, warped_y = cx * scale, cy * scale
    zero = torch.tensor(0.0, dtype=F32, device=device)
    one = torch.tensor(1.0, dtype=F32, device=device)
    suv_x = torch.minimum(torch.maximum(warped_x * 0.5 + 0.5, zero), one)
    suv_y = torch.minimum(torch.maximum(warped_y * 0.5 + 0.5, zero), one)
    # step(|warped|, 1.0): 0 where 1.0 < |warped|.
    inside = ~(one < warped_x.abs()) & ~(one < warped_y.abs())
    tx = suv_x * float(w) - 0.5
    ty = suv_y * float(h) - 0.5
    fx, fy = torch.floor(tx), torch.floor(ty)
    x0 = fx.to(torch.int64).clamp(0, w - 1)
    y0 = fy.to(torch.int64).clamp(0, h - 1)
    return {"centered": (cx, cy), "inside": inside, "tx": tx, "ty": ty,
            "x0": x0, "x1": (x0 + 1).clamp(0, w - 1), "y0": y0, "y1": (y0 + 1).clamp(0, h - 1),
            "wx": tx - fx, "wy": ty - fy}


def frame(u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The (4, H, W) float64 output for the (H, W, 4) uint8 input."""
    p = cfg["params"]
    x = refmath.decode_srgb_u8(u8)
    x = torch.cat([_fade(x[:3], p["fade"]), x[3:]])
    sigma = p["soften"]["sigma"]
    soft = refmath.separable(x, refmath.gaussian_taps(sigma, _radius(sigma)))
    del x
    h, w = soft.shape[1], soft.shape[2]
    crt = p["crt"]
    g = geometry(h, w, crt["curvature"], soft.device)
    cx, cy = (c.to(F64) for c in g["centered"])
    wx, wy = g["wx"].to(F64), g["wy"].to(F64)
    dark = 0.25 if crt["scan_darkness"] <= 0.0 else crt["scan_darkness"]
    rows = torch.arange(h, dtype=F64, device=soft.device)[:, None]
    f = (rows + 0.5) * 0.5
    line = 1.0 - dark * ((f - torch.floor(f)) >= 0.5).to(F64)
    vig = 1.0 - 0.4 * (cx * cx + cy * cy)
    fade = g["inside"].to(F64) * line * vig
    i00, i01 = g["y0"] * w + g["x0"], g["y0"] * w + g["x1"]
    i10, i11 = g["y1"] * w + g["x0"], g["y1"] * w + g["x1"]
    out = []
    for plane in soft[:3].reshape(3, -1):
        p00, p01, p10, p11 = plane[i00], plane[i01], plane[i10], plane[i11]
        top = p00 + (p01 - p00) * wx
        bot = p10 + (p11 - p10) * wx
        out.append((top + (bot - top) * wy) * fade)
    out.append(torch.ones((h, w), dtype=F64, device=soft.device))
    return torch.stack(out)
