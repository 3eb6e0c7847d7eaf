"""Separable-conv synthesis for GLSL tap-sum shaders (the port of
``reforge_tpu/glsl/affine.py``).

The mc kernel's conv and stencil stages need a tap plan; builtins declare
theirs, but a user GLSL shader is an opaque program.  This module recovers
the plan by probing the shader as a black box, through the port's own
interpreter on CPU tensors:

  1. The halo reflection has already proven every image access is a static
     shift with radius ``r``, so the shader's support is bounded by the
     (2r+1)^2 window.
  2. The zero image gives the affine offset ``b``; four per-channel unit
     impulses at an interior pixel give the impulse responses; a shifted
     impulse checks shift invariance; a second time value checks time
     independence.
  3. Each channel's response decomposes as  s_c * B + p_c * delta  (the
     alpha-passthrough idiom ``vec4(acc / total, imageLoad(in, pos).a)``).
  4. B factors into separable (wh, ww) taps by SVD, else stays a 2-D
     stencil (sharpen-style Laplacians).
  5. The model  out_c = s_c * conv(x_c) + p_c * x_c + b_c  is verified
     against the shader on random images at two extents and two times.

Results are cached in memory and on disk under the checkout's ignored
``build/reforge_tpu_torch/convsynth/`` (one JSON file per shader source,
parameters and version), apart from the JAX package's cache.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..utils import warnln

# Probe tolerances (the reference's): the synthesized model reassociates
# the shader's f32 tap sums.
_VERIFY_ATOL = 3e-5
_VERIFY_RTOL = 1e-4
_DECOMP_ATOL = 1e-5

MAX_SYNTH_RADIUS = 64

_SYNTH_CACHE: dict[tuple, Any] = {}
_SYNTH_CACHE_MAX = 256
CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "reforge_tpu_torch" / "convsynth"
_DISK_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ConvSynth:
    """A GLSL shader's recovered separable-conv structure."""

    wh: tuple[float, ...]  # vertical taps (odd length, centered)
    ww: tuple[float, ...]  # horizontal taps
    scale: tuple[float, float, float, float]  # s_c: blur term per channel
    passthrough: tuple[float, float, float, float]  # p_c: center-input term
    offset: tuple[float, float, float, float]  # b_c: affine offset
    # Image-border convention of the shader's taps: "edge" (clamp idiom)
    # or "zero" (naive unclamped imageLoad, GL robust-access OOB zeros).
    # The mc kernel pads whole-plan, so stages of one plan must agree.
    border: str = "edge"

    @property
    def identity(self) -> bool:
        return (
            all(s == 1.0 for s in self.scale)
            and all(p == 0.0 for p in self.passthrough)
            and all(b == 0.0 for b in self.offset)
        )

    @property
    def needs_x(self) -> bool:
        return any(p != 0.0 for p in self.passthrough)


@dataclasses.dataclass(frozen=True)
class StencilSynth:
    """A non-separable affine tap-sum (sharpen/emboss-style Laplacians):
    runs as an mc STENCIL stage — out_c = s_c * sum(W * taps) + p_c * x_c
    + b_c."""

    w: tuple[tuple[float, ...], ...]  # (2r+1, 2r+1) kernel
    scale: tuple[float, float, float, float]
    passthrough: tuple[float, float, float, float]
    offset: tuple[float, float, float, float]
    border: str = "edge"  # see ConvSynth.border

    @property
    def radius(self) -> int:
        return (len(self.w) - 1) // 2


def _snap(v: float, *targets: float, tol: float = 1e-9) -> float:
    """Collapse float-probe dust onto exact constants (0.0, 1.0)."""
    for t in targets:
        if abs(v - t) <= tol:
            return t
    return float(v)


def compose(a: ConvSynth, b: ConvSynth) -> Optional[ConvSynth]:
    """The single ConvSynth computing ``b(a(x))``, or None.

    The separable-pass chain idiom (``gaussian_h.comp -> gaussian_v.comp``)
    ships the two 1-D passes as separate nodes; composed they are ONE
    separable conv — kernel = convolution of the tap vectors — which
    turns an extent-carrying conv pair into a single zero-extent stage
    (the shape the 4K mc gate admits).  Edge-clamp borders compose
    exactly: per-axis clamping is independent of the other pass, so
    V(H(x))[y,x] = sum wh[i] ww[j] x[clamp(y+i), clamp(x+j)] in either
    order.

    Per channel the pair must be conv-then-conv, passthrough-then-
    passthrough, or constant-then-anything; a mixed channel (e.g. A
    passes a channel that B convolves) needs two distinct kernels and
    cannot ride one stage.
    """
    if a.border != "edge" or b.border != "edge":
        # Zero-border pairs do NOT compose: B's OOB reads of A's STORED
        # output are zeros, while the composed kernel would convolve
        # through A's virtual out-of-image values (which its taps reach
        # back inside for).  Edge clamp has no such virtual values — the
        # clamped index is always a stored pixel.
        return None
    # Exactness requires that, PER AXIS, at most one factor carries taps:
    # two vertical passes chained (gaussian_v -> gaussian_v) clamp the
    # FIRST pass's output rows at the border, which a single conv with
    # the convolved kernel does not reproduce (3-tap box twice on
    # x=[3,0,0,..]: chained gives 5/3 at the edge, composed 2.0).  The
    # h->v pair — the idiom this exists for — always passes.
    if len(a.wh) > 1 and len(b.wh) > 1:
        return None
    if len(a.ww) > 1 and len(b.ww) > 1:
        return None
    sum_b = float(np.sum(b.wh) * np.sum(b.ww))
    scale, passthrough, offset = [], [], []
    any_conv = False
    for c in range(4):
        sa, pa, ba = a.scale[c], a.passthrough[c], a.offset[c]
        sb, pb, bb = b.scale[c], b.passthrough[c], b.offset[c]
        if sa == 0.0 and pa == 0.0:
            # A emits the constant ba on this channel.
            scale.append(0.0)
            passthrough.append(0.0)
            offset.append(sb * ba * sum_b + pb * ba + bb)
        elif pa == 0.0 and pb == 0.0:
            any_conv = True
            scale.append(sa * sb)
            passthrough.append(0.0)
            offset.append(sb * ba * sum_b + bb)
        elif sa == 0.0 and sb == 0.0:
            scale.append(0.0)
            passthrough.append(pa * pb)
            offset.append(pb * ba + bb)
        else:
            return None
    if not any_conv:
        return None
    wh = np.convolve(np.asarray(a.wh, np.float64), np.asarray(b.wh, np.float64))
    ww = np.convolve(np.asarray(a.ww, np.float64), np.asarray(b.ww, np.float64))
    return ConvSynth(
        wh=tuple(float(v) for v in wh),
        ww=tuple(float(v) for v in ww),
        scale=tuple(scale),
        passthrough=tuple(passthrough),
        offset=tuple(offset),
        border=a.border,
    )


def _trim_taps(w: np.ndarray) -> np.ndarray:
    """Strip symmetric all-but-zero edge taps, keeping the center fixed."""
    w = np.asarray(w, np.float64)
    tol = 1e-9 * max(float(np.abs(w).max()), 1.0)
    while len(w) > 1 and abs(w[0]) <= tol and abs(w[-1]) <= tol:
        w = w[1:-1]
    return w


def synthesize_conv(spec, params: Mapping[str, Any]):
    """A GLSL kernel's ConvSynth or StencilSynth for these params, or None
    when the shader is not an affine tap-sum.  Cached by (source hash,
    params) in memory and on disk."""
    params_key = tuple(sorted(params.items()))
    key = (spec.source_hash or id(spec), params_key)
    if key in _SYNTH_CACHE:
        return _SYNTH_CACHE[key]
    if len(_SYNTH_CACHE) >= _SYNTH_CACHE_MAX:
        _SYNTH_CACHE.clear()
    got, hit = _disk_load(spec, params_key)
    if not hit:
        try:
            got = _synthesize(spec, params)
        except Exception as e:  # a probe failure is a planner miss, not an error
            warnln(f"conv synthesis for '{spec.name}' failed: {e}")
            got = None
        else:
            _disk_store(spec, params_key, got)
    _SYNTH_CACHE[key] = got
    return got


def _disk_path(spec, params_key) -> Optional[Path]:
    if spec.source_hash is None:
        return None
    raw = repr((spec.source_hash, params_key, _DISK_VERSION))
    return CACHE_DIR / (hashlib.sha256(raw.encode()).hexdigest() + ".json")


def _disk_load(spec, params_key) -> tuple[Any, bool]:
    path = _disk_path(spec, params_key)
    if path is None or not path.exists():
        return None, False
    try:
        d = json.loads(path.read_text())
        if d is None:
            return None, True  # cached rejection
        common = dict(scale=tuple(d["scale"]), passthrough=tuple(d["passthrough"]),
                      offset=tuple(d["offset"]), border=d["border"])
        if d["kind"] == "conv":
            return ConvSynth(wh=tuple(d["wh"]), ww=tuple(d["ww"]), **common), True
        return StencilSynth(w=tuple(tuple(r) for r in d["w"]), **common), True
    except (OSError, ValueError, KeyError, TypeError):
        return None, False  # unreadable entry: probe again


def _disk_store(spec, params_key, got) -> None:
    path = _disk_path(spec, params_key)
    if path is None:
        return
    if got is None:
        d = None
    else:
        d = dict(kind="conv" if isinstance(got, ConvSynth) else "stencil",
                 **dataclasses.asdict(got))
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(d))
        os.replace(tmp, path)
    except OSError as e:  # the disk cache only saves probes
        warnln(f"conv synthesis cache not written ({path}): {e}")


def _impulse(zero: np.ndarray, c: int, y: int, x: int) -> np.ndarray:
    out = zero.copy()
    out[c, y, x] = 1.0
    return out


def _shifted(xp: np.ndarray, dy: int, dx: int, h: int, w: int) -> np.ndarray:
    return xp[:, dy : dy + h, dx : dx + w]


def _synthesize(spec, params: Mapping[str, Any]):
    from ..kernels.base import KernelContext

    r = spec.halo_for(params)
    if r is None or not (1 <= r <= MAX_SYNTH_RADIUS):
        return None
    border = spec.border_for(params)
    if border not in ("edge", "zero"):
        return None
    if len(spec.images_in) != 1 or len(spec.images_out) != 1:
        return None
    if spec.ssbos_in or spec.ssbos_out:
        return None

    in_name = spec.images_in[0]
    out_name = spec.images_out[0]
    ha, wa = 4 * r + 8, 4 * r + 16  # primary probe extent
    hb, wb = 4 * r + 16, 4 * r + 8  # second extent (size-dependence seal)
    cy, cx = ha // 2, wa // 2

    def make_f(h, w):
        def f(x: np.ndarray, t: float) -> np.ndarray:
            ctx = KernelContext(width=w, height=h, time=t, device="cpu")
            out = spec(ctx, {in_name: torch.from_numpy(np.ascontiguousarray(x))}, dict(params))
            return out[out_name].numpy()

        return f

    f_a = make_f(ha, wa)
    f_b = make_f(hb, wb)
    t1, t2 = 0.37, 1.91

    zero = np.zeros((4, ha, wa), np.float32)
    b_img = f_a(zero, t1)
    if not np.allclose(b_img, f_a(zero, t2), atol=0.0):
        return None  # time-dependent
    b = b_img[:, cy, cx]
    if not np.allclose(b_img, b[:, None, None], atol=1e-7):
        return None  # coordinate-dependent affine offset

    # Per-channel impulse responses.
    resp = []
    for c in range(4):
        imp = _impulse(zero, c, cy, cx)
        rc = f_a(imp, t1) - b_img
        resp.append(rc)
    # Channel mixing (luma kernels etc.): not representable.
    for c in range(4):
        for d in range(4):
            if d != c and np.abs(resp[c][d]).max() > _DECOMP_ATOL:
                return None
    # The response of OUTPUT pixels to an impulse at the center is the
    # tap kernel REVERSED (out[p] = sum_j w_j x[p+j], so the impulse
    # at c contributes w_{c-p} at p): flip both axes to recover w
    # itself.  Symmetric kernels (gaussians) hide this; asymmetric
    # ones (directional blurs) would render mirrored without it —
    # caught by the synthesis fuzz suite.
    wins = [
        resp[c][c, cy - r : cy + r + 1, cx - r : cx + r + 1][
            ::-1, ::-1
        ].astype(np.float64)
        for c in range(4)
    ]
    # Support must live inside the window (guaranteed by the halo
    # bound; assert against reflection bugs).
    for c in range(4):
        outside = resp[c][c].copy()
        outside[cy - r : cy + r + 1, cx - r : cx + r + 1] = 0.0
        if np.abs(outside).max() > _DECOMP_ATOL:
            return None

    # Shift invariance: impulse at (cy+1, cx+2) must reproduce the
    # same window translated.
    imp_s = _impulse(zero, 0, cy + 1, cx + 2)
    rs = f_a(imp_s, t1) - b_img
    win_s = rs[
        0, cy + 1 - r : cy + 1 + r + 1, cx + 2 - r : cx + 2 + r + 1
    ][::-1, ::-1]
    if not np.allclose(win_s, wins[0], atol=_DECOMP_ATOL):
        return None

    # Decompose W_c = s_c * B + p_c * delta, with B the widest
    # channel kernel (convention: that channel has s=1, p=0 — the
    # delta split is not unique, so fold the center into B).
    delta = np.zeros((2 * r + 1, 2 * r + 1))
    delta[r, r] = 1.0
    off_center = [
        float(np.abs(w - w[r, r] * delta).sum()) for w in wins
    ]
    ref = int(np.argmax(off_center))
    if off_center[ref] < 1e-7:
        return None  # effectively pointwise; not a conv
    B = wins[ref]
    A = np.stack([B.ravel(), delta.ravel()], axis=1)  # (n, 2)
    scale = [0.0] * 4
    passthrough = [0.0] * 4
    for c in range(4):
        coef, *_ = np.linalg.lstsq(A, wins[c].ravel(), rcond=None)
        res = A @ coef - wins[c].ravel()
        if np.abs(res).max() > _DECOMP_ATOL:
            return None
        scale[c] = _snap(float(coef[0]), 0.0, 1.0)
        passthrough[c] = _snap(float(coef[1]), 0.0, 1.0)
    scale[ref], passthrough[ref] = 1.0, 0.0
    b = [_snap(float(v), 0.0, 1.0, tol=1e-7) for v in b]

    # Separability: rank-1 B factors into (wh, ww) tap vectors and
    # runs as a conv stage; otherwise a small-radius kernel runs as
    # a stencil stage (sharpen/emboss-style Laplacians).
    u, s, vt = np.linalg.svd(B)
    separable = len(s) == 1 or s[1] <= 1e-6 * max(s[0], 1e-12)
    if separable:
        wh = u[:, 0] * np.sqrt(s[0])
        ww = vt[0, :] * np.sqrt(s[0])
        if wh.sum() < 0:  # fix the sign split
            wh, ww = -wh, -ww
        wh, ww = _trim_taps(wh), _trim_taps(ww)
        synth: Any = ConvSynth(
            wh=tuple(float(v) for v in wh),
            ww=tuple(float(v) for v in ww),
            scale=tuple(scale),
            passthrough=tuple(passthrough),
            offset=tuple(b),
            border=border,
        )
    else:
        if r > 16:  # planner's stencil-radius cap
            return None
        synth = StencilSynth(
            w=tuple(tuple(float(v) for v in row) for row in B),
            scale=tuple(scale),
            passthrough=tuple(passthrough),
            offset=tuple(b),
            border=border,
        )


    # Full-function verification: random images, two extents, two times.
    # Model and shader are both affine in x, so agreement on random x
    # decides equality (up to f32 reassociation).
    pad_mode = "edge" if border == "edge" else "constant"

    def model(x, h, w):
        if separable:
            rh, rw = len(wh) // 2, len(ww) // 2
            xp = np.pad(x, ((0, 0), (rh, rh), (0, 0)), mode=pad_mode)
            acc = np.zeros_like(x)
            for i, wv in enumerate(wh):
                acc = acc + np.float32(wv) * _shifted(xp, i, 0, h, w)
            accp = np.pad(acc, ((0, 0), (0, 0), (rw, rw)), mode=pad_mode)
            out = np.zeros_like(x)
            for j, wv in enumerate(ww):
                out = out + np.float32(wv) * _shifted(accp, 0, j, h, w)
        else:
            xp = np.pad(x, ((0, 0), (r, r), (r, r)), mode=pad_mode)
            out = np.zeros_like(x)
            for dy in range(2 * r + 1):
                for dx in range(2 * r + 1):
                    wv = B[dy, dx]
                    if wv == 0.0:
                        continue
                    out = out + np.float32(wv) * _shifted(xp, dy, dx, h, w)
        sc = np.asarray(scale, np.float32)[:, None, None]
        pc = np.asarray(passthrough, np.float32)[:, None, None]
        bc = np.asarray(b, np.float32)[:, None, None]
        return sc * out + pc * x + bc

    rng = np.random.default_rng(0xC0FFEE)
    for (h, w), f in (((ha, wa), f_a), ((hb, wb), f_b)):
        x = rng.random((4, h, w), dtype=np.float32)
        want_1 = f(x, t1)
        if not np.allclose(want_1, f(x, t2), atol=0.0):
            return None
        if not np.allclose(model(x, h, w), want_1, atol=_VERIFY_ATOL, rtol=_VERIFY_RTOL):
            return None
    return synth
