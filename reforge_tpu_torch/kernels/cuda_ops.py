"""Hand-written Hopper kernels for the port's main paths, their plain
PyTorch versions, launch counters and the build loader.

Each wrapper takes its kernel's plain version when the tensor it is given
lies on the CPU (or on the ``meta`` device, which the program uses to
check shapes) and launches its CUDA kernel when the tensor lies on a GPU.
There is no fallback from one to the other: a kernel that cannot launch
raises.

Kernels (sources in ``reforge_tpu_torch/csrc/``, each compiled for
``sm_90a`` by its own nvcc at first use, linked into one shared library
and bound with ctypes):

  * ``sep_conv_multi`` (sep_conv.cu) serves four entry points:
    ``sep_conv_fused``, ``sep_conv_fused_multi``, ``sep_conv_fused_mxu``
    and ``sep_conv_fused_mxu_x3`` (heavy f32 convs).
  * ``graph_strip`` (graph_strip.cu): the single-tier whole-graph kernel.
  * ``stencil_apply`` (stencil.cu): a per-channel neighbourhood function
    (weighted sum of a tap table, median of 3x3) for the per-node tier.
  * ``graph_strip_mc`` (graph_strip_mc.cu): the mc tier's multi-stage
    all-channel megakernel (conv, stencil and point stages).
  * ``stencil_reduce`` (stencil_reduce.cu): a windowed all-channel
    weighted reduction plus a final map (bilateral) for the per-node
    tier.
  * ``conv1d`` (conv1d.cu) serves ``conv1d_h`` and ``conv1d_w``: the 1-D
    passes of a separable conv whose window fits no shared-memory tile
    of the fused kernels (large-radius box blurs and kuwahara).
  * ``stencil_apply_mc`` (stencil_mc.cu): a cross-channel linear stencil,
    (C_in, H, W) to (C_out, H, W), from a tap table.

The conv kernels read each input pixel of a tile once (plus its halo) and
write each output once, and spend 2R+1 multiply-adds per pass per pixel
per conv from shared memory.  At the main path's radii the tap loops,
not device memory, bound them (each wrapper notes its time): there is no
tensor-core, TMA or register-blocking work in them yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .base import KernelContext, quantize_rgba8, true_divide

# ---- build and bind ---------------------------------------------------------

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/reforge_tpu_torch, found from this file (never the CWD).
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "reforge_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc per source, all started
    together) and link them into one shared library, keyed on a hash of
    the sources and flags, unless that library exists already.  The
    compilers' output (ptxas register and spill counts) goes to
    ``build.log`` beside it."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    key = digest.hexdigest()[:16]
    target = BUILD_DIR / f"librf_kernels_{key}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    nvcc = _nvcc()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)
    ]
    log, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(partial), *map(str, objs)],
                              capture_output=True, text=True)
        log.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n" + "\n".join(log))
    os.replace(partial, target)
    return target


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernels, with every argument type
    declared so that pointers keep their 64 bits."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.rf_sep_conv_multi.argtypes = [
            _I, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
        ]
        lib.rf_sep_conv_multi.restype = _I
        lib.rf_graph_strip.argtypes = [
            _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
            _P, _P, _I, _I, _I, _F, _I, _P,
        ]
        lib.rf_graph_strip.restype = _I
        lib.rf_stencil_apply.argtypes = [
            _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P,
        ]
        lib.rf_stencil_apply.restype = _I
        lib.rf_graph_strip_mc.argtypes = [
            _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _I, _I, _F, _I, _P,
        ]
        lib.rf_graph_strip_mc.restype = _I
        lib.rf_stencil_reduce.argtypes = [
            _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _F, _I, _P,
        ]
        lib.rf_stencil_reduce.restype = _I
        lib.rf_conv1d.argtypes = [_I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P]
        lib.rf_conv1d.restype = _I
        lib.rf_stencil_apply_mc.argtypes = [
            _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P,
        ]
        lib.rf_stencil_apply_mc.restype = _I
        lib.rf_mc_limits.argtypes = [_I]
        lib.rf_mc_limits.restype = _I
        lib.rf_error_string.argtypes = [_I]
        lib.rf_error_string.restype = ctypes.c_char_p
        lib.rf_max_slots.argtypes = []
        lib.rf_max_slots.restype = _I
        _lib = lib
    return _lib


def _check_launch(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.rf_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {rc})")


# ---- launch counters ----------------------------------------------------------

# Kernel launches per wrapper; each wrapper adds one where it launches its
# kernel and nowhere else.
LAUNCHES: dict[str, int] = {
    "sep_conv_fused": 0,
    "sep_conv_fused_multi": 0,
    "sep_conv_fused_mxu": 0,
    "graph_strip": 0,
    "sep_conv_fused_mxu_x3": 0,
    "stencil_apply": 0,
    "graph_strip_mc": 0,
    "stencil_reduce_mc": 0,
    "conv1d_h": 0,
    "conv1d_w": 0,
    "stencil_apply_mc": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- shared helpers -------------------------------------------------------------

# Dynamic shared memory one block may use on sm_90 (227 KB).
SMEM_LIMIT = 232448
# Preferred footprint: small enough for several blocks per SM.
SMEM_SOFT = 64 * 1024
# Output tiles (rows, cols), largest first.  Each must fit the footprint
# of its window, H-pass buffer, taps and any per-pixel extras.
TILES = ((32, 128), (32, 64), (16, 64), (16, 32), (8, 32))
# Per-pixel value slots of the graph_strip epilogue (csrc kMaxSlots).
MAX_SLOTS = 32


def _on_cuda(x: torch.Tensor) -> bool:
    """True when ``x`` is for the kernel, False for the plain version."""
    if x.is_cuda:
        return True
    if x.device.type in ("cpu", "meta"):
        return False
    raise RuntimeError(f"no kernel for tensors on {x.device}")


def _check_image(x: torch.Tensor, dtypes: tuple, name: str) -> None:
    if x.dim() != 3:
        raise ValueError(f"{name}: expected a (C, H, W) tensor, got shape {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not in {dtypes}")
    if x.is_cuda and not x.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")


def _check_mode(mode: str) -> None:
    if mode not in ("edge", "zero"):
        raise ValueError(f"border mode must be 'edge' or 'zero', not {mode!r}")


def _as_plans(plans: Sequence) -> list[tuple[np.ndarray, np.ndarray]]:
    out = []
    for wh, ww in plans:
        wh = np.asarray(wh, np.float32)
        ww = np.asarray(ww, np.float32)
        if wh.ndim != 1 or ww.ndim != 1 or len(wh) % 2 == 0 or len(ww) % 2 == 0:
            raise ValueError("tap vectors must be 1-D with odd length")
        out.append((wh, ww))
    if not out:
        raise ValueError("at least one (wh, ww) plan is needed")
    return out


def _radii(plans) -> tuple[int, int]:
    return (
        max((len(wh) - 1) // 2 for wh, _ in plans),
        max((len(ww) - 1) // 2 for _, ww in plans),
    )


@functools.lru_cache(maxsize=64)
def _device_taps(key: tuple, device: torch.device):
    """(taps f32, meta int32) on ``device`` for plans given as a key of tap
    bytes; cached so a frame loop uploads its taps once."""
    vecs = [np.frombuffer(b, np.float32) for b in key]
    taps, meta, off = [], [], 0
    for wh, ww in zip(vecs[0::2], vecs[1::2]):
        meta += [(len(wh) - 1) // 2, (len(ww) - 1) // 2, off, off + len(wh)]
        taps += [wh, ww]
        off += len(wh) + len(ww)
    taps_t = torch.from_numpy(np.concatenate(taps)).to(device)
    meta_t = torch.tensor(meta, dtype=torch.int32).to(device)
    return taps_t, meta_t


def _taps_for(plans, device):
    key = tuple(v.tobytes() for plan in plans for v in plan)
    return _device_taps(key, device)


def choose_tile(rh: int, rw: int, n_taps: int, extra_per_pixel: int = 0) -> Optional[tuple[int, int, int]]:
    """(TH, TW, shared-memory bytes) for a conv window of radii (rh, rw):
    the largest tile under SMEM_SOFT, else under SMEM_LIMIT, else None.
    The footprint is the layout of csrc/conv_tile.cuh (window, H-pass
    buffer, taps) plus ``extra_per_pixel`` floats per output pixel."""
    for budget in (SMEM_SOFT, SMEM_LIMIT):
        for th, tw in TILES:
            floats = (th + 2 * rh) * (tw + 2 * rw) + th * (tw + 2 * rw) + n_taps
            nbytes = 4 * (floats + extra_per_pixel * th * tw)
            if nbytes <= budget:
                return th, tw, nbytes
    return None


def pick_tile(rh: int, rw: int, n_taps: int, extra_per_pixel: int = 0) -> tuple[int, int, int]:
    """choose_tile, raising when no tile fits.  Callers check first:
    ``ops.sep_conv`` sends a conv that fits no tile to the 1-D kernels,
    and the planners and conv bundles check ``plans_fit``."""
    tile = choose_tile(rh, rw, n_taps, extra_per_pixel)
    if tile is None:
        raise ValueError(f"no tile fits shared memory for radii ({rh}, {rw})")
    return tile


def plans_fit(plans: Sequence, extra_per_pixel: int = 0) -> bool:
    """Whether the conv kernels can take ``plans`` in one launch."""
    plans = _as_plans(plans)
    n_taps = sum(len(wh) + len(ww) for wh, ww in plans)
    return choose_tile(*_radii(plans), n_taps, extra_per_pixel) is not None


# ---- plain versions -------------------------------------------------------------


def correlate1d(x: torch.Tensor, weights: np.ndarray, dim: int, mode: str = "edge") -> torch.Tensor:
    """1-D correlation along ``dim`` with clamped-index (edge) or zero
    borders, as unrolled shifted adds in f32 in the order of
    ``reforge_tpu.kernels.ops.conv1d`` (zero taps skipped).  Never
    ``F.conv2d``, which cuDNN would run in TF32."""
    weights = np.asarray(weights, np.float32)
    r = (len(weights) - 1) // 2
    if r == 0:
        return x * float(weights[0])
    dim = dim % x.dim()
    n = x.shape[dim]
    if mode == "edge":
        idx = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
        xp = x.index_select(dim, idx)
    else:
        pad_shape = list(x.shape)
        pad_shape[dim] = r
        zeros = x.new_zeros(pad_shape)
        xp = torch.cat([zeros, x, zeros], dim=dim)
    acc = None
    for i, w in enumerate(weights):
        if w == 0.0:
            continue
        tap = xp.narrow(dim, i, n)
        acc = tap * float(w) if acc is None else acc + tap * float(w)
    return acc if acc is not None else torch.zeros_like(x)


def sep_conv_plain(x: torch.Tensor, plans: Sequence, mode: str = "edge") -> list[torch.Tensor]:
    """The plain version of ``sep_conv_multi``: for each (wh, ww) plan the
    H pass then the W pass, in f32 whatever the input type."""
    _check_mode(mode)
    xf = x.to(torch.float32)
    return [
        correlate1d(correlate1d(xf, wh, -2, mode), ww, -1, mode)
        for wh, ww in _as_plans(plans)
    ]


# ---- kernel A: sep_conv_multi -----------------------------------------------------


def _launch_sep_conv(x: torch.Tensor, plans, mode: str) -> list[torch.Tensor]:
    lib = load_library()
    taps, meta = _taps_for(plans, x.device)
    rh, rw = _radii(plans)
    th, tw, smem = pick_tile(rh, rw, taps.numel())
    c, h, w = x.shape
    out = torch.empty((len(plans), c, h, w), dtype=torch.float32, device=x.device)
    rc = lib.rf_sep_conv_multi(
        int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(), c, h, w,
        taps.data_ptr(), meta.data_ptr(), len(plans), taps.numel(), rh, rw,
        int(mode == "zero"), th, tw, smem, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, rc, "sep_conv_multi")
    return list(out.unbind(0))


def sep_conv_fused(x: torch.Tensor, wh, ww, mode: str = "edge") -> torch.Tensor:
    """One separable conv of an f32 (C, H, W) image, both passes in one
    kernel.

    Replaces ``pallas_ops.sep_conv_fused`` (pallas_ops.py:1723).  The TPU
    kernel streamed whole-width strips through VMEM with in-kernel halo
    padding; here a 2-D tile and its halo load once into shared memory
    with clamped (or zero-filled) reads, and both passes run from there.

    Bound on the card: the tap loops' shared-memory loads, one per FMA
    (about 55 per pixel at radius 12).  Device memory is read and written
    once; 0.61 ms at 4K f32 radius 12 against 0.08 ms to move its 264 MB
    (H100 80GB HBM3, 700 W).
    """
    _check_image(x, (torch.float32,), "sep_conv_fused")
    _check_mode(mode)
    plans = _as_plans([(wh, ww)])
    if not _on_cuda(x):
        return sep_conv_plain(x, plans, mode)[0]
    out = _launch_sep_conv(x, plans, mode)[0]
    LAUNCHES["sep_conv_fused"] += 1
    return out


def sep_conv_fused_multi(x: torch.Tensor, plans: Sequence, mode: str = "edge") -> list[torch.Tensor]:
    """N separable convs of one f32 image with one shared load per tile.

    Replaces ``pallas_ops.sep_conv_fused_multi`` (pallas_ops.py:953).  The
    TPU kernel shared one strip DMA across N tap loops; here N convs share
    one shared-memory window, each indexing it at its own radius.

    Bound on the card: the tap loops, once per conv; the shared window
    saves every load but the first.  Radii 6 and 12 at 4K: 0.90 ms, against
    0.61 ms for radius 12 alone (H100 80GB HBM3, 700 W)."""
    _check_image(x, (torch.float32,), "sep_conv_fused_multi")
    _check_mode(mode)
    plans = _as_plans(plans)
    if not _on_cuda(x):
        return sep_conv_plain(x, plans, mode)
    out = _launch_sep_conv(x, plans, mode)
    LAUNCHES["sep_conv_fused_multi"] += 1
    return out


def sep_conv_fused_mxu(x: torch.Tensor, wh, ww, mode: str = "edge") -> torch.Tensor:
    """One separable conv of a bf16-stored image, returned in f32.

    Replaces ``pallas_ops.sep_conv_fused_mxu`` (pallas_ops.py:496), which
    ran both passes as bf16 band matmuls on the TPU's MXU and stored its H
    pass in bf16.  Here the same shared-memory tap kernel reads bf16 and
    accumulates in f32; the caller rounds once, at the node boundary, as
    the f32 reference path does.

    Bound on the card: the same tap loops as in f32; bf16 halves the bytes
    read but not the FMAs, and the time matches f32 (0.61 ms at 4K radius
    12, H100 80GB HBM3, 700 W)."""
    _check_image(x, (torch.bfloat16,), "sep_conv_fused_mxu")
    _check_mode(mode)
    plans = _as_plans([(wh, ww)])
    if not _on_cuda(x):
        return sep_conv_plain(x, plans, mode)[0]
    out = _launch_sep_conv(x, plans, mode)[0]
    LAUNCHES["sep_conv_fused_mxu"] += 1
    return out


def sep_conv_fused_mxu_x3(x: torch.Tensor, wh, ww, mode: str = "edge") -> torch.Tensor:
    """One f32 separable conv of at least ``ops.X3_MIN_TAPS`` combined taps
    (``ops.sep_conv`` routes heavy f32 convs here).

    Replaces ``pallas_ops.sep_conv_fused_mxu_x3`` (pallas_ops.py:739).  The
    TPU's MXU multiplies bf16, so that kernel split each f32 operand into
    three bf16 terms and summed six band-matmul products per pass
    (pallas_ops.py:574-739) to reach f32 accuracy.  Hopper's FP32 FMA
    pipes compute the same function directly: this entry launches the
    ``sep_conv_multi`` kernel as ``sep_conv_fused`` does, with its own
    launch counter so heavy convs show apart from light ones.  The tile
    shrinks with the radius (radius 66 takes a 32x128 tile in 205 KB).

    Bound on the card: the tap loops, 2R+1 FMAs per pass per pixel from
    shared memory; its time at the demo's radius 24 is in PERF.md."""
    _check_image(x, (torch.float32,), "sep_conv_fused_mxu_x3")
    _check_mode(mode)
    plans = _as_plans([(wh, ww)])
    if _radii(plans)[1] > 128:
        raise ValueError("sep_conv_fused_mxu_x3 takes W radii up to 128: ops.sep_conv routes "
                         "wider convs to sep_conv_fused or the 1-D kernels, as the reference does")
    if not _on_cuda(x):
        return sep_conv_plain(x, plans, mode)[0]
    out = _launch_sep_conv(x, plans, mode)[0]
    LAUNCHES["sep_conv_fused_mxu_x3"] += 1
    return out


# ---- kernel B: graph_strip ----------------------------------------------------------

# Opcodes of the graph_strip epilogue (csrc/graph_strip.cu, enum Op).
OP_COPY = 0  # in0
OP_TAKE1 = 1  # in1: a conv node whose output is its blur
OP_UNSHARP = 2  # rgb: in0 + p0 * (in0 - in1)
OP_MIX = 3  # in0 + (in1 - in0) * p0
OP_ACES = 4  # rgb: ACES filmic of in0 * p0
OP_REINHARD = 5  # rgb: Reinhard of in0 * p0
OP_VIGNETTE = 6  # rgb: in0 * radial fade (p0 strength, p1 radius, p2 1.42 - radius)
OP_FADE_PLANE = 7  # rgb: in0 * aux[plane]
# Opcodes OP_CH0 + k: channel op k of CHANNEL_OPS on the rgb channels
# (alpha passes through), in0 the node's input_image, in1 its input_image2.
OP_CH0 = 8
# Float params per graph_strip op (csrc kOpFloats).
STRIP_OP_FLOATS = 8

# Storage rounding after every node (csrc enum Store).
STORE_MODES = {"rgba32f": 0, "rgba16f": 1, "rgba8": 2}


# ---- channel ops (csrc/pixel_ops.cuh, enum ChannelOp) --------------------------------

# The channel-local colour builtins, shared by graph_strip (opcode OP_CH0 +
# k) and graph_strip_mc (MC_CH0 + k).  Each computes a colour channel c of
# its output from a (input_image) and b (input_image2) at that pixel:
CHANNEL_OPS = (
    "invert",  # 1 - a
    "scale",  # a * p0 (exposure: p0 = 2 ** stops)
    "gamma",  # max(a, 0) ** p0 (p0 = 1 / value)
    "brightness_contrast",  # (a - 0.5) * p0 + 0.5 + p1
    "gain",  # a * p[c] (white_balance)
    "posterize",  # round(clip01(a) * p0) / p0 (p0 = levels - 1)
    "dither",  # floor(clip01(a) * p0 + bayer4(y, x)) / p0
    "scanlines",  # a * (p1 if y % p0 == 0 else 1)
    "add",  # a + p0 * b
    "multiply",  # a * b
    "screen",  # 1 - (1 - a) * (1 - b)
    "overlay",  # 2 a b if a < 0.5 else 1 - 2 (1 - a) (1 - b)
    "difference",  # |a - b|
    "levels",  # p3 + clip01((a - p0) / p1) ** p2 * p4
)
CH = {name: k for k, name in enumerate(CHANNEL_OPS)}


def bayer4(ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The 4x4 Bayer threshold (M + 0.5) / 16 at integer pixel coordinates,
    in the closed form of the reference's channel form (library.py:672-686
    there): M = 4 m2(y & 1, x & 1) + m2(y >> 1 & 1, x >> 1 & 1), m2(a, b)
    = 2b + a(3 - 4b)."""
    def m2(a, b):
        return 2 * b + a * (3 - 4 * b)

    idx = 4 * m2(ys % 2, xs % 2) + m2((ys // 2) % 2, (xs // 2) % 2)
    return (idx.to(torch.float32) + 0.5) / 16.0


def channel_op_plain(op: str, a: torch.Tensor, b: Optional[torch.Tensor], p: Sequence[float],
                     ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The plain version of a channel op over (3, H, W) colour planes ``a``
    and ``b`` with (H, W) coordinate planes: the same operations in the
    same order as the device code, each rounded to f32 (torch's ``**``
    takes the same special cases as the kernels' ``pow_scalar``)."""
    if op == "invert":
        return 1.0 - a
    if op == "scale":
        return a * p[0]
    if op == "gamma":
        return torch.clamp_min(a, 0.0) ** p[0]
    if op == "brightness_contrast":
        return (a - 0.5) * p[0] + 0.5 + p[1]
    if op == "gain":
        return a * torch.tensor(p[:3], dtype=torch.float32, device=a.device).view(3, 1, 1)
    if op == "posterize":
        return true_divide(torch.round(torch.clamp(a, 0.0, 1.0) * p[0]), p[0])
    if op == "dither":
        scaled = torch.clamp(a, 0.0, 1.0) * p[0]
        return true_divide(torch.floor(scaled + bayer4(ys, xs)), p[0])
    if op == "scanlines":
        return torch.where(ys % int(p[0]) == 0, a * p[1], a)
    if op == "add":
        return a + p[0] * b
    if op == "multiply":
        return a * b
    if op == "screen":
        return 1.0 - (1.0 - a) * (1.0 - b)
    if op == "overlay":
        return torch.where(a < 0.5, 2.0 * a * b, 1.0 - 2.0 * (1.0 - a) * (1.0 - b))
    if op == "difference":
        return torch.abs(a - b)
    if op == "levels":
        t = torch.clamp(true_divide(a - p[0], p[1]), 0.0, 1.0)
        return p[3] + t ** p[2] * p[4]
    raise ValueError(f"unknown channel op {op!r}")


@dataclasses.dataclass(frozen=True)
class StripOp:
    """One node of the graph_strip epilogue.

    ``code``/``ins``/``out``/``params``/``plane`` are what the kernel
    evaluates; ``plain(ci, t, ins, plane)`` computes the same node in
    PyTorch from the builtin's channel form (the plain version's body)."""

    code: int
    ins: tuple[int, int]
    out: int
    params: tuple[float, ...]
    plane: int
    plain: Callable[..., torch.Tensor]


@dataclasses.dataclass
class StripProgram:
    """A single-tier graph for graph_strip: the conv plans of the input
    (slots 1..N; slot 0 is the input), the epilogue op list, the slot of
    the final output, the storage format and the hoisted coordinate
    planes (``aux``, (n, H, W) f32, or None)."""

    plans: list
    ops: list[StripOp]
    out_slot: int
    fmt: str
    aux: Optional[torch.Tensor] = None
    _packed: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.plans = _as_plans(self.plans)
        slots = [self.out_slot] + [s for op in self.ops for s in (*op.ins, op.out)]
        if max(slots) >= MAX_SLOTS:
            raise ValueError(f"graph_strip takes at most {MAX_SLOTS} value slots")
        if any(len(op.params) > STRIP_OP_FLOATS for op in self.ops):
            raise ValueError(f"graph_strip ops take at most {STRIP_OP_FLOATS} float params")

    def packed(self, device: torch.device):
        """(op ints, op floats) tensors on ``device``, built once."""
        hit = self._packed.get(device)
        if hit is None:
            op_i = np.array(
                [[op.code, op.ins[0], op.ins[1], op.out, op.plane] for op in self.ops],
                np.int32,
            ).reshape(-1, 5)
            op_f = np.zeros((len(self.ops), STRIP_OP_FLOATS), np.float32)
            for j, op in enumerate(self.ops):
                op_f[j, : len(op.params)] = op.params
            hit = (torch.from_numpy(op_i).to(device), torch.from_numpy(op_f).to(device))
            self._packed[device] = hit
        return hit


def _store(v: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "rgba8":
        return quantize_rgba8(v)
    if fmt == "rgba16f":
        return v.to(torch.bfloat16).to(torch.float32)
    return v


def graph_strip_plain(x: torch.Tensor, t: float, strip: StripProgram) -> torch.Tensor:
    """The plain version of ``graph_strip``: the convs, then each op's
    channel form over whole planes (``ci`` is a (C, 1, 1) channel index),
    rounding every node's output to storage."""
    slots: dict[int, Any] = {0: x.to(torch.float32)}
    for k, blur in enumerate(sep_conv_plain(x, strip.plans, "edge")):
        slots[1 + k] = blur
    ci = torch.arange(x.shape[0], device=x.device).view(-1, 1, 1)
    for op in strip.ops:
        plane = strip.aux[op.plane] if op.plane >= 0 else None
        v = op.plain(ci, t, [slots[i] for i in op.ins], plane)
        slots[op.out] = _store(v, strip.fmt)
    return slots[strip.out_slot].to(x.dtype)


def graph_strip(x: torch.Tensor, t: float, strip: StripProgram) -> torch.Tensor:
    """A whole single-tier graph (N edge-clamped convs of the input, then a
    channel-local epilogue) in one kernel; returns the final output in the
    storage type.

    Replaces ``pallas_ops.graph_strip_fused`` (pallas_ops.py:1396).  The TPU
    kernel took the epilogue as a traced Python closure and ran rgba16f
    heavy convs as bf16 band matmuls; here the epilogue is the op list of
    ``strip`` evaluated per pixel from registers, and every conv runs in
    f32 from one shared-memory window per tile, so nothing between the
    input read and the output write touches device memory.

    Bound on the card: the convs' tap loops, then the epilogue, whose
    per-pixel slot array lives in local memory.  The flagship at 4K takes
    1.40 ms in either format, against 0.90 ms for its two convs alone in
    ``sep_conv_fused_multi`` (H100 80GB HBM3, 700 W)."""
    dtype = torch.bfloat16 if strip.fmt == "rgba16f" else torch.float32
    _check_image(x, (dtype,), "graph_strip")
    if not _on_cuda(x):
        return graph_strip_plain(x, t, strip)
    lib = load_library()
    if MAX_SLOTS != lib.rf_max_slots():
        raise RuntimeError("MAX_SLOTS disagrees with the built kernel")
    c, h, w = x.shape
    aux = strip.aux
    if aux is not None and (
        aux.device != x.device or aux.dtype != torch.float32
        or tuple(aux.shape[1:]) != (h, w) or not aux.is_contiguous()
    ):
        raise ValueError("aux must be a contiguous (n, H, W) f32 tensor on the input's device")
    taps, meta = _taps_for(strip.plans, x.device)
    op_i, op_f = strip.packed(x.device)
    rh, rw = _radii(strip.plans)
    th, tw, smem = pick_tile(rh, rw, taps.numel(), extra_per_pixel=len(strip.plans))
    out = torch.empty_like(x)
    channel_ops = any(op.code >= OP_CH0 for op in strip.ops)
    rc = lib.rf_graph_strip(
        int(dtype == torch.bfloat16), int(channel_ops), x.data_ptr(), out.data_ptr(),
        0 if aux is None else aux.data_ptr(), c, h, w, taps.data_ptr(), meta.data_ptr(),
        len(strip.plans), taps.numel(), rh, rw, th, tw, op_i.data_ptr(), op_f.data_ptr(),
        len(strip.ops), strip.out_slot, STORE_MODES[strip.fmt], float(t), smem,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, rc, "graph_strip")
    LAUNCHES["graph_strip"] += 1
    return out


# ---- kernel C: stencil_apply ---------------------------------------------------------

# Largest stencil radius the kernels take (the reference's mc gate).
STENCIL_MAX_RADIUS = 16
# Stencil kinds (csrc/stencil.cu, enum StencilKind).
_STENCIL_KINDS = {"wsum": 0, "median9": 1}


@dataclasses.dataclass(frozen=True)
class StencilOp:
    """A neighbourhood function the stencil kernel evaluates per pixel.

    ``"wsum"``: the sum of ``terms`` -- the nonzero (dy, dx, w) of a
    ``shape`` tap table in ascending (dy, dx) -- in ``ops.conv2d``'s
    order.  ``"median9"``: the median of the 3x3 neighbourhood by Smith's
    19-exchange network (reforge_tpu/kernels/library.py:321-331)."""

    kind: str
    shape: tuple[int, int] = (3, 3)
    terms: tuple[tuple[int, int, float], ...] = ()


def wsum(taps) -> StencilOp:
    """The weighted-sum op of an odd-sized 2-D tap table."""
    taps = np.asarray(taps, np.float32)
    if taps.ndim != 2 or taps.shape[0] % 2 == 0 or taps.shape[1] % 2 == 0:
        raise ValueError(f"tap tables must be 2-D with odd sides, got {taps.shape}")
    terms = tuple(
        (dy, dx, float(taps[dy, dx]))
        for dy in range(taps.shape[0])
        for dx in range(taps.shape[1])
        if taps[dy, dx] != 0.0
    )
    return StencilOp("wsum", tuple(taps.shape), terms)


MEDIAN9 = StencilOp("median9")

# Smith's median-of-9 exchange network: v[i] <- min, v[j] <- max.
MEDIAN9_PAIRS = (
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
    (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
    (4, 2), (6, 4), (4, 2),
)


def _check_stencil(rh: int, rw: int, op: StencilOp) -> None:
    if op.kind not in _STENCIL_KINDS:
        raise ValueError(f"unknown stencil op {op.kind!r}")
    if not (0 <= rh <= STENCIL_MAX_RADIUS and 0 <= rw <= STENCIL_MAX_RADIUS):
        raise ValueError(f"stencil radii ({rh}, {rw}) outside 0..{STENCIL_MAX_RADIUS}")
    if op.kind == "median9" and (rh, rw) != (1, 1):
        raise ValueError("median9 takes radius 1")
    if op.kind == "wsum" and tuple(op.shape) != (2 * rh + 1, 2 * rw + 1):
        raise ValueError(f"tap table {op.shape} does not match radii ({rh}, {rw})")


def _padded(x: torch.Tensor, rh: int, rw: int, mode: str) -> torch.Tensor:
    """(C, H, W) padded by (rh, rw): clamped indices (edge) or zeros."""
    if mode == "zero":
        return F.pad(x, (rw, rw, rh, rh))
    h, w = x.shape[-2], x.shape[-1]
    ys = torch.clamp(torch.arange(-rh, h + rh, device=x.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-rw, w + rw, device=x.device), 0, w - 1)
    return x.index_select(-2, ys).index_select(-1, xs)


def ordered_wsum(tap, terms, centre) -> torch.Tensor:
    """sum of tap(dy, dx) * w over ``terms`` in ``ops.conv2d``'s order: one
    chain up to 16 terms, else term i into stripe i % 8 and a pairwise
    merge of the stripes.  No terms: ``centre() * 0``."""
    if not terms:
        return centre() * 0.0
    n_stripes = 8 if len(terms) > 16 else 1
    parts: list = [None] * n_stripes
    for i, (dy, dx, w) in enumerate(terms):
        t = tap(dy, dx) * w
        j = i % n_stripes
        parts[j] = t if parts[j] is None else parts[j] + t
    parts = [v for v in parts if v is not None]
    while len(parts) > 1:
        merged = [parts[k] + parts[k + 1] for k in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            merged.append(parts[-1])
        parts = merged
    return parts[0]


def median9_plain(v: list) -> torch.Tensor:
    """Median of nine same-shape tensors by the exchange network."""
    v = list(v)
    for i, j in MEDIAN9_PAIRS:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def stencil_apply_plain(x: torch.Tensor, rh: int, rw: int, op: StencilOp,
                        mode: str = "edge") -> torch.Tensor:
    """The plain version of ``stencil_apply``: shifted slices of a clamped
    or zero-padded copy."""
    _check_mode(mode)
    _check_stencil(rh, rw, op)
    h, w = x.shape[-2], x.shape[-1]
    xp = _padded(x, rh, rw, mode)

    def tap(dy, dx):
        return xp[..., dy : dy + h, dx : dx + w]

    if op.kind == "median9":
        return median9_plain([tap(dy, dx) for dy in range(3) for dx in range(3)])
    return ordered_wsum(tap, op.terms, lambda: tap(rh, rw))


def _term_arrays(terms) -> tuple[np.ndarray, np.ndarray]:
    """(weights f32, positions int32 as dy * 64 + dx) of stencil terms."""
    w = np.array([t[2] for t in terms], np.float32)
    idx = np.array([t[0] * 64 + t[1] for t in terms], np.int32)
    return w, idx


@functools.lru_cache(maxsize=64)
def _device_terms(terms: tuple, device: torch.device):
    w, idx = _term_arrays(terms)
    return torch.from_numpy(w).to(device), torch.from_numpy(idx).to(device)


def choose_stencil_tile(rh: int, rw: int, n_terms: int) -> tuple[int, int, int]:
    """(TH, TW, shared-memory bytes) for the stencil kernel: its window
    plus the term weights and positions.  Every radius up to 16 fits the
    largest tile under SMEM_SOFT."""
    for th, tw in TILES:
        nbytes = 4 * ((th + 2 * rh) * (tw + 2 * rw) + 2 * n_terms)
        if nbytes <= SMEM_SOFT:
            return th, tw, nbytes
    raise ValueError(f"no stencil tile fits radii ({rh}, {rw})")


def stencil_apply(x: torch.Tensor, rh: int, rw: int, op: StencilOp,
                  mode: str = "edge") -> torch.Tensor:
    """A per-pixel neighbourhood function of each channel of an f32
    (C, H, W) image, in one pass.

    Replaces ``pallas_ops.stencil_apply`` (pallas_ops.py:1935), which took
    the function as a traced Python closure over tap views of a VMEM
    strip.  Here the function is a ``StencilOp``: a block loads its tile
    and (rh, rw) halo of one channel into shared memory with clamped or
    zero-filled reads, and each thread evaluates the op per pixel -- the
    ``wsum`` terms with ``__fmul_rn``/``__fadd_rn`` in ``conv2d``'s order
    (so the laplacian's cancellation rounds as the plain version does),
    or the median network.

    Bound on the card: device memory (one read and one write per pixel;
    the 3x3 ops do 5-19 operations per pixel).  Its times are in
    PERF.md."""
    _check_image(x, (torch.float32,), "stencil_apply")
    _check_mode(mode)
    _check_stencil(rh, rw, op)
    if not _on_cuda(x):
        return stencil_apply_plain(x, rh, rw, op, mode)
    lib = load_library()
    c, h, w = x.shape
    terms_w, terms_idx = _device_terms(op.terms, x.device)
    th, tw, smem = choose_stencil_tile(rh, rw, len(op.terms))
    out = torch.empty_like(x)
    rc = lib.rf_stencil_apply(
        x.data_ptr(), out.data_ptr(), c, h, w, rh, rw, int(mode == "zero"), th, tw,
        _STENCIL_KINDS[op.kind], terms_w.data_ptr(), terms_idx.data_ptr(), len(op.terms),
        smem, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, rc, "stencil_apply")
    LAUNCHES["stencil_apply"] += 1
    return out


# ---- kernel D: graph_strip_mc --------------------------------------------------------

# Stage kinds of graph_strip_mc (csrc/graph_strip_mc.cu, enum McKind).
MC_POINT, MC_STENCIL, MC_CONV = 0, 1, 2
# Opcodes (csrc enum McOp).  Point ops read one or two inputs at a pixel:
MC_COPY = 0  # in0
MC_MIX = 1  # in0 + (in1 - in0) * p0, all channels
MC_ACES = 2  # rgb: ACES filmic of in0 * p0
MC_REINHARD = 3  # rgb: Reinhard of in0 * p0
MC_VIGNETTE = 4  # rgb: in0 * radial fade (p0 strength, p1 radius, p2 1.42 - radius)
MC_GRAYSCALE = 5  # rgb: luma(in0)
MC_SATURATION = 6  # rgb: y + (in0 - y) * p0, y = luma(in0)
MC_THRESHOLD = 7  # rgb: luma(in0) > p0
MC_BLOOM_PRE = 8  # rgb: in0 * smoothstep(p0, p0 + p1, luma) (p1 the span); stays f32
# MC_CH0 + k: channel op k of CHANNEL_OPS on the rgb channels; "levels"
# takes p4 from table 0 (a 1x1 table: a stage has four floats).
MC_CH0 = 9
MC_SEPIA = MC_CH0 + len(CHANNEL_OPS)  # rgb: in0 + (clip01(sepia matrix . in0) - in0) * p0
MC_HUE_SAT = MC_SEPIA + 1  # rgb: hue matrix (table 0, 3x3) then saturation p0, lightness p1
# A GLSL shader's affine mix (glsl/affine.py), all channels: s_c in0 + p_c
# in1 + b_c, (s_c, p_c, b_c) row c of table 0 (affine_table).
MC_AFFINE = MC_HUE_SAT + 1
# Conv epilogues, given the blur and the stage's x source:
MC_CONV_IDENTITY = 32  # blur
MC_CONV_UNSHARP = 33  # rgb: x + p0 * (x - blur)
MC_CONV_BLOOM = 34  # rgb: x + p0 * blur
# Stencils over the 3x3 (r = 1) or (2r+1)^2 neighbourhood:
MC_SHARPEN = 48  # rgb: x + p0 * wsum(table 0)
MC_SOBEL = 49  # rgb: sqrt(gx^2 + gy^2) * p0, gx/gy = wsum of tables 0/1 over luma
MC_EMBOSS = 50  # rgb: wsum(table 0)
MC_MEDIAN3 = 51  # rgb: median9

# Sepia's tone matrix (reforge_tpu/kernels/library.py:66-68), rows r, g, b.
SEPIA_MATRIX = ((0.393, 0.769, 0.189), (0.349, 0.686, 0.168), (0.272, 0.534, 0.131))


def mc_kind(code: int) -> int:
    """The stage kind an opcode belongs to."""
    return MC_POINT if code < 32 else MC_CONV if code < 48 else MC_STENCIL


def matrix_rgb(rgb: torch.Tensor, m) -> torch.Tensor:
    """Rows of ``m`` applied to (3, H, W) colour planes, each row summed
    r * m0 + g * m1 + b * m2 with its products rounded apart, as the mc
    kernel sums them."""
    return torch.stack([rgb[0] * float(row[0]) + rgb[1] * float(row[1]) + rgb[2] * float(row[2])
                        for row in m])


def mc_point_plain(op: McOp, a: torch.Tensor, b: Optional[torch.Tensor],
                   ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The plain version of the point opcodes from MC_CH0 on, over (4, H,
    W) inputs: what the mc kernel computes, step by step."""
    p = list(op.params)
    if MC_CH0 <= op.code < MC_SEPIA:
        name = CHANNEL_OPS[op.code - MC_CH0]
        if name == "levels":
            p = p + [float(np.asarray(op.tables[0]).reshape(-1)[0])]
        rgb = channel_op_plain(name, a[:3], None if b is None else b[:3], p, ys, xs)
    elif op.code == MC_SEPIA:
        rgb = a[:3] + (torch.clamp(matrix_rgb(a, SEPIA_MATRIX), 0.0, 1.0) - a[:3]) * p[0]
    elif op.code == MC_HUE_SAT:
        out = matrix_rgb(a, np.asarray(op.tables[0], np.float32))
        y = (out[0] * 0.2126 + out[1] * 0.7152 + out[2] * 0.0722)[None]
        rgb = y + (out - y) * p[0] + p[1]
    else:
        raise ValueError(f"no plain form here for mc opcode {op.code}")
    return torch.cat([rgb, a[3:4]], dim=0)


# Stage inputs and outputs that are not pool slots.
MC_INPUT = -1  # the graph input
MC_OUTPUT = -2  # the kernel output (the final node)
# Kernel limits (csrc kMcMaxStages, kMcStageInts).
MC_MAX_STAGES = 24
MC_STAGE_INTS = 22
# Output tiles (rows, cols) of the mc kernel, largest first; the footprint
# preferred for two blocks per SM, and the dynamic shared memory a block
# may take beside the kernel's static stage table (2.5 KB).
MC_TILES = ((32, 64), (32, 32), (16, 32), (16, 16), (8, 16), (8, 8))
MC_SMEM_SOFT = 113 * 1024
MC_SMEM_LIMIT = SMEM_LIMIT - 4096


@dataclasses.dataclass(frozen=True)
class McOp:
    """A node's device form in the mc kernel: an opcode, up to four float
    params and, for stencils, the 2-D tap tables its wsum terms come
    from (for a point op, a 3x3 colour matrix or a 1x1 fifth param)."""

    code: int
    params: tuple = ()
    tables: tuple = ()


@dataclasses.dataclass
class McStage:
    """One stage of an mc plan.

    ``ins`` (and ``x``, a conv epilogue's source) are (slot, eh, ew): a
    pool slot (or MC_INPUT) and the extent the resource there was
    computed over.  The stage computes its output over the tile plus
    (eh, ew) into slot ``out`` (or MC_OUTPUT), rounding to storage when
    ``store``.  ``taps`` are the conv's (wh, ww) or the stencil's (or
    point op's) tables; ``plain`` computes the stage in PyTorch over whole images
    from the builtin's own forms: point ``plain(ctx, ins)``, stencil
    ``plain(ctx, tap)``, conv ``plain(ctx, x, blur)``."""

    kind: int
    op: McOp
    ins: tuple
    out: int
    eh: int
    ew: int
    plain: Callable[..., torch.Tensor]
    x: Optional[tuple] = None
    r: int = 0
    taps: tuple = ()
    store: bool = True


def affine_table(synth) -> np.ndarray:
    """The affine mix of a GLSL synth record (glsl/affine.py) as MC_AFFINE's
    table: row c is (s_c, p_c, b_c), and a zero fifth row gives the table
    odd sides."""
    t = np.zeros((5, 3), np.float32)
    for c in range(4):
        t[c] = (synth.scale[c], synth.passthrough[c], synth.offset[c])
    return t


def affine_mix_plain(synth, v: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
    """out_c = s_c * v_c (+ p_c * x_c where p_c != 0) (+ b_c where b_c !=
    0), each operation rounded to f32 as the mc kernel rounds it and in the
    order of the reference's ``_affine_mix`` (program.py:701-713 there)."""
    chans = []
    for c in range(4):
        o = v[c] * float(synth.scale[c])
        if synth.passthrough[c] != 0.0 and x is not None:
            o = o + x[c] * float(synth.passthrough[c])
        if synth.offset[c] != 0.0:
            o = o + float(synth.offset[c])
        chans.append(o)
    return torch.stack(chans)


def synth_stencil_plain(synth, tap) -> torch.Tensor:
    """The plain form of a synthesized 2-D tap-sum as the mc kernel runs
    it, an MC_EMBOSS stage: the table's weighted sum of each colour channel
    in ``ordered_wsum``'s order, and the centre's alpha."""
    r = synth.radius
    centre = tap(r, r)
    acc = ordered_wsum(tap, wsum(synth.w).terms, lambda: centre)
    return torch.cat([acc[:3], centre[3:4]])


@dataclasses.dataclass
class McProgram:
    """A multi-stage graph for graph_strip_mc, built once per program: the
    stages in topological order, the number of pool slots, the input's
    extent (``rh_in`` rows, ``ew_in`` columns), the frame and the storage
    format."""

    stages: list
    n_slots: int
    rh_in: int
    ew_in: int
    width: int
    height: int
    fmt: str
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if len(self.stages) > MC_MAX_STAGES:
            raise ValueError(f"graph_strip_mc takes at most {MC_MAX_STAGES} stages")
        ws, idxs, self._lists = [], [], []
        off = 0
        for st in self.stages:
            if len(st.op.params) > 4:
                raise ValueError("mc ops take at most 4 float params")
            if st.kind == MC_CONV:
                wh, ww = (np.asarray(v, np.float32) for v in st.taps)
                parts = [(wh, np.zeros(len(wh), np.int32)), (ww, np.zeros(len(ww), np.int32))]
            else:
                parts = [_term_arrays(wsum(tab).terms) for tab in st.taps]
            lists = []
            for w, idx in parts:
                lists += [off, len(w)]
                ws.append(w)
                idxs.append(idx)
                off += len(w)
            self._lists.append((lists + [0, 0, 0, 0])[:4])
        self.taps = np.concatenate(ws) if ws else np.zeros(0, np.float32)
        self.term_idx = np.concatenate(idxs) if idxs else np.zeros(0, np.int32)

    def _layout(self, th: int, tw: int):
        """(slot float offsets, scratch offset, taps offset, bytes) of the
        shared-memory layout for a (th, tw) tile: the input block, the
        pool slots (each sized for the largest resource it holds), the
        conv H-pass buffer (two halves), the taps and their positions.
        Rows have an odd pitch (csrc graph_strip_mc.cu ``pitch``)."""
        def block(eh, ew):
            return 4 * (th + 2 * eh) * ((tw + 2 * ew) | 1)

        cap = [0] * self.n_slots
        scratch = 0
        for st in self.stages:
            if st.out >= 0:
                cap[st.out] = max(cap[st.out], block(st.eh, st.ew))
            if st.kind == MC_CONV:
                rw = (len(st.taps[1]) - 1) // 2
                scratch = max(scratch, 2 * (th + 2 * st.eh) * ((tw + 2 * st.ew + 2 * rw) | 1))
        off = block(self.rh_in, self.ew_in)
        slot_off = []
        for c in cap:
            slot_off.append(off)
            off += c
        scratch_off = off
        taps_off = scratch_off + scratch
        return slot_off, scratch_off, taps_off, 4 * (taps_off + 2 * len(self.taps))

    def tile(self) -> Optional[tuple[int, int, int]]:
        """(TH, TW, shared-memory bytes): the largest tile under
        MC_SMEM_SOFT, else under MC_SMEM_LIMIT, else None (the planner
        then refuses the plan)."""
        if "tile" not in self._cache:
            self._cache["tile"] = None
            for budget in (MC_SMEM_SOFT, MC_SMEM_LIMIT):
                fits = [(th, tw) for th, tw in MC_TILES if self._layout(th, tw)[3] <= budget]
                if fits:
                    th, tw = fits[0]
                    self._cache["tile"] = (th, tw, self._layout(th, tw)[3])
                    break
        return self._cache["tile"]

    def packed(self, th: int, tw: int):
        """(stage ints, stage floats, scratch offset, taps offset) for the
        kernel: host arrays of MC_STAGE_INTS ints and 4 floats a stage."""
        key = ("packed", th, tw)
        if key not in self._cache:
            slot_off, scratch_off, taps_off, _ = self._layout(th, tw)

            def buf(ref):
                if ref is None:
                    return [-1, 0, 0]
                slot, eh, ew = ref
                return [0 if slot == MC_INPUT else slot_off[slot], eh, ew]

            rows_i, rows_f = [], []
            for st, lists in zip(self.stages, self._lists):
                ins = list(st.ins) + [None] * (2 - len(st.ins))
                rh = rw = st.r
                if st.kind == MC_CONV:
                    rh, rw = ((len(v) - 1) // 2 for v in st.taps)
                rows_i.append(
                    [st.kind, st.op.code, len(st.ins), *buf(ins[0]), *buf(ins[1]), *buf(st.x),
                     -1 if st.out == MC_OUTPUT else slot_off[st.out], st.eh, st.ew, rh, rw,
                     *lists, int(st.store)]
                )
                rows_f.append((list(st.op.params) + [0.0] * 4)[:4])
            stage_i = np.ascontiguousarray(np.array(rows_i, np.int32).reshape(-1, MC_STAGE_INTS))
            stage_f = np.ascontiguousarray(np.array(rows_f, np.float32).reshape(-1, 4))
            self._cache[key] = (stage_i, stage_f, scratch_off, taps_off)
        return self._cache[key]

    def device_taps(self, device: torch.device):
        key = ("taps", device)
        if key not in self._cache:
            self._cache[key] = (torch.from_numpy(self.taps).to(device),
                                torch.from_numpy(self.term_idx).to(device))
        return self._cache[key]


def graph_strip_mc_plain(x: torch.Tensor, t: float, prog: McProgram) -> torch.Tensor:
    """The plain version of ``graph_strip_mc``, and the mc tier's CPU path:
    the stage list over whole images (convs and stencils with clamped
    taps), rounding each node's output to storage."""
    ctx = KernelContext(width=prog.width, height=prog.height, time=t, fmt=prog.fmt,
                        device=x.device)
    h, w = x.shape[-2], x.shape[-1]
    vals: dict[int, torch.Tensor] = {MC_INPUT: x.to(torch.float32)}
    for st in prog.stages:
        ins = [vals[slot] for slot, _eh, _ew in st.ins]
        if st.kind == MC_CONV:
            blur = sep_conv_plain(ins[0], [st.taps], "edge")[0]
            v = st.plain(ctx, vals[st.x[0]] if st.x is not None else None, blur)
        elif st.kind == MC_STENCIL:
            xp = _padded(ins[0], st.r, st.r, "edge")
            v = st.plain(ctx, lambda dy, dx, _xp=xp: _xp[:, dy : dy + h, dx : dx + w])
        else:
            v = st.plain(ctx, ins)
        vals[st.out] = _store(v, prog.fmt) if st.store else v
    return vals[MC_OUTPUT].to(x.dtype)


def graph_strip_mc(x: torch.Tensor, t: float, prog: McProgram) -> torch.Tensor:
    """A whole multi-stage graph in one kernel; returns the final output in
    the storage type.

    Replaces ``pallas_ops.graph_strip_fused_mc`` (pallas_ops.py:2955),
    which streamed channel-full whole-width strips through VMEM with a
    DMA double buffer, carried conv rows between strips and ran heavy
    convs as MXU band matmuls.  Here a block owns a 2-D tile with all four
    channels: it loads the tile plus the plan's input extent into shared
    memory with clamped reads, then each stage computes its output over
    the tile plus its own extent into a shared-memory pool slot.  Every
    read of an intermediate goes through the clamped global coordinate,
    so the tier reproduces per-node execution's edge padding of every
    intermediate without computing outside the image.

    Bound on the card: the conv tap loops over each stage's extended
    block, and the halo recomputed by neighbouring tiles.  Its times are
    in PERF.md."""
    dtype = torch.bfloat16 if prog.fmt == "rgba16f" else torch.float32
    _check_image(x, (dtype,), "graph_strip_mc")
    if tuple(x.shape) != (4, prog.height, prog.width):
        raise ValueError(f"graph_strip_mc: expected (4, {prog.height}, {prog.width}), "
                         f"got {tuple(x.shape)}")
    if not _on_cuda(x):
        return graph_strip_mc_plain(x, t, prog)
    lib = load_library()
    if (lib.rf_mc_limits(0), lib.rf_mc_limits(1)) != (MC_MAX_STAGES, MC_STAGE_INTS):
        raise RuntimeError("MC_MAX_STAGES/MC_STAGE_INTS disagree with the built kernel")
    tile = prog.tile()
    if tile is None:
        raise ValueError("graph_strip_mc: no tile fits this plan (the planner refuses it)")
    th, tw, smem = tile
    stage_i, stage_f, scratch_off, taps_off = prog.packed(th, tw)
    taps, term_idx = prog.device_taps(x.device)
    out = torch.empty_like(x)
    rc = lib.rf_graph_strip_mc(
        int(dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(), prog.height, prog.width,
        th, tw, prog.rh_in, prog.ew_in, stage_i.ctypes.data, stage_f.ctypes.data,
        len(prog.stages), scratch_off, taps_off, taps.data_ptr(), term_idx.data_ptr(),
        len(prog.taps), STORE_MODES[prog.fmt], float(t), smem,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, rc, "graph_strip_mc")
    LAUNCHES["graph_strip_mc"] += 1
    return out


# ---- kernel E: stencil_reduce_mc -------------------------------------------------------

# Reduction kinds (csrc/stencil_reduce.cu, enum ReduceKind); each reduces
# a (4, H, W) image to (3, H, W).
_REDUCE_KINDS = {"bilateral": 0}


@dataclasses.dataclass(frozen=True)
class ReduceOp:
    """A windowed all-channel reduction the stencil_reduce kernel evaluates
    per pixel: the device form of the reference's ``tap_fn``/``final_fn``
    closures.

    ``"bilateral"`` over (r, g, b, luma): for each ``(dy, dx, ws)`` of
    ``taps`` in order, ``wr = exp(-((n3 - c3)^2) * inv2sr) * ws`` (c the
    centre, n the tap) adds ``(n0 wr, n1 wr, n2 wr, wr)`` to the
    accumulator; the output is ``acc[:3] / acc[3]``.  ``ws`` and
    ``inv2sr`` round to f32 where they are used, as the reference's
    Python floats do."""

    kind: str
    taps: tuple[tuple[int, int, float], ...]
    inv2sr: float = 0.0


def _check_reduce(x: torch.Tensor, rh: int, rw: int, op: ReduceOp) -> None:
    if op.kind not in _REDUCE_KINDS:
        raise ValueError(f"unknown reduction op {op.kind!r}")
    if x.shape[0] != 4:
        raise ValueError(f"{op.kind}: expected 4 channels, got {x.shape[0]}")
    if rh < 0 or rw < 0 or not op.taps:
        raise ValueError("stencil_reduce_mc needs radii >= 0 and at least one tap")
    if any(not (0 <= dy <= 2 * rh and 0 <= dx <= 2 * rw) for dy, dx, _ in op.taps):
        raise ValueError(f"a tap lies outside the ({rh}, {rw}) window")


def stencil_reduce_mc_plain(x: torch.Tensor, rh: int, rw: int, op: ReduceOp,
                            mode: str = "edge") -> torch.Tensor:
    """The plain version of ``stencil_reduce_mc``, the reference's portable
    path (reforge_tpu/kernels/library.py:845-859): taps are shifted slices
    of one clamped or zero-padded copy, contributions added in tap order."""
    _check_mode(mode)
    _check_reduce(x, rh, rw, op)
    h, w = x.shape[-2], x.shape[-1]
    xp = _padded(x, rh, rw, mode)
    c3 = xp[3, rh : rh + h, rw : rw + w]
    acc = None
    for dy, dx, ws in op.taps:
        n = xp[:, dy : dy + h, dx : dx + w]
        d = n[3] - c3
        wr = torch.exp(-(d * d) * op.inv2sr) * ws
        t = torch.cat([n[:3] * wr, wr[None]], dim=0)
        acc = t if acc is None else acc + t
    return acc[:3] / acc[3]


@functools.lru_cache(maxsize=64)
def _device_reduce_taps(taps: tuple, device: torch.device):
    """(weights f32, positions int32 as all dy then all dx) on ``device``."""
    w = torch.tensor([t[2] for t in taps], dtype=torch.float32)
    pos = torch.tensor([t[0] for t in taps] + [t[1] for t in taps], dtype=torch.int32)
    return w.to(device), pos.to(device)


def choose_reduce_tile(rh: int, rw: int, n_taps: int) -> Optional[tuple[int, int, int]]:
    """(TH, TW, shared-memory bytes) of the stencil_reduce kernel: the tile
    plus its halo of four channels and the tap table (weight and window
    offset), the largest tile under SMEM_SOFT, else under SMEM_LIMIT, else
    None (the kernel then reads every tap from global memory)."""
    for budget in (SMEM_SOFT, SMEM_LIMIT):
        for th, tw in TILES:
            nbytes = 4 * (4 * (th + 2 * rh) * (tw + 2 * rw) + 2 * n_taps)
            if nbytes <= budget:
                return th, tw, nbytes
    return None


# The tile of the global-memory path (no shared memory).
REDUCE_GLOBAL_TILE = (16, 32)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def stencil_reduce_mc(x: torch.Tensor, rh: int, rw: int, op: ReduceOp,
                      mode: str = "edge") -> torch.Tensor:
    """A windowed weighted reduction over all channels of an f32 (4, H, W)
    image, in one pass; returns (3, H, W) f32.

    Replaces ``pallas_ops.stencil_reduce_mc`` (pallas_ops.py:2197), which
    took the per-tap contribution and the final map as traced closures
    over a double-buffered VMEM strip, and gave up above W radius 128.
    Here the function is a ``ReduceOp``: a block loads its tile and (rh,
    rw) halo of all four channels into shared memory, and each thread
    runs the tap list in order with one f32 accumulator per channel,
    rounding every product and sum as the plain version does.  Every
    radius runs on the card: one whose tile fits no shared memory reads
    its taps through the clamped global coordinate in the same kernel.

    Bound on the card: the SFU's exponentials (one per tap and pixel) are
    the largest term of its bound at bilateral's radii, 0.161 ms at 4K
    radius 4, but the kernel is instruction-issue bound: about 32 SASS
    instructions per tap and pixel, 0.837 ms (H100 80GB HBM3, 700 W)."""
    _check_image(x, (torch.float32,), "stencil_reduce_mc")
    _check_mode(mode)
    _check_reduce(x, rh, rw, op)
    if not _on_cuda(x):
        return stencil_reduce_mc_plain(x, rh, rw, op, mode)
    lib = load_library()
    _c, h, w = x.shape
    weights, pos = _device_reduce_taps(op.taps, x.device)
    tile = choose_reduce_tile(rh, rw, len(op.taps))
    th, tw, smem = tile if tile is not None else (*REDUCE_GLOBAL_TILE, 0)
    out = torch.empty((3, h, w), dtype=torch.float32, device=x.device)
    rc = lib.rf_stencil_reduce(
        x.data_ptr(), out.data_ptr(), h, w, rh, rw, int(mode == "zero"), th, tw,
        _REDUCE_KINDS[op.kind], weights.data_ptr(), pos.data_ptr(), len(op.taps),
        float(op.inv2sr), smem, _stream(x),
    )
    _check_launch(lib, rc, "stencil_reduce_mc")
    LAUNCHES["stencil_reduce_mc"] += 1
    return out


# ---- kernel F: conv1d_h / conv1d_w -------------------------------------------------------

# Output tiles (rows, cols) of the 1-D kernels, largest first: the H pass
# puts a warp across 32 columns, the W pass across 128 (four outputs a
# lane, 32 apart).  The tile of the global-memory path of each.
CONV1D_TILES = {
    True: ((256, 32), (128, 32), (64, 32), (32, 32)),
    False: ((32, 128), (16, 128), (8, 128)),
}
CONV1D_GLOBAL_TILE = {True: (32, 32), False: (8, 128)}


def choose_conv1d_tile(along_h: bool, r: int, n_taps: int) -> Optional[tuple[int, int, int]]:
    """(TH, TW, shared-memory bytes) of a 1-D pass of radius ``r`` with
    ``n_taps`` nonzero taps: the tile plus its halo along the pass and the
    tap list (weight and position), the largest tile under SMEM_SOFT, else
    under SMEM_LIMIT, else None (the kernel then reads every tap from
    global memory)."""
    for budget in (SMEM_SOFT, SMEM_LIMIT):
        for th, tw in CONV1D_TILES[along_h]:
            window = (th + 2 * r) * tw if along_h else th * (tw + 2 * r)
            nbytes = 4 * (window + 2 * n_taps)
            if nbytes <= budget:
                return th, tw, nbytes
    return None


@functools.lru_cache(maxsize=64)
def _device_conv1d_taps(key: bytes, device: torch.device):
    """(nonzero weights f32, their positions int32) of a tap vector."""
    w = np.frombuffer(key, np.float32)
    pos = np.flatnonzero(w != 0.0).astype(np.int32)
    return torch.from_numpy(w[pos].copy()).to(device), torch.from_numpy(pos).to(device)


def _conv1d(x: torch.Tensor, weights, mode: str, along_h: bool) -> torch.Tensor:
    name = "conv1d_h" if along_h else "conv1d_w"
    _check_image(x, (torch.float32,), name)
    _check_mode(mode)
    weights = np.ascontiguousarray(weights, np.float32)
    if weights.ndim != 1 or len(weights) % 2 == 0:
        raise ValueError("tap vectors must be 1-D with odd length")
    if not _on_cuda(x):
        return correlate1d(x, weights, -2 if along_h else -1, mode)
    lib = load_library()
    c, h, w = x.shape
    r = (len(weights) - 1) // 2
    taps, pos = _device_conv1d_taps(weights.tobytes(), x.device)
    tile = choose_conv1d_tile(along_h, r, taps.numel())
    th, tw, smem = tile if tile is not None else (*CONV1D_GLOBAL_TILE[along_h], 0)
    out = torch.empty_like(x)
    rc = lib.rf_conv1d(
        int(along_h), x.data_ptr(), out.data_ptr(), c, h, w, r, int(mode == "zero"), th, tw,
        taps.data_ptr(), pos.data_ptr(), taps.numel(), smem, _stream(x),
    )
    _check_launch(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def conv1d_h(x: torch.Tensor, weights, mode: str = "edge") -> torch.Tensor:
    """1-D correlation along H of an f32 (C, H, W) image, any odd tap count,
    edge or zero borders; returns f32.

    Replaces ``pallas_ops.conv1d_h`` (pallas_ops.py:65), which padded the
    image in the wrapper and ran whole-height blocks of one channel, 256
    lanes wide, through VMEM.  Here a block loads its tile and the (R)
    halo above and below into shared memory with clamped or zero-filled
    reads and runs the nonzero taps in ascending order, rounding each
    product and sum as ``correlate1d`` does (bit-equal to it).  A radius
    whose window fits no shared memory reads its taps from global memory
    in the same kernel.

    Bound on the card: operations, two a tap and output (0.32 ms at 4K,
    four channels, radius 160, against 0.08 ms for the bytes); the kernel
    also loads each tap from shared memory, one warp-wide load a clock per
    SM, and takes 2.10 ms there (8.59 at radius 400, whose window takes a
    135 KB tile: one block an SM; H100 80GB HBM3, 700 W)."""
    return _conv1d(x, weights, mode, True)


def conv1d_w(x: torch.Tensor, weights, mode: str = "edge") -> torch.Tensor:
    """1-D correlation along W of an f32 (C, H, W) image; ``conv1d_h``
    along the other axis.

    Replaces ``pallas_ops.conv1d_w`` (pallas_ops.py:101), which ran
    whole-width blocks of 128 rows.  Here the tile and its (R) halo left
    and right load into shared memory, lanes along W.  Bound as
    ``conv1d_h``: 2.19 ms at 4K radius 160, 4.87 at radius 400 (H100 80GB
    HBM3, 700 W)."""
    return _conv1d(x, weights, mode, False)


# ---- kernel G: stencil_apply_mc ----------------------------------------------------------


class LinearStencilOp:
    """A cross-channel linear stencil: a (C_out, C_in, 2rh+1, 2rw+1) tap
    table, ``out[o] = sum over c, dy, dx of w[o, c, dy, dx] * x[c, y + dy -
    rh, x + dx - rw]``.  The device form of the closures the reference's
    ``stencil_apply_mc`` took; ``terms`` are the nonzero (c, dy, dx, w) of
    each output channel in ascending (c, dy, dx), the order of the sums."""

    def __init__(self, weights):
        w = np.ascontiguousarray(weights, np.float32)
        if w.ndim != 4 or w.shape[2] % 2 == 0 or w.shape[3] % 2 == 0:
            raise ValueError(f"expected a (C_out, C_in, odd, odd) tap table, got {w.shape}")
        self.weights = w
        self.c_out, self.c_in = w.shape[:2]
        self.rh, self.rw = (w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2
        self.terms = tuple(
            tuple((int(c), int(dy), int(dx), float(w[o, c, dy, dx]))
                  for c, dy, dx in zip(*np.nonzero(w[o])))
            for o in range(self.c_out)
        )
        self._device: dict = {}

    @property
    def n_terms(self) -> int:
        return sum(len(t) for t in self.terms)

    def device_terms(self, device: torch.device):
        """(weights f32, (c, dy, dx) int32 per term, C_out + 1 offsets) on
        ``device``, built once."""
        if device not in self._device:
            flat = [t for ts in self.terms for t in ts]
            w = torch.tensor([t[3] for t in flat], dtype=torch.float32)
            pos = torch.tensor([v for t in flat for v in t[:3]], dtype=torch.int32)
            start = torch.tensor(np.cumsum([0] + [len(t) for t in self.terms]), dtype=torch.int32)
            self._device[device] = (w.to(device), pos.to(device), start.to(device))
        return self._device[device]


def stencil_apply_mc_plain(x: torch.Tensor, op: LinearStencilOp, mode: str = "edge") -> torch.Tensor:
    """The plain version of ``stencil_apply_mc``: the input padded (clamped
    indices or zeros, as ``F.pad`` does), then for each output channel the
    products of its terms added one after another in f32; returned in the
    input's type."""
    _check_mode(mode)
    h, w = x.shape[-2], x.shape[-1]
    xf = x.to(torch.float32)
    xp = F.pad(xf[None], (op.rw, op.rw, op.rh, op.rh),
               mode="replicate" if mode == "edge" else "constant")[0]
    outs = []
    for terms in op.terms:
        acc = None
        for c, dy, dx, wv in terms:
            t = xp[c, dy : dy + h, dx : dx + w] * wv
            acc = t if acc is None else acc + t
        outs.append(acc if acc is not None else xf.new_zeros((h, w)))
    return torch.stack(outs).to(x.dtype)


def choose_stencil_mc_tile(c_in: int, rh: int, rw: int, n_terms: int,
                           c_out: int) -> Optional[tuple[int, int, int]]:
    """(TH, TW, shared-memory bytes) of stencil_apply_mc: the tile's window
    of every input channel plus the term table (weight and window offset)
    and the output channels' first terms, the largest tile under
    SMEM_SOFT, else under SMEM_LIMIT, else None (the kernel then reads its
    terms and taps from global memory)."""
    for budget in (SMEM_SOFT, SMEM_LIMIT):
        for th, tw in TILES:
            nbytes = 4 * (c_in * (th + 2 * rh) * (tw + 2 * rw) + 2 * n_terms + c_out + 1)
            if nbytes <= budget:
                return th, tw, nbytes
    return None


# The tile of stencil_apply_mc's global-memory path.
STENCIL_MC_GLOBAL_TILE = (16, 32)


def stencil_apply_mc(x: torch.Tensor, op: LinearStencilOp, mode: str = "edge") -> torch.Tensor:
    """A cross-channel linear stencil of a (C_in, H, W) f32 or bf16 image;
    returns (C_out, H, W) in the input's type, edge or zero borders.

    Replaces ``pallas_ops.stencil_apply_mc`` (pallas_ops.py:2082), which ran
    a traced closure over all channels of a double-buffered VMEM strip and
    gave up where its strips did not fit VMEM.  Here the function is a
    ``LinearStencilOp`` tap table: a block loads its tile and (rh, rw)
    halo of every input channel into shared memory (clamped or zero-filled
    reads) and each thread runs every output channel's term list as one
    serial chain of rounded products and sums, bit-equal to the plain
    version.  A window that fits no shared memory reads its taps through
    the clamped global coordinate.  No module of either package calls it.

    Bound on the card: device memory at small tables, the term loop (two
    operations a term and pixel) at large ones; its times are in
    PERF.md."""
    _check_image(x, (torch.float32, torch.bfloat16), "stencil_apply_mc")
    _check_mode(mode)
    if x.shape[0] != op.c_in:
        raise ValueError(f"stencil_apply_mc: the table takes {op.c_in} channels, got {x.shape[0]}")
    if not _on_cuda(x):
        return stencil_apply_mc_plain(x, op, mode)
    lib = load_library()
    _c, h, w = x.shape
    weights, pos, start = op.device_terms(x.device)
    tile = choose_stencil_mc_tile(op.c_in, op.rh, op.rw, op.n_terms, op.c_out)
    if tile is None:
        th, tw, smem = (*STENCIL_MC_GLOBAL_TILE, 0)
    else:
        th, tw, smem = tile
    out = torch.empty((op.c_out, h, w), dtype=x.dtype, device=x.device)
    rc = lib.rf_stencil_apply_mc(
        int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(), op.c_in, op.c_out, h, w,
        op.rh, op.rw, int(mode == "zero"), th, tw, int(tile is not None), weights.data_ptr(),
        pos.data_ptr(), start.data_ptr(), op.n_terms, smem, _stream(x),
    )
    _check_launch(lib, rc, "stencil_apply_mc")
    LAUNCHES["stencil_apply_mc"] += 1
    return out
