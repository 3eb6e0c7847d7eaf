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
    (weighted sum of a tap table, median of 3x3) for the per-node tier;
    radius 1 from a register window with no shared memory.
  * ``graph_strip_mc`` (graph_strip_mc.cu): the mc tier's multi-stage
    all-channel megakernel (conv, stencil and point stages; a conv of the
    input reads its own per-channel windows).
  * ``stencil_reduce`` (stencil_reduce.cu): a windowed all-channel
    weighted reduction plus a final map (bilateral) for the per-node
    tier; radii 1-8 with eight outputs a thread from register windows.
  * ``conv1d`` (conv1d.cu) serves ``conv1d_h`` and ``conv1d_w``: the 1-D
    passes of a separable conv whose window fits no shared-memory tile
    of the fused kernels (large-radius box blurs and kuwahara).
  * ``stencil_apply_mc`` (stencil_mc.cu): a cross-channel linear stencil,
    (C_in, H, W) to (C_out, H, W), from a tap table.

The fused conv kernels (``sep_conv_multi``, ``graph_strip``) share a
register-blocked stage (csrc/conv_tile.cuh): a tile's window loads once,
16 bytes a thread (cp.async for f32; clamped reads at the image's
border), each thread computes
eight outputs along a pass from a sliding register window, so a window
value and a tap load from shared memory once a run of eight FMAs, and
outputs leave through a staging tile in whole rows.  Each output is one
FMA chain in ascending tap order.  ``graph_strip_mc`` loads its windows
and runs its conv passes with the same pieces; ``conv1d`` blocks sixteen
outputs a thread, rounding each product and sum.  Each wrapper notes its
time on the card; PERF.md has the bound and the ablation beside it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import trace
from .base import KernelContext, quantize_rgba8, true_divide

# ---- build and bind ---------------------------------------------------------

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/reforge_tpu_torch, found from this file (never the CWD).
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "reforge_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib: Optional[ctypes.CDLL] = None
# One build at a time in a process: an engine's background rebuild and its
# render thread may both reach the first use.
_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_target() -> Path:
    """The library's path, keyed on a hash of the sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"librf_kernels_{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc per source, all started
    together) and link them into one shared library, keyed on a hash of
    the sources and flags, unless that library exists already.  The
    compilers' output (ptxas register and spill counts) goes to
    ``build.log`` beside it."""
    target = library_target()
    if target.exists():
        return target
    key = target.stem.removeprefix("librf_kernels_")
    sources = sorted(CSRC_DIR.glob("*.cu"))
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
    """Build (first use, under a lock) and load the kernels, with every
    argument type declared so that pointers keep their 64 bits."""
    if _lib is None:
        with _build_lock:
            _load_locked()
    return _lib


def _load_locked() -> None:
    global _lib
    if _lib is None:
        with trace.build_span("build.library") as sp:
            sp.attrs["built"] = not library_target().exists()
            lib = ctypes.CDLL(str(build_library()))
            _bind(lib)
        _lib = lib


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every binding's argument and result types."""
    lib.rf_sep_conv_multi.argtypes = [
        _I, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ]
    lib.rf_sep_conv_multi.restype = _I
    lib.rf_graph_strip.argtypes = [
        _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _I, _I, _I, _F, _I, _I, _I, _P,
    ]
    lib.rf_graph_strip.restype = _I
    lib.rf_stencil_apply.argtypes = [
        _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P,
    ]
    lib.rf_stencil_apply.restype = _I
    lib.rf_stencil_r1.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P]
    lib.rf_stencil_r1.restype = _I
    lib.rf_graph_strip_mc.argtypes = [
        _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I,
        _P, _I, _P, _P, _I, _I, _P,
    ]
    lib.rf_graph_strip_mc.restype = _I
    lib.rf_stencil_reduce.argtypes = [
        _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _F, _I, _P,
    ]
    lib.rf_stencil_reduce.restype = _I
    lib.rf_stencil_reduce_run.argtypes = [
        _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _F, _I, _I, _P,
    ]
    lib.rf_stencil_reduce_run.restype = _I
    lib.rf_conv1d.argtypes = [_I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I,
                              _P]
    lib.rf_conv1d.restype = _I
    lib.rf_stencil_apply_mc.argtypes = [
        _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I,
        _I, _I, _P,
    ]
    lib.rf_stencil_apply_mc.restype = _I
    lib.rf_mc_limits.argtypes = [_I]
    lib.rf_mc_limits.restype = _I
    lib.rf_mc_resident.argtypes = [_I, _I]
    lib.rf_mc_resident.restype = _I
    lib.rf_error_string.argtypes = [_I]
    lib.rf_error_string.restype = ctypes.c_char_p
    lib.rf_strip_limits.argtypes = [_I]
    lib.rf_strip_limits.restype = _I


def _launch(x: torch.Tensor, fn, *args) -> int:
    """Call the binding ``fn`` with the card of ``x`` current: a binding
    launches on the current device (the stream it is given is that card's),
    and a slab or stage may lie on another card than the current one."""
    with torch.cuda.device(x.get_device()):
        return fn(*args)


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
# of its window, H-pass buffer and taps.  The conv kernels' runs need TH
# and TW multiples of CONV_RUN, TH a divisor of the block's 256 threads,
# and at most two W-pass runs a thread (csrc/conv_tile.cuh, graph_strip.cu).
TILES = ((32, 128), (32, 64), (16, 64), (16, 32), (8, 32))
# Outputs a thread computes along a pass (csrc kConvRun).
CONV_RUN = 8
# Per-pixel value slots of the graph_strip epilogue, numbered by liveness
# (csrc kMaxSlots), and the convs of its input (csrc kMaxPlans).
MAX_SLOTS = 4
MAX_PLANS = 3
# Ops of a graph_strip op list, which rides in the kernel's parameters
# (csrc kMaxOps).
MAX_OPS = 32


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


def out_aligned(out: torch.Tensor) -> bool:
    """Whether a whole-graph kernel can store into ``out``: graph_strip
    (``store_tile``, conv_tile.cuh) and graph_strip_mc (its ``put``) store
    one element at a time, so they need the element's own alignment, and
    every slice of a contiguous (n, 4, H, W) tensor has it (a bf16 frame
    of an odd H * W starts 8-byte aligned)."""
    return out.data_ptr() % out.element_size() == 0


def _check_out(x: torch.Tensor, out: torch.Tensor, name: str) -> None:
    """``out`` as the output of a kernel of input ``x``: on its device, of
    its dtype and shape, contiguous, apart from it in memory, and aligned
    for the kernel's stores.  Raises on any mismatch."""
    if out.device != x.device:
        raise ValueError(f"{name}: out is on {out.device}, the input on {x.device}")
    if out.dtype != x.dtype:
        raise TypeError(f"{name}: out has dtype {out.dtype}, the input {x.dtype}")
    if out.shape != x.shape:
        raise ValueError(f"{name}: out has shape {tuple(out.shape)}, the input "
                         f"{tuple(x.shape)}")
    if not out.is_contiguous():
        raise ValueError(f"{name}: out must be contiguous")
    (x0, x1), (o0, o1) = _bytes_spanned(x), _bytes_spanned(out)
    if x0 < o1 and o0 < x1:
        raise ValueError(f"{name}: out overlaps the input")
    if not out_aligned(out):
        raise ValueError(f"{name}: out at {out.data_ptr():#x} is not aligned to its "
                         f"{out.element_size()}-byte element")


def _bytes_spanned(t: torch.Tensor) -> tuple[int, int]:
    """The addresses from ``t``'s first element to past its last."""
    if t.numel() == 0:
        return t.data_ptr(), t.data_ptr()
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


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


# The conv kernels' window starts at a multiple of this many image
# columns (csrc kAlign), so that its rows copy 16 bytes a thread.
CONV_ALIGN = 8


def _window_cols(tw: int, rw: int, align: int = CONV_ALIGN) -> tuple[int, int]:
    """(lo, pitch) of a conv window: its column of image column x0 - rw,
    and its row pitch in floats (csrc/conv_tile.cuh run_tile)."""
    lo = (align - rw % align) % align
    return lo, -(-(lo + tw + 2 * rw) // align) * align


def conv_footprint(th: int, tw: int, rh: int, rw: int, n_taps: int, align: int = CONV_ALIGN) -> int:
    """Shared-memory bytes of the conv kernels' layout (csrc/conv_tile.cuh
    RunTile), all f32 whatever the storage type: the window, its first
    column on a multiple of ``align`` image columns; the H-pass buffer of
    odd pitch; the taps."""
    wp = _window_cols(tw, rw, align)[1]
    tp = (tw + 2 * rw) | 1
    return 4 * ((th + 2 * rh) * wp + th * tp + n_taps)


def conv_layout(th: int, tw: int, rh: int, rw: int, n_taps: int) -> tuple[int, int]:
    """(align, shared-memory bytes) of a tile's window: CONV_ALIGN's
    layout, or, where only the packed one fits SMEM_LIMIT (the largest
    radii, up to 108), the packed layout (align 1, every block through
    the clamped reads)."""
    nbytes = conv_footprint(th, tw, rh, rw, n_taps)
    if nbytes <= SMEM_LIMIT:
        return CONV_ALIGN, nbytes
    return 1, conv_footprint(th, tw, rh, rw, n_taps, align=1)


def choose_tile(rh: int, rw: int, n_taps: int) -> Optional[tuple[int, int, int]]:
    """(TH, TW, shared-memory bytes) for a conv window of radii (rh, rw):
    the largest tile under SMEM_SOFT, else under SMEM_LIMIT, else None
    (``conv_layout`` gives the tile's window layout)."""
    for budget in (SMEM_SOFT, SMEM_LIMIT):
        for th, tw in TILES:
            nbytes = conv_layout(th, tw, rh, rw, n_taps)[1]
            if nbytes <= budget:
                return th, tw, nbytes
    return None


def pick_tile(rh: int, rw: int, n_taps: int) -> tuple[int, int, int]:
    """choose_tile, raising when no tile fits.  Callers check first:
    ``ops.sep_conv`` sends a conv that fits no tile to the 1-D kernels,
    and the planners and conv bundles check ``plans_fit``."""
    tile = choose_tile(rh, rw, n_taps)
    if tile is None:
        raise ValueError(f"no tile fits shared memory for radii ({rh}, {rw})")
    return tile


def plans_fit(plans: Sequence) -> bool:
    """Whether the conv kernels can take ``plans`` in one launch."""
    plans = _as_plans(plans)
    n_taps = sum(len(wh) + len(ww) for wh, ww in plans)
    return choose_tile(*_radii(plans), n_taps) is not None


def conv_tile_kinds(h: int, w: int, rh: int, rw: int, n_taps: int) -> tuple[int, int, int, int]:
    """(TH, TW, interior, border): the conv kernels' tile for radii (rh,
    rw) and its blocks of one channel plane of (h, w).  An interior
    block's window lies in the image and loads 16 bytes a thread (where
    the rows are 16-byte aligned, ``w`` a multiple of CONV_ALIGN, and the
    layout is CONV_ALIGN's); a border block reads through the clamped
    coordinate."""
    th, tw, _ = pick_tile(rh, rw, n_taps)
    lo, wp = _window_cols(tw, rw)
    total = -(-h // th) * -(-w // tw)
    if w % CONV_ALIGN or conv_layout(th, tw, rh, rw, n_taps)[0] != CONV_ALIGN:
        return th, tw, 0, total
    rows = sum(1 for y0 in range(0, h, th) if y0 - rh >= 0 and y0 + th + rh <= h)
    cols = sum(1 for x0 in range(0, w, tw) if x0 - rw - lo >= 0 and x0 - rw - lo + wp <= w)
    return th, tw, rows * cols, total - rows * cols


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
    th, tw, _ = pick_tile(rh, rw, taps.numel())
    align, smem = conv_layout(th, tw, rh, rw, taps.numel())
    c, h, w = x.shape
    out = torch.empty((len(plans), c, h, w), dtype=torch.float32, device=x.device)
    rc = _launch(
        x, lib.rf_sep_conv_multi,
        int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(), c, h, w,
        taps.data_ptr(), meta.data_ptr(), len(plans), taps.numel(), rh, rw,
        int(mode == "zero"), th, tw, align, smem, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, rc, "sep_conv_multi")
    return list(out.unbind(0))


def sep_conv_fused(x: torch.Tensor, wh, ww, mode: str = "edge") -> torch.Tensor:
    """One separable conv of an f32 (C, H, W) image, both passes in one
    kernel.

    Replaces ``pallas_ops.sep_conv_fused`` (pallas_ops.py:1723).  The TPU
    kernel streamed whole-width strips through VMEM with in-kernel halo
    padding; here a 2-D tile and its halo load once into shared memory
    (cp.async inside the image, clamped or zero-filled reads at its
    border), and both passes run from there on the register-blocked stage
    of csrc/conv_tile.cuh.

    Bound on the card: the passes' FMAs and shared-memory loads, now one
    window value and one tap a run of eight FMAs, and the device memory
    (264 MB read and written, 0.079 ms).  0.212 ms at 4K f32 radius 12
    (0.61 before the register-blocked stage; H100 80GB HBM3, 700 W).
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

    Bound on the card: the passes, once per conv, and one output plane
    each; the shared window saves every load but the first.  Radii 6 and
    12 at 4K: 0.314 ms (0.90 before the register-blocked stage; H100 80GB
    HBM3, 700 W)."""
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
    pass in bf16.  Here the same kernel reads bf16 (16-byte loads widened
    to an f32 window) and accumulates in f32; the caller rounds once, at
    the node boundary, as the f32 reference path does.

    Bound on the card: the same passes as in f32; bf16 halves the bytes
    read but not the FMAs.  0.228 ms at 4K radius 12 (0.61 before the
    register-blocked stage; H100 80GB HBM3, 700 W)."""
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

    Bound on the card: the passes' 2R+1 FMAs per pass per pixel, from
    registers after one shared-memory load a value and tap a run of
    eight.  0.448 ms at the demo's radius 24 at 4K (1.26 before the
    register-blocked stage; H100 80GB HBM3, 700 W)."""
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
    evaluates; ``plain(ctx, ci, ins, plane)`` computes the same node in
    PyTorch from the builtin's channel form (the plain version's body),
    ``ctx`` the block's KernelContext."""

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
        if len(self.plans) > MAX_PLANS:
            raise ValueError(f"graph_strip takes at most {MAX_PLANS} convs")
        if len(self.ops) > MAX_OPS:
            raise ValueError(f"graph_strip takes at most {MAX_OPS} ops")
        slots = [self.out_slot] + [s for op in self.ops for s in (*op.ins, op.out)]
        if max(slots) >= MAX_SLOTS:
            raise ValueError(f"graph_strip takes at most {MAX_SLOTS} value slots")
        if any(len(op.params) > STRIP_OP_FLOATS for op in self.ops):
            raise ValueError(f"graph_strip ops take at most {STRIP_OP_FLOATS} float params")

    def packed(self) -> tuple[np.ndarray, np.ndarray]:
        """(op ints, op floats) host arrays, built once: the kernel takes
        the op list by value in its parameters."""
        if not self._packed:
            op_i = np.array(
                [[op.code, op.ins[0], op.ins[1], op.out, op.plane] for op in self.ops],
                np.int32,
            ).reshape(-1, 5)
            op_f = np.zeros((len(self.ops), STRIP_OP_FLOATS), np.float32)
            for j, op in enumerate(self.ops):
                op_f[j, : len(op.params)] = op.params
            self._packed.update(op_i=op_i, op_f=op_f)
        return self._packed["op_i"], self._packed["op_f"]


def _store(v: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "rgba8":
        return quantize_rgba8(v)
    if fmt == "rgba16f":
        return v.to(torch.bfloat16).to(torch.float32)
    return v


def _slab_ctx(x: torch.Tensor, t: float, fmt: str, width: int, height: Optional[int],
              row0: int) -> KernelContext:
    """The context of a (C, h, W) input that is rows row0.. of an image of
    ``height`` rows (None: the input is the whole image)."""
    h = x.shape[-2]
    return KernelContext(width=width, height=h if height is None else height, time=t, fmt=fmt,
                         device=x.device, row_offset=row0, local_height=h)


def graph_strip_plain(x: torch.Tensor, t: float, strip: StripProgram, row0: int = 0,
                      height: Optional[int] = None) -> torch.Tensor:
    """The plain version of ``graph_strip``: the convs, then each op's
    channel form over whole planes (``ci`` is a (C, 1, 1) channel index),
    rounding every node's output to storage.  ``row0`` and ``height`` as in
    ``graph_strip``."""
    ctx = _slab_ctx(x, t, strip.fmt, x.shape[-1], height, row0)
    slots: dict[int, Any] = {0: x.to(torch.float32)}
    for k, blur in enumerate(sep_conv_plain(x, strip.plans, "edge")):
        slots[1 + k] = blur
    ci = torch.arange(x.shape[0], device=x.device).view(-1, 1, 1)
    for op in strip.ops:
        plane = strip.aux[op.plane] if op.plane >= 0 else None
        v = op.plain(ctx, ci, [slots[i] for i in op.ins], plane)
        slots[op.out] = _store(v, strip.fmt)
    return slots[strip.out_slot].to(x.dtype)


def graph_strip(x: torch.Tensor, t: float, strip: StripProgram, row0: int = 0,
                height: Optional[int] = None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A whole single-tier graph (N edge-clamped convs of the input, then a
    channel-local epilogue) in one kernel; returns the final output in the
    storage type.  ``x`` may be a slab of a row-sharded image of ``height``
    rows whose first row is image row ``row0`` (the counterpart of the TPU
    kernel's ``row0_base``): coordinates are the image's, the convs clamp
    at the slab's edge, and ``strip.aux`` holds the slab's rows.  The
    defaults are a whole frame.  With ``out`` (``_check_out``) the kernel
    writes there, and returns it, in place of a new tensor.

    Replaces ``pallas_ops.graph_strip_fused`` (pallas_ops.py:1396).  The TPU
    kernel took the epilogue as a traced Python closure and ran rgba16f
    heavy convs as bf16 band matmuls; here the epilogue is the op list of
    ``strip`` (by value in the kernel's parameters) evaluated over groups
    of four pixels whose value slots are registers, and every conv runs
    in f32 from one shared-memory window per tile, its results kept in
    registers, so nothing between the input read and the output write
    touches device memory.

    Bound on the card: the epilogue's op dispatch, slot selects and IEEE
    divisions (half the time), then the convs, against 265 MB of device
    memory (0.089 ms).  The flagship at 4K takes 0.665 ms (rgba16f 0.701;
    1.41 before the redesign; H100 80GB HBM3, 700 W)."""
    dtype = torch.bfloat16 if strip.fmt == "rgba16f" else torch.float32
    _check_image(x, (dtype,), "graph_strip")
    if out is not None:
        _check_out(x, out, "graph_strip")
    if not _on_cuda(x):
        y = graph_strip_plain(x, t, strip, row0, height)
        return y if out is None else out.copy_(y)
    lib = load_library()
    if (MAX_SLOTS, MAX_PLANS, MAX_OPS) != tuple(lib.rf_strip_limits(k) for k in range(3)):
        raise RuntimeError("MAX_SLOTS, MAX_PLANS or MAX_OPS disagrees with the built kernel")
    c, h, w = x.shape
    aux = strip.aux
    if aux is not None and (
        aux.device != x.device or aux.dtype != torch.float32
        or tuple(aux.shape[1:]) != (h, w) or not aux.is_contiguous()
    ):
        raise ValueError("aux must be a contiguous (n, H, W) f32 tensor on the input's device")
    taps, meta = _taps_for(strip.plans, x.device)
    op_i, op_f = strip.packed()
    rh, rw = _radii(strip.plans)
    th, tw, _ = pick_tile(rh, rw, taps.numel())
    align, smem = conv_layout(th, tw, rh, rw, taps.numel())
    if out is None:
        out = torch.empty_like(x)
    channel_ops = any(op.code >= OP_CH0 for op in strip.ops)
    rc = _launch(
        x, lib.rf_graph_strip,
        int(dtype == torch.bfloat16), int(channel_ops), x.data_ptr(), out.data_ptr(),
        0 if aux is None else aux.data_ptr(), c, h, w, taps.data_ptr(), meta.data_ptr(),
        len(strip.plans), taps.numel(), rh, rw, th, tw, align, op_i.ctypes.data, op_f.ctypes.data,
        len(strip.ops), strip.out_slot, STORE_MODES[strip.fmt], float(t), int(row0),
        h if height is None else int(height), smem, torch.cuda.current_stream(x.device).cuda_stream,
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


def _ascending(terms, cols: int) -> bool:
    """True when the terms' positions (dy, dx) strictly ascend in row-major
    order of a table ``cols`` wide (each at most once)."""
    keys = [dy * cols + dx for dy, dx, *_ in terms]
    return all(a < b for a, b in zip(keys, keys[1:]))


def choose_stencil_form(rh: int, rw: int, op: StencilOp) -> str:
    """The form of the stencil kernel that evaluates ``op``, by shape:
    ``"r1"`` (csrc/stencil.cu stencil_r1_kernel, from registers) for the
    median and for a 3x3 table whose terms ascend in (dy, dx) -- every
    shipped table --, else ``"general"`` (stencil_kernel, from a shared-memory
    window)."""
    if (rh, rw) != (1, 1):
        return "general"
    return "r1" if op.kind == "median9" or _ascending(op.terms, 3) else "general"


@functools.lru_cache(maxsize=64)
def _r1_taps(terms: tuple) -> tuple[np.ndarray, int]:
    """(the nine weights f32 at 3 dy + dx, the mask of the terms' positions)
    of a 3x3 table's terms, for the radius-1 form."""
    w = np.zeros(9, np.float32)
    mask = 0
    for dy, dx, wt in terms:
        w[3 * dy + dx] = wt
        mask |= 1 << (3 * dy + dx)
    return w, mask


def _vec(*tensors: torch.Tensor) -> bool:
    """True when every tensor starts on a 16-byte boundary and its rows do
    too (the last dimension a multiple of 4 floats)."""
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] % 4 == 0 for t in tensors)


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
    strip.  Here the function is a ``StencilOp``, evaluated per pixel --
    the ``wsum`` terms with ``__fmul_rn``/``__fadd_rn`` in ``conv2d``'s
    order (so the laplacian's cancellation rounds as the plain version
    does), or the median network -- by one of two forms
    (``choose_stencil_form``): at radius 1 each thread makes eight
    outputs of a row from a 3-row register window slid down its column,
    reading 16 bytes at a time from global memory; any other radius loads
    its tile and halo into shared memory with clamped or zero-filled
    reads.

    Bound on the card: device memory (one read and one write per pixel;
    sharpen needs 9 f32 instructions a pixel, median9 38).  Its times are
    in PERF.md."""
    _check_image(x, (torch.float32,), "stencil_apply")
    _check_mode(mode)
    _check_stencil(rh, rw, op)
    if not _on_cuda(x):
        return stencil_apply_plain(x, rh, rw, op, mode)
    lib = load_library()
    c, h, w = x.shape
    out = torch.empty_like(x)
    if choose_stencil_form(rh, rw, op) == "r1":
        w9, mask = _r1_taps(op.terms)
        rc = _launch(
            x, lib.rf_stencil_r1,
            x.data_ptr(), out.data_ptr(), c, h, w, int(mode == "zero"), _STENCIL_KINDS[op.kind],
            w9.ctypes.data, mask, int(_vec(x, out)), _stream(x),
        )
        _check_launch(lib, rc, "stencil_apply")
        LAUNCHES["stencil_apply"] += 1
        return out
    terms_w, terms_idx = _device_terms(op.terms, x.device)
    th, tw, smem = choose_stencil_tile(rh, rw, len(op.terms))
    rc = _launch(
        x, lib.rf_stencil_apply,
        x.data_ptr(), out.data_ptr(), c, h, w, rh, rw, int(mode == "zero"), th, tw,
        _STENCIL_KINDS[op.kind], terms_w.data_ptr(), terms_idx.data_ptr(), len(op.terms),
        smem, _stream(x),
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
# A GLSL point shader, all channels: its op list (glsl/lower.py
# PointProgram.packed) as the int words of tap list 0 (floats unused),
# evaluated at each pixel by the kernel's glsl form.
MC_GLSL = MC_AFFINE + 1
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
# Output tiles (rows, cols) the mc kernel may take; McProgram.tile picks
# among them by its estimated work.  The footprint that leaves two blocks
# an SM (the SM's 228 KB less each block's 1 KB reserve and 1.1 KB of
# static dense tables), and the dynamic shared memory one block may take.
MC_TILES = ((32, 128), (64, 64), (32, 64), (16, 128), (64, 32), (32, 32), (16, 64), (16, 32),
            (16, 16), (8, 16), (8, 8))
MC_SMEM_SOFT = 111 * 1024
MC_SMEM_LIMIT = SMEM_LIMIT - 4096
# Buffers for a conv's per-channel windows of the input: two (the next
# channel's copy in flight beside this one's passes) or one (a larger tile
# in the same footprint); McProgram.tile weighs both.  At the same tile two
# ran glsl-blur rgba16f 0.9% and glsl-blur-sharpen rgba16f 3.4% faster
# than one (an A/B on the card; PERF.md §6).
MC_WINDOW_BUFFERS = (2, 1)
# The glsl form's op list (csrc graph_strip_mc.cu glsl_cells): the pixels a
# thread it is compiled for, so that a register file's plane holds 256 x
# pixels values, one a pixel of each of the block's 256 threads.  A plan
# takes the first where its tile is chosen, and a later one where its
# files fit beside that same tile (McProgram.tile).  Four pixels ran
# glsl-chain's op list at 0.61 the time of two, but at a smaller tile
# glsl-chain rgba16f 1.38x slower (an A/B on the card; PERF.md §6).
MC_GLSL_PIXELS = (2, 4)
# The glsl form's wide op word (glsl/lower.py PointProgram.packed, header
# flag 4): lists past the narrow word's fields, and lists whose register
# files fit no tile at MC_GLSL_PIXELS[0], run it at one pixel a thread,
# their files in device memory, one file for each block the card holds at
# once (at most MC_FILES_DEVICE_LIMIT bytes a block).  Files in shared
# memory left one block an SM, and ran a 721-op list 1.23x slower than
# files in device memory, which leave two (PERF.md).
MC_FILES_DEVICE_LIMIT = 4 << 20
# MC_GLSL stages' inputs past the second, in the launch's table (csrc
# graph_strip_mc.cu kMcGlslInputs).
MC_GLSL_INPUTS = 24
# Buffer markers of a packed stage (csrc graph_strip_mc.cu McBuf): none,
# the kernel input in device memory (a conv's per-channel windows), the
# input block.
MC_BUF_NONE, MC_BUF_GLOBAL, MC_BUF_INPUT_BLOCK = -1, -2, -3


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
    point op's) tables, or an MC_GLSL stage's op list (its int words);
    ``plain`` computes the stage in PyTorch over whole images from the
    node's own forms: point ``plain(ctx, ins)``, stencil ``plain(ctx,
    tap)``, conv ``plain(ctx, x, blur)``."""

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


def glsl_file_floats(words, pixels: int) -> int:
    """Shared-memory floats of an MC_GLSL stage's register files at
    ``pixels`` a thread, from its packed program's header (glsl/lower.py
    PointProgram.packed): a plane of 256 x pixels floats for each live
    float register, two floats wide for each integer one."""
    return (int(words[1]) + 2 * int(words[2])) * 256 * pixels


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
    extent (``rh_in`` rows, ``ew_in`` columns), the frame, the storage
    format and the whole plan's border mode (``"edge"`` or ``"zero"``:
    what the input block and a conv's windows read outside the image)."""

    stages: list
    n_slots: int
    rh_in: int
    ew_in: int
    width: int
    height: int
    fmt: str
    mode: str = "edge"
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        _check_mode(self.mode)
        if len(self.stages) > MC_MAX_STAGES:
            raise ValueError(f"graph_strip_mc takes at most {MC_MAX_STAGES} stages")
        # an op list in the wide op word (its header's flag 4)
        wide = [int(st.taps[0][9]) & 4 for st in self.stages if st.op.code == MC_GLSL]
        if any(wide) and not all(wide):
            # one kernel form a plan: every list in the wide word
            from ..glsl import lower

            self.stages = [dataclasses.replace(st, taps=(lower.widen(st.taps[0]),))
                           if st.op.code == MC_GLSL else st for st in self.stages]
        self._wide = any(wide)
        # an op list starts on an even word, a wide one on a multiple of four
        align = 4 if self._wide else 2
        ws, idxs, self._lists = [], [], []
        off = 0
        for st in self.stages:
            if len(st.op.params) > 4:
                raise ValueError("mc ops take at most 4 float params")
            if st.kind == MC_CONV:
                wh, ww = (np.asarray(v, np.float32) for v in st.taps)
                parts = [(wh, np.zeros(len(wh), np.int32)), (ww, np.zeros(len(ww), np.int32))]
            elif st.op.code == MC_GLSL:
                words = np.asarray(st.taps[0], np.int32)
                parts = [(np.zeros(len(words), np.float32), words)]
            else:
                parts = [_term_arrays(wsum(tab).terms) for tab in st.taps]
            if st.op.code == MC_GLSL and off % align:
                # the kernel reads an op in one 8-byte (16-byte: wide) load
                pad = align - off % align
                ws.append(np.zeros(pad, np.float32))
                idxs.append(np.zeros(pad, np.int32))
                off += pad
            lists = []
            for w, idx in parts:
                lists += [off, len(w)]
                ws.append(w)
                idxs.append(idx)
                off += len(w)
            self._lists.append((lists + [0, 0, 0, 0])[:4])
        self._glsl = [st.taps[0] for st in self.stages if st.op.code == MC_GLSL]
        # an op list calls sinf, cosf or tanf (its header's flags): the
        # kernel's trig forms
        self._trig = any(int(w[9]) & 1 for w in self._glsl)
        # and loops, shifts, bit casts or a third image (the forms that
        # evaluate them)
        self._ext = any(int(w[9]) & 2 for w in self._glsl)
        # and gathers from the kernel input (the gather forms)
        self._gather = any(int(w[9]) & 8 for w in self._glsl)
        if self._glsl and off % align:
            # a count of the alignment, so that the positions (the op
            # lists) start on an aligned word of shared memory after them
            ws.append(np.zeros(align - off % align, np.float32))
            idxs.append(np.zeros(align - off % align, np.int32))
        self.taps = np.concatenate(ws) if ws else np.zeros(0, np.float32)
        self.term_idx = np.concatenate(idxs) if idxs else np.zeros(0, np.int32)

    def _input_block(self) -> tuple[int, int, bool]:
        """(eh, ew, used) of the four-channel input block: the extents at
        which stages read the graph input in shared memory.  A conv of the
        input reads its own per-channel windows (``_windows``) instead, and
        an op list counts only the inputs it reads at the pixel (LOAD,
        LOADX), not those it gathers from device memory.  Kept once worked
        out: every launch's ``geometry`` reads it."""
        if "input_block" in self._cache:
            return self._cache["input_block"]
        from ..glsl import lower

        eh = ew = 0
        used = False
        for st in self.stages:
            lift = st.r if st.kind == MC_STENCIL else 0
            refs = list(st.ins[1:] if st.kind == MC_CONV else st.ins) + [st.x]
            if st.op.code == MC_GLSL:
                refs = [st.ins[k] for k in sorted(lower.pixel_reads(st.taps[0]))]
            for ref in refs:
                if ref is not None and ref[0] == MC_INPUT:
                    eh, ew, used = max(eh, st.eh + lift), max(ew, st.ew + lift), True
        self._cache["input_block"] = (eh, ew, used)
        return eh, ew, used

    def _windowed(self, st: McStage) -> bool:
        return st.kind == MC_CONV and st.ins[0][0] == MC_INPUT

    def _files(self, pixels: int) -> int:
        """Floats of the largest MC_GLSL stage's register files (0 where
        the plan has none)."""
        return max((glsl_file_floats(w, pixels) for w in self._glsl), default=0)

    def _pixel_options(self) -> tuple:
        """The pixels a thread the plan's op lists may run at: the narrow
        forms' MC_GLSL_PIXELS, or the wide form's one."""
        return (1,) if self._wide else MC_GLSL_PIXELS

    def _layout(self, th: int, tw: int, n_win: int = 2, pixels: Optional[int] = None):
        """(slot float offsets, bytes, geometry) of the shared-memory layout
        for a (th, tw) tile: the input block (conv_tile.cuh's window
        layout, rows from a multiple of CONV_ALIGN columns), the pool slots
        (each sized for the largest resource it holds, rows of odd pitch,
        csrc graph_strip_mc.cu ``pitch``), two buffers for the largest
        per-channel window of a conv of the input (``n_win`` of them), the
        conv H-pass scratch (two halves), the taps and their positions.
        The register files of the plan's MC_GLSL stages (the largest,
        ``glsl_file_floats`` at ``pixels`` a thread) overlay the windows
        and the scratch, which no point stage touches: they add bytes only
        past that span, and a plan with no op list, or whose lists are in
        the wide op word (files in device memory), adds none.  In a plan with an op
        list the taps start on an even word (the lists' 8-byte reads; a
        multiple of four words for the wide word's 16-byte reads).  The
        geometry is the kernel's ten ints: scratch offset, taps offset,
        the input block's extent and whether a stage reads it, the windows'
        offset, size and count, the op lists' pixels a thread and their
        flags (1: one calls sinf, cosf or tanf; 2: one has loops, shifts,
        bit casts or reads a third image; 4: the wide op word, its files
        in device memory; 8: one gathers from the kernel input)."""
        if pixels is None:
            pixels = self._pixel_options()[0]
        def block(eh, ew):
            return 4 * (th + 2 * eh) * ((tw + 2 * ew) | 1)

        def window(eh, ew):
            return (th + 2 * eh) * _window_cols(tw, ew)[1]

        in_eh, in_ew, in_used = self._input_block()
        cap = [0] * self.n_slots
        scratch = win = 0
        for st in self.stages:
            if st.out >= 0:
                cap[st.out] = max(cap[st.out], block(st.eh, st.ew))
            if st.kind == MC_CONV:
                rh, rw = ((len(v) - 1) // 2 for v in st.taps)
                scratch = max(scratch, 2 * (th + 2 * st.eh) * ((tw + 2 * st.ew + 2 * rw) | 1))
                if self._windowed(st):
                    win = max(win, window(st.eh + rh, st.ew + rw))
        off = 4 * window(in_eh, in_ew) if in_used else 0
        slot_off = []
        for c in cap:
            slot_off.append(off)
            off += c
        win_off = -(-off // CONV_ALIGN) * CONV_ALIGN  # 16-byte aligned for cp.async
        scratch_off = win_off + n_win * win
        files = 0 if self._wide else self._files(pixels)
        taps_off = max(scratch_off + scratch, win_off + files)
        if self._glsl:
            align = 4 if self._wide else 2
            taps_off += -taps_off % align
        flags = (int(self._trig) | int(self._ext) << 1 | int(self._wide) << 2
                 | int(self._gather) << 3)
        geo = np.array([scratch_off, taps_off, in_eh, in_ew, int(in_used), win_off, win, n_win,
                        pixels, flags], np.int32)
        return slot_off, 4 * (taps_off + 2 * len(self.taps)), geo

    def _work(self, th: int, tw: int) -> float:
        """Estimated work an output pixel of a (th, tw) tile: the elements
        loaded (input block and conv windows), the conv FMAs of both passes
        over each stage's extended block (the H pass also over the halo
        columns), the stencils' rounded products and sums, about 20
        operations a point stage's pixel (an op list's: about 10 an op it
        runs, ``glsl.lower.packed_work``); so halo recompute and load per output,
        which fall as the tile grows."""
        def area(eh, ew):
            return (th + 2 * eh) * (tw + 2 * ew)

        in_eh, in_ew, in_used = self._input_block()
        work = 4.0 * area(in_eh, in_ew) if in_used else 0.0
        for st in self.stages:
            if st.kind == MC_CONV:
                nh, nw = (len(v) for v in st.taps)
                rw = (nw - 1) // 2
                work += 4.0 * ((th + 2 * st.eh) * (tw + 2 * st.ew + 2 * rw) * nh
                               + area(st.eh, st.ew) * nw)
                if self._windowed(st):
                    work += 4.0 * area(st.eh + (nh - 1) // 2, st.ew + rw)
            elif st.kind == MC_STENCIL:
                terms = sum(int(np.count_nonzero(t)) for t in st.taps) or 19
                work += area(st.eh, st.ew) * 3 * 2 * terms
            elif st.op.code == MC_GLSL:
                from ..glsl import lower  # a loop's ops times its trip bound

                work += area(st.eh, st.ew) * 10 * lower.packed_work(st.taps[0])  # ~10 an op
            else:
                work += area(st.eh, st.ew) * 20
        return work / (th * tw)

    @property
    def input_halo(self) -> int:
        """Rows of the graph input that the whole plan reads around a tile
        (at least 1): the halo a row-sharded slab exchanges once before the
        kernel runs on it (parallel/halo.py).  A plan that gathers reads
        any row: the image's height, so a slab takes the per-node route."""
        return self.height if self._gather else max(self.rh_in, 1)

    @property
    def edge_hazard(self) -> bool:
        """Whether a conv or stencil stage reads an intermediate.  The
        kernel clamps an intermediate at the edge of the block it runs on,
        so on a slab extended by replicated rows such a plan differs from
        the unsharded one near the image's edge; the slab executor then
        runs the edge slabs on blocks that end at the image's edge."""
        return any(st.kind in (MC_CONV, MC_STENCIL) and st.ins[0][0] != MC_INPUT
                   for st in self.stages)

    def halo_work(self) -> tuple[float, float]:
        """(work, halo): ``_work`` at the chosen tile, and the part of it
        that the halo adds (its excess over the limit as the tile grows):
        the recompute a fused plan pays where per-node execution pays a
        store and a load at each node."""
        th, tw, _smem = self.tile()
        work = self._work(th, tw)
        return work, work - self._work(1 << 20, 1 << 20)

    def device_file_bytes(self) -> int:
        """Bytes of device memory a block's register files take in the
        wide form (the largest list's, at one pixel a thread)."""
        return 4 * self._files(1)

    def _past_limit(self) -> Optional[str]:
        """The launch's limit the plan passes, or None: the op lists'
        inputs past the second (the launch's table, MC_GLSL_INPUTS), a
        wide list's files in device memory (MC_FILES_DEVICE_LIMIT a
        block), or gathers in the wide op word (no such form)."""
        if self.n_glsl_inputs > MC_GLSL_INPUTS:
            return (f"its GLSL point stages read {self.n_glsl_inputs} images past their "
                    f"second, past the launch's table of {MC_GLSL_INPUTS}")
        if self._wide and self.device_file_bytes() > MC_FILES_DEVICE_LIMIT:
            return (f"its op lists' register files take {self.device_file_bytes()} bytes a "
                    f"block of device memory, past {MC_FILES_DEVICE_LIMIT}")
        if self._wide and self._gather:
            return "its op lists gather in the wide op word, which no kernel form reads"
        return None

    def _choice(self):
        """(TH, TW, window buffers, bytes, pixels a thread) of ``tile``, or
        None."""
        if "tile" not in self._cache:
            self._cache["tile"] = None
            if self._past_limit() is not None:
                return None
            n_wins = MC_WINDOW_BUFFERS if any(map(self._windowed, self.stages)) else (2,)
            pix = self._pixel_options()
            layouts = {(th, tw, n): self._layout(th, tw, n, pix[0])[1]
                       for th, tw in MC_TILES for n in n_wins}
            for budget in (MC_SMEM_SOFT, MC_SMEM_LIMIT):
                fits = [k for k in layouts if layouts[k] <= budget]
                if fits:
                    best = min(fits, key=lambda k: self._work(k[0], k[1]))
                    choice = (*best, layouts[best], pix[0])
                    for pixels in pix[1:] if self._glsl else ():
                        nbytes = self._layout(*best, pixels)[1]
                        if nbytes <= budget:
                            choice = (*best, nbytes, pixels)
                    self._cache["tile"] = choice
                    break
        return self._cache["tile"]

    def widened(self) -> Optional["McProgram"]:
        """This plan with its op lists in the wide op word (the wide form,
        one pixel a thread, files in device memory), or None where it has
        no narrow list: the planner's fallback where a narrow list's files
        fit no tile at MC_GLSL_PIXELS[0]."""
        if not self._glsl or self._wide:
            return None
        from ..glsl import lower

        stages = [dataclasses.replace(st, taps=(lower.widen(st.taps[0]),))
                  if st.op.code == MC_GLSL else st for st in self.stages]
        return McProgram(stages=stages, n_slots=self.n_slots, rh_in=self.rh_in,
                         ew_in=self.ew_in, width=self.width, height=self.height, fmt=self.fmt,
                         mode=self.mode)

    @property
    def n_glsl_inputs(self) -> int:
        """The MC_GLSL stages' inputs past the second (the launch's table:
        at most MC_GLSL_INPUTS)."""
        return sum(max(0, len(st.ins) - 2) for st in self.stages if st.op.code == MC_GLSL)

    def tile(self) -> Optional[tuple[int, int, int]]:
        """(TH, TW, shared-memory bytes): of the MC_TILES whose layout (with
        two window buffers, or one: MC_WINDOW_BUFFERS; op lists' files at
        MC_GLSL_PIXELS[0] pixels a thread) fits MC_SMEM_SOFT (two blocks an
        SM), else MC_SMEM_LIMIT, the one of least estimated work (``_work``:
        halo recompute and load against the tile's size; two buffers first
        where the work ties); then the op lists take the last of
        MC_GLSL_PIXELS whose files fit beside that tile in the same budget.
        Wide lists take one pixel a thread, their files in device memory
        (the layout without them).  None where none fits, or where the plan
        passes a limit of the launch (``_past_limit``): the planner then
        refuses the plan."""
        choice = self._choice()
        return None if choice is None else (choice[0], choice[1], choice[3])

    def refusal(self) -> Optional[str]:
        """Why ``tile`` finds no tile (None where it finds one): the
        launch's limit the plan passes, or the smallest layout's bytes and
        the op lists' register files among them."""
        if self.tile() is not None:
            return None
        limit = self._past_limit()
        if limit is not None:
            return limit
        pixels = self._pixel_options()[0]
        need = min(self._layout(th, tw, n, pixels)[1]
                   for th, tw in MC_TILES for n in MC_WINDOW_BUFFERS)
        reason = (f"the smallest tile's layout takes {need} bytes of shared memory, past "
                  f"{MC_SMEM_LIMIT}")
        if self._wide:
            reason += " (the op lists' register files in device memory, not among them)"
        elif self._glsl:
            regs = ", ".join(f"{int(w[1])} float and {int(w[2])} integer" for w in self._glsl)
            reason += (f"; {4 * self._files(pixels)} of them the GLSL op lists' "
                       f"register files ({regs} registers, {pixels} pixels a thread)")
        return reason

    def geometry(self, th: int, tw: int) -> np.ndarray:
        """The layout's ten ints for the kernel (``_layout``), with the
        window buffers and pixels a thread ``tile`` chose."""
        choice = self._choice()
        n_win, pixels = (choice[2], choice[4]) if choice else (2, self._pixel_options()[0])
        return self._layout(th, tw, n_win, pixels)[2]

    def packed(self, th: int, tw: int):
        """(stage ints, stage floats, scratch offset, taps offset) for the
        kernel: host arrays of MC_STAGE_INTS ints and 4 floats a stage.  A
        buffer is (offset, eh, ew): a slot's float offset, MC_BUF_INPUT_BLOCK
        with the input block's extent, MC_BUF_GLOBAL for a conv of the
        input (its windows), MC_BUF_NONE.  An MC_GLSL stage's inputs past
        the second go to the launch's table (``glsl_inputs``) as their views
        at the stage's extent, its list 1 (t1, n1) the first of them there
        and their count."""
        key = ("packed", th, tw)
        if key not in self._cache:
            slot_off, _bytes, geo = self._layout(th, tw, *self.geometry(th, tw)[[7, 8]])
            in_block = [MC_BUF_INPUT_BLOCK, int(geo[2]), int(geo[3])]

            def place(ref, eh, ew):
                """A buffer's view at extent (eh, ew) (csrc ``view``): its
                float offset in shared memory, pitch and plane, the same
                in every block (the input block's columns start at
                ``_window_cols``'s lo whatever the block)."""
                slot, r_eh, r_ew = ref
                if slot == MC_INPUT:
                    r_eh, r_ew = in_block[1:]
                    base, pt = _window_cols(tw, r_ew)
                else:
                    base, pt = slot_off[slot], (tw + 2 * r_ew) | 1
                return [base + (r_eh - eh) * pt + (r_ew - ew), pt, (th + 2 * r_eh) * pt]

            def buf(ref, windowed=False):
                if ref is None:
                    return [MC_BUF_NONE, 0, 0]
                slot, eh, ew = ref
                if slot == MC_INPUT:
                    return [MC_BUF_GLOBAL, 0, 0] if windowed else in_block
                return [slot_off[slot], eh, ew]

            rows_i, rows_f, more = [], [], []
            for st, lists in zip(self.stages, self._lists):
                ins = list(st.ins) + [None] * (2 - len(st.ins))
                if st.op.code == MC_GLSL and len(st.ins) > 2:
                    lists = [*lists[:2], len(more), len(st.ins) - 2]
                    more += [place(ref, st.eh, st.ew) for ref in st.ins[2:]]
                rh = rw = st.r
                if st.kind == MC_CONV:
                    rh, rw = ((len(v) - 1) // 2 for v in st.taps)
                rows_i.append(
                    [st.kind, st.op.code, len(st.ins), *buf(ins[0], self._windowed(st)),
                     *buf(ins[1]), *buf(st.x), -1 if st.out == MC_OUTPUT else slot_off[st.out],
                     st.eh, st.ew, rh, rw, *lists, int(st.store)]
                )
                rows_f.append((list(st.op.params) + [0.0] * 4)[:4])
            stage_i = np.ascontiguousarray(np.array(rows_i, np.int32).reshape(-1, MC_STAGE_INTS))
            stage_f = np.ascontiguousarray(np.array(rows_f, np.float32).reshape(-1, 4))
            self._cache[("inputs", th, tw)] = np.ascontiguousarray(
                np.array(more, np.int32).reshape(-1))
            self._cache[key] = (stage_i, stage_f, int(geo[0]), int(geo[1]))
        return self._cache[key]

    def glsl_inputs(self, th: int, tw: int) -> np.ndarray:
        """The launch's table of the MC_GLSL stages' inputs past the
        second: three ints each, a view (offset, pitch, plane) as
        ``packed`` places it."""
        self.packed(th, tw)
        return self._cache[("inputs", th, tw)]

    def device_taps(self, device: torch.device):
        key = ("taps", device)
        if key not in self._cache:
            self._cache[key] = (torch.from_numpy(self.taps).to(device),
                                torch.from_numpy(self.term_idx).to(device))
        return self._cache[key]


def graph_strip_mc_plain(x: torch.Tensor, t: float, prog: McProgram,
                         row0: int = 0) -> torch.Tensor:
    """The plain version of ``graph_strip_mc``, and the mc tier's CPU path:
    the stage list over whole images (convs and stencils with clamped
    taps, or zeros outside the image in zero mode), rounding each node's
    output to storage.  ``row0`` as in ``graph_strip_mc``."""
    ctx = _slab_ctx(x, t, prog.fmt, prog.width, prog.height, row0)
    h, w = x.shape[-2], x.shape[-1]
    vals: dict[int, torch.Tensor] = {MC_INPUT: x.to(torch.float32)}
    for st in prog.stages:
        ins = [vals[slot] for slot, _eh, _ew in st.ins]
        if st.kind == MC_CONV:
            blur = sep_conv_plain(ins[0], [st.taps], prog.mode)[0]
            v = st.plain(ctx, vals[st.x[0]] if st.x is not None else None, blur)
        elif st.kind == MC_STENCIL:
            xp = _padded(ins[0], st.r, st.r, prog.mode)
            v = st.plain(ctx, lambda dy, dx, _xp=xp: _xp[:, dy : dy + h, dx : dx + w])
        else:
            v = st.plain(ctx, ins)
        vals[st.out] = _store(v, prog.fmt) if st.store else v
    return vals[MC_OUTPUT].to(x.dtype)


def graph_strip_mc(x: torch.Tensor, t: float, prog: McProgram, row0: int = 0,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A whole multi-stage graph in one kernel; returns the final output in
    the storage type.  ``x`` may be a slab of rows of the program's frame
    (a row-sharded image, extended by its halo) whose first row is image
    row ``row0`` (the counterpart of the TPU kernel's ``row0_base``): the
    point stages' coordinates are the image's, every read clamps (or reads
    zeros) at the slab's edge.  With ``out`` (``_check_out``) the kernel
    writes there, and returns it, in place of a new tensor.

    Replaces ``pallas_ops.graph_strip_fused_mc`` (pallas_ops.py:2955),
    which streamed channel-full whole-width strips through VMEM with a
    DMA double buffer, carried conv rows between strips and ran heavy
    convs as MXU band matmuls.  Here a block owns a 2-D tile with all four
    channels.  Each stage computes its output over the tile plus its own
    extent into a shared-memory pool slot.  A conv of the input reads its
    own window of each channel (one or two buffers, 16-byte copies), so
    the four-channel input block holds only what the other stages read;
    a border block fills the outside cells of each slot it writes with
    the clamped values, so that every stage reads shared memory unclamped
    and the tier reproduces per-node execution's edge padding of every
    intermediate without computing outside the image.  In a plan of zero
    mode (``McProgram.mode``) the input block and the windows read zeros
    outside the image instead.  A GLSL point shader's stage (MC_GLSL)
    evaluates its op list, several pixels a thread, over register files in
    shared memory; such plans, and those of zero mode, run the kernel's
    glsl form.  Lists in the wide op word run its wide form, one pixel a
    thread, their files in a scratch of device memory this call allocates
    (a file for each block the card holds at once, ``_mc_resident``).
    Lists that gather (a channel of ``x`` at a computed point) run a
    gather form, which reads ``x`` through the read-only cache; a plan
    whose stages read ``x`` only so loads no input block.  The tile is
    the one of least estimated work (halo recompute and load) that leaves
    two blocks an SM (``McProgram.tile``).

    Bound on the card: issue slots, mostly the conv FMAs, which the
    halo columns of the H pass and the halo rows and columns of each
    stage's extent multiply (the demo's blur sigma 8 at its 16x64 tile:
    2.75 FMAs an output and tap).  Times (demo 3840x2160 rgba32f: 0.900
    ms, 1.856 before this design; H100 80GB HBM3 at 700 W; an A/B on the
    card) are in PERF.md §6."""
    dtype = torch.bfloat16 if prog.fmt == "rgba16f" else torch.float32
    _check_image(x, (dtype,), "graph_strip_mc")
    if x.dim() != 3 or x.shape[0] != 4 or x.shape[2] != prog.width:
        raise ValueError(f"graph_strip_mc: expected (4, {prog.height}, {prog.width}) or a slab "
                         f"of its rows, got {tuple(x.shape)}")
    if out is not None:
        _check_out(x, out, "graph_strip_mc")
    if not _on_cuda(x):
        y = graph_strip_mc_plain(x, t, prog, row0)
        return y if out is None else out.copy_(y)
    lib = load_library()
    if (lib.rf_mc_limits(0), lib.rf_mc_limits(1), lib.rf_mc_limits(2)) != (
            MC_MAX_STAGES, MC_STAGE_INTS, MC_GLSL_INPUTS):
        raise RuntimeError("MC_MAX_STAGES/MC_STAGE_INTS/MC_GLSL_INPUTS disagree with the built "
                           "kernel")
    tile = prog.tile()
    if tile is None:
        raise ValueError("graph_strip_mc: no tile fits this plan (the planner refuses it)")
    th, tw, smem = tile
    stage_i, stage_f, _scratch_off, _taps_off = prog.packed(th, tw)
    geo = prog.geometry(th, tw)
    more = prog.glsl_inputs(th, tw)
    taps, term_idx = prog.device_taps(x.device)
    bf16 = int(dtype == torch.bfloat16)
    files = locks = None
    slots = file_floats = 0
    if prog._wide:
        # The wide form's register files in device memory: one file for
        # each block the card holds at once, and a lock word each.
        file_floats = prog.device_file_bytes() // 4
        slots = _mc_resident(lib, x, bf16, smem)
        files = torch.empty(slots * file_floats, dtype=torch.float32, device=x.device)
        locks = torch.zeros(slots, dtype=torch.int32, device=x.device)
    if out is None:
        out = torch.empty_like(x)
    vec = prog.width % CONV_ALIGN == 0 and x.data_ptr() % 16 == 0
    rc = _launch(
        x, lib.rf_graph_strip_mc,
        bf16, x.data_ptr(), out.data_ptr(), x.shape[1], prog.width,
        th, tw, geo.ctypes.data, stage_i.ctypes.data, stage_f.ctypes.data, len(prog.stages),
        taps.data_ptr(), term_idx.data_ptr(), len(prog.taps), STORE_MODES[prog.fmt], float(t),
        int(vec), int(prog.mode == "zero"), int(row0), prog.height, smem,
        more.ctypes.data, len(more) // 3, files.data_ptr() if files is not None else None,
        locks.data_ptr() if locks is not None else None, slots, file_floats,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, rc, "graph_strip_mc")
    LAUNCHES["graph_strip_mc"] += 1
    return out


_MC_RESIDENT: dict[tuple, int] = {}


def _mc_resident(lib: ctypes.CDLL, x: torch.Tensor, bf16: int, smem: int) -> int:
    """Blocks of the wide glsl form the card of ``x`` holds at once with
    ``smem`` bytes of dynamic shared memory (the occupancy calculator
    times the SMs): the register files' slots in device memory."""
    key = (x.get_device(), bf16, smem)
    if key not in _MC_RESIDENT:
        n = _launch(x, lib.rf_mc_resident, bf16, smem)
        if n <= 0:
            _check_launch(lib, -n or 1, "graph_strip_mc (occupancy)")
        _MC_RESIDENT[key] = n
    return _MC_RESIDENT[key]


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
# Radii with a compiled run form (csrc/stencil_reduce.cu
# rf_stencil_reduce_run), its outputs a thread (kReduceRun) and its tile:
# 32 rows (a warp's lanes) by a run for each of the 8 warps.  A block may
# take REDUCE_RUN_SMEM (kReduceRunSmem): two blocks an SM (ptxas gives
# the forms 80-128 registers, so no more fit), each beside the 1 KB the
# SM keeps for a block.
REDUCE_RUN_RADII = tuple(range(1, 9))
REDUCE_RUN = 8
REDUCE_RUN_TILE = (32, 8 * REDUCE_RUN)
REDUCE_RUN_SMEM = 110 * 1024


def reduce_run_footprint(r: int) -> int:
    """Shared-memory bytes of the run form at radius ``r``
    (csrc/stencil_reduce.cu RunWindow): a window of four channels of
    (TH + 2r) rows at the odd pitch of the tile's TW + 2r columns from the
    multiple of 4 at or before x0 - r -- two of them where both fit
    REDUCE_RUN_SMEM beside the tables (the next tile's loads while this
    one's is read), else one -- then the (2r+1)^2 weights and 2r+1 row
    masks."""
    th, tw = REDUCE_RUN_TILE
    lo = (4 - r % 4) % 4
    pitch = 4 * ((lo + tw + 2 * r + 3) // 4) | 1
    d = 2 * r + 1
    window, tables = 4 * 4 * (th + 2 * r) * pitch, 4 * (d * d + d)
    buffers = 2 if 2 * window + tables <= REDUCE_RUN_SMEM else 1
    return buffers * window + tables


def choose_reduce_form(rh: int, rw: int, taps) -> tuple[str, int, int, int]:
    """(form, TH, TW, shared-memory bytes) of the stencil_reduce kernel, by
    shape: ``"run"`` for a compiled radius (rh == rw in REDUCE_RUN_RADII)
    whose tap list is row-major and whose window fits REDUCE_RUN_SMEM;
    ``"shared"`` where ``choose_reduce_tile`` finds a tile; else
    ``"global"`` (every tap through global memory)."""
    if rh == rw and rh in REDUCE_RUN_RADII and _ascending(taps, 2 * rw + 1):
        smem = reduce_run_footprint(rh)
        if smem <= REDUCE_RUN_SMEM:
            return ("run", *REDUCE_RUN_TILE, smem)
    tile = choose_reduce_tile(rh, rw, len(taps))
    if tile is not None:
        return ("shared", *tile)
    return ("global", *REDUCE_GLOBAL_TILE, 0)


@functools.lru_cache(maxsize=64)
def _device_reduce_run_taps(taps: tuple, r: int, device: torch.device):
    """(the spatial weights f32 at dy (2r+1) + dx, 0 where the list lacks
    the tap; each row's tap mask int32) on ``device``, and whether the
    list has every tap of the window, for the run form."""
    d = 2 * r + 1
    w = np.zeros(d * d, np.float32)
    rows = np.zeros(d, np.int32)
    for dy, dx, ws in taps:
        w[dy * d + dx] = ws
        rows[dy] |= 1 << dx
    dense = bool(np.all(rows == (1 << d) - 1))
    return torch.from_numpy(w).to(device), torch.from_numpy(rows).to(device), dense


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    rw) halo of all four channels into shared memory, and each output
    runs the tap list in order with one f32 accumulator per channel,
    rounding every product and sum as the plain version does.  At radii
    1-8 with a row-major list (bilateral's) the run form has each thread
    make eight outputs of a row from a register window slid across each
    window row; other lists take the general form, a pixel at a time,
    and a radius whose tile fits no shared memory reads its taps through
    the clamped global coordinate (``choose_reduce_form``).  The run
    form's blocks are persistent, two an SM, and copy the next tile's
    window by cp.async while they compute this one's.

    Bound on the card: issue slots, 19 instructions a tap and pixel with
    expf's 8 (about 13 with each pair of taps' range weight counted
    once); the run form's loop issues 20 (cuobjdump), the shared form's
    about 32.  Times: PERF.md."""
    _check_image(x, (torch.float32,), "stencil_reduce_mc")
    _check_mode(mode)
    _check_reduce(x, rh, rw, op)
    if not _on_cuda(x):
        return stencil_reduce_mc_plain(x, rh, rw, op, mode)
    lib = load_library()
    _c, h, w = x.shape
    form, th, tw, smem = choose_reduce_form(rh, rw, op.taps)
    out = torch.empty((3, h, w), dtype=torch.float32, device=x.device)
    if form == "run":
        weights, rows, dense = _device_reduce_run_taps(op.taps, rh, x.device)
        rc = _launch(
            x, lib.rf_stencil_reduce_run,
            x.data_ptr(), out.data_ptr(), h, w, rh, int(mode == "zero"), int(_vec(x, out)),
            int(dense), weights.data_ptr(), rows.data_ptr(), float(op.inv2sr), smem,
            _sm_count(x.device), _stream(x),
        )
        _check_launch(lib, rc, "stencil_reduce_mc")
        LAUNCHES["stencil_reduce_mc"] += 1
        return out
    weights, pos = _device_reduce_taps(op.taps, x.device)
    rc = _launch(
        x, lib.rf_stencil_reduce,
        x.data_ptr(), out.data_ptr(), h, w, rh, rw, int(mode == "zero"), th, tw,
        _REDUCE_KINDS[op.kind], weights.data_ptr(), pos.data_ptr(), len(op.taps),
        float(op.inv2sr), smem, _stream(x),
    )
    _check_launch(lib, rc, "stencil_reduce_mc")
    LAUNCHES["stencil_reduce_mc"] += 1
    return out


# ---- kernel F: conv1d_h / conv1d_w -------------------------------------------------------

# Consecutive outputs a thread of the 1-D kernels computes along the pass
# (csrc/conv1d.cu kRun1).
CONV1D_RUN = 16
# Output tiles (rows, cols) of the 1-D kernels' shared-memory form, largest
# first.  H pass: 32 columns, TH / CONV1D_RUN runs a column (blocks of 2 TH
# threads); W pass: 16 rows of 256 columns, eight warps of 16 rows and two
# runs each.  And the tile of the global-memory form of each.
CONV1D_TILES = {
    True: ((128, 32), (64, 32), (32, 32), (16, 32)),
    False: ((16, 256),),
}
CONV1D_GLOBAL_TILE = {True: (32, 32), False: (8, 128)}


def conv1d_footprint(along_h: bool, th: int, tw: int, r: int, n_taps: int) -> int:
    """Shared-memory bytes of a 1-D tile (csrc/conv1d.cu conv1d_shared):
    the window, f32 -- (th + 2r) rows of tw (H), or th rows of the tile's
    tw + 2r columns from the multiple of 4 at or before its first one, at
    an odd pitch (W) -- then the tap list (weight and position)."""
    if along_h:
        window = (th + 2 * r) * tw
    else:
        lo = (4 - r % 4) % 4
        window = th * ((4 * -(-(lo + tw + 2 * r) // 4)) | 1)
    return 4 * (window + 2 * n_taps)


def choose_conv1d_tile(along_h: bool, r: int, n_taps: int) -> Optional[tuple[int, int, int]]:
    """(TH, TW, shared-memory bytes) of a 1-D pass of radius ``r`` with
    ``n_taps`` nonzero taps: the largest tile under SMEM_SOFT, else under
    SMEM_LIMIT, else None (the kernel then reads every tap from global
    memory)."""
    for budget in (SMEM_SOFT, SMEM_LIMIT):
        for th, tw in CONV1D_TILES[along_h]:
            nbytes = conv1d_footprint(along_h, th, tw, r, n_taps)
            if nbytes <= budget:
                return th, tw, nbytes
    return None


@functools.lru_cache(maxsize=64)
def _device_conv1d_taps(key: bytes, device: torch.device):
    """(nonzero weights f32, their positions int32, whether there are some
    and all are equal) of a tap vector."""
    w = np.frombuffer(key, np.float32)
    pos = np.flatnonzero(w != 0.0).astype(np.int32)
    box = len(pos) > 0 and bool(np.all(w[pos] == w[pos[0]]))
    return torch.from_numpy(w[pos].copy()).to(device), torch.from_numpy(pos).to(device), box


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
    taps, pos, box = _device_conv1d_taps(weights.tobytes(), x.device)
    tile = choose_conv1d_tile(along_h, r, taps.numel())
    th, tw, smem = tile if tile is not None else (*CONV1D_GLOBAL_TILE[along_h], 0)
    out = torch.empty_like(x)
    vec = w % 4 == 0 and x.data_ptr() % 16 == 0
    rc = _launch(
        x, lib.rf_conv1d,
        int(along_h), x.data_ptr(), out.data_ptr(), c, h, w, r, int(mode == "zero"), th, tw,
        taps.data_ptr(), pos.data_ptr(), taps.numel(), smem, int(vec), int(box and smem > 0),
        _stream(x),
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

    A thread computes 16 consecutive outputs of one column from a
    register window, so a window value and a tap load from shared memory
    once a run, not once an output.  Where the nonzero taps are all equal
    (a box) the block multiplies its window by that weight once and the
    tap loop only adds: the same rounded products, so the same bits.

    Bound on the card: issue slots, two f32 instructions a tap and output
    (the rounded product and the rounded sum), or for a box one add a tap
    and output and one multiply an input: 0.32 ms at 4K, four channels,
    radius 160, on an H100 at 1980 MHz (0.64 for a gaussian), against
    0.08 ms for the bytes.  There the box takes 0.534 ms (2.09 before
    this design), a gaussian 0.875, the box at radius 400 2.11, whose
    window takes a 125 KB tile: one block an SM (H100 80GB HBM3, 700 W;
    an A/B on the card, PERF.md §6)."""
    return _conv1d(x, weights, mode, True)


def conv1d_w(x: torch.Tensor, weights, mode: str = "edge") -> torch.Tensor:
    """1-D correlation along W of an f32 (C, H, W) image; ``conv1d_h``
    along the other axis.

    Replaces ``pallas_ops.conv1d_w`` (pallas_ops.py:101), which ran
    whole-width blocks of 128 rows.  Here a 16 x 256 tile and its (R) halo
    left and right load into shared memory at an odd row pitch; a thread
    computes 16 consecutive outputs of one row, a warp 16 rows and two
    runs.  Box taps and bound as ``conv1d_h``: the box 0.514 ms at 4K
    radius 160 (before this design 2.20), a gaussian 0.828, the box at
    radius 400 1.15 (H100 80GB HBM3, 700 W; an A/B on the card, PERF.md §6)."""
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

    @property
    def full(self) -> bool:
        """Every term of the table is present (nonzero)."""
        return self.n_terms == self.weights.size

    @property
    def nonempty(self) -> int:
        """Bit o set where output channel o has a term."""
        return sum(1 << o for o, t in enumerate(self.terms) if t)

    def device_run_terms(self, device: torch.device):
        """(weights f32, masks int32) of the run forms on ``device``, built
        once: for each (c, dy), a row of the weights at o (2rw+1) + dx,
        zero-padded to a multiple of four, and a mask with bit o (2rw+1) +
        dx set for each term present (csrc/stencil_mc.cuh)."""
        key = ("run", device)
        if key not in self._device:
            kw = 2 * self.rw + 1
            row_w = -(-self.c_out * kw // 4) * 4
            # (c, dy, o, dx): a (c, dy) row is o major, then dx
            rows = self.weights.transpose(1, 2, 0, 3).reshape(-1, self.c_out * kw)
            w = np.zeros((rows.shape[0], row_w), np.float32)
            w[:, : rows.shape[1]] = rows
            bits = (rows != 0) * (1 << np.arange(rows.shape[1], dtype=np.int64))
            masks = bits.sum(axis=1).astype(np.int32)
            self._device[key] = (torch.from_numpy(w.ravel()).to(device),
                                 torch.from_numpy(masks).to(device))
        return self._device[key]

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
# The run forms of stencil_apply_mc (csrc/stencil_mc.cuh): input and
# output channels 1..STENCIL_MC_RUN_CHANNELS and radii in
# STENCIL_MC_RUN_RADII on each axis; outputs a thread (kMcRun) and the
# tile, 32 rows (a warp's lanes) by a run for each of the 8 warps.
STENCIL_MC_RUN_CHANNELS = 4
STENCIL_MC_RUN_RADII = (1, 2, 3)
STENCIL_MC_RUN = 8
STENCIL_MC_RUN_TILE = (32, 8 * STENCIL_MC_RUN)
# The form argument of rf_stencil_apply_mc.
_STENCIL_MC_FORMS = {"shared": 0, "global": 0, "run": 1, "run_masked": 2}


def stencil_mc_run_footprint(c_in: int, c_out: int, rh: int, rw: int) -> int:
    """Shared-memory bytes of a run form (csrc/stencil_mc.cuh
    mc_run_bytes): for each (c, dy) a row of c_out (2rw+1) weights padded
    to a multiple of four and a term mask, each of the 8 warps' staging
    area of TH rows at the odd pitch STENCIL_MC_RUN | 1, then two windows
    (this tile's and the next one's) of c_in planes of (TH + 2rh) rows at
    the odd pitch of TW + 2rw columns."""
    th, tw = STENCIL_MC_RUN_TILE
    rows = c_in * (2 * rh + 1)
    row_w = -(-c_out * (2 * rw + 1) // 4) * 4
    staging = 8 * th * (STENCIL_MC_RUN | 1)
    return 4 * (rows * row_w + rows + staging + 2 * c_in * (th + 2 * rh) * ((tw + 2 * rw) | 1))


def choose_stencil_mc_form(op: LinearStencilOp) -> tuple[str, int, int, int]:
    """(form, TH, TW, shared-memory bytes) of stencil_apply_mc, by shape:
    ``"run"`` (every term present) or ``"run_masked"`` (some absent) for 1-4
    input and output channels at radii 1-3 on each axis; otherwise
    ``"shared"`` where ``choose_stencil_mc_tile`` finds a tile, else
    ``"global"`` (every term through global memory)."""
    if (max(op.c_in, op.c_out) <= STENCIL_MC_RUN_CHANNELS and op.rh in STENCIL_MC_RUN_RADII
            and op.rw in STENCIL_MC_RUN_RADII):
        return ("run" if op.full else "run_masked", *STENCIL_MC_RUN_TILE,
                stencil_mc_run_footprint(op.c_in, op.c_out, op.rh, op.rw))
    tile = choose_stencil_mc_tile(op.c_in, op.rh, op.rw, op.n_terms, op.c_out)
    if tile is not None:
        return ("shared", *tile)
    return ("global", *STENCIL_MC_GLOBAL_TILE, 0)


def stencil_apply_mc(x: torch.Tensor, op: LinearStencilOp, mode: str = "edge") -> torch.Tensor:
    """A cross-channel linear stencil of a (C_in, H, W) f32 or bf16 image;
    returns (C_out, H, W) in the input's type, edge or zero borders.

    Replaces ``pallas_ops.stencil_apply_mc`` (pallas_ops.py:2082), which ran
    a traced closure over all channels of a double-buffered VMEM strip and
    gave up where its strips did not fit VMEM.  Here the function is a
    ``LinearStencilOp`` tap table, and every output channel adds its
    terms' products in ascending (c, dy, dx), each product and sum rounded
    alone: bit-equal to the plain version in every form.

    Forms (``choose_stencil_mc_form``): a table of 1-4 input and output
    channels at radii 1-3 takes a run form, whose persistent blocks copy
    the next tile's window of every input channel into shared memory
    while they compute this one's, and whose threads make eight outputs
    of a row for every output channel from register windows, a weight
    loaded once for eight outputs (``run`` where every term is present,
    ``run_masked`` testing a bit a term otherwise).  Any other table takes
    the general form: a block loads its tile's window and the terms into
    shared memory and each thread runs every output channel's term list
    a pixel at a time, or, where no tile fits, reads its taps through the
    clamped global coordinate.  No module of either package calls it.

    Bound on the card: device memory at small tables, the term loop (two
    f32 instructions a term and pixel, in issue slots) at large ones; its
    times are in PERF.md."""
    _check_image(x, (torch.float32, torch.bfloat16), "stencil_apply_mc")
    _check_mode(mode)
    if x.shape[0] != op.c_in:
        raise ValueError(f"stencil_apply_mc: the table takes {op.c_in} channels, got {x.shape[0]}")
    if not _on_cuda(x):
        return stencil_apply_mc_plain(x, op, mode)
    lib = load_library()
    _c, h, w = x.shape
    form, th, tw, smem = choose_stencil_mc_form(op)
    out = torch.empty((op.c_out, h, w), dtype=x.dtype, device=x.device)
    # the general form's (weights, positions, starts) or the run forms'
    # (weight rows, masks); null pointers for the other form's
    if form in ("run", "run_masked"):
        general, run = (None, None, None), op.device_run_terms(x.device)
    else:
        general, run = op.device_terms(x.device), (None, None)
    ptrs = [None if t is None else t.data_ptr() for t in (*general, *run)]
    vec = out.data_ptr() % 16 == 0 and (w * out.element_size()) % 16 == 0
    rc = _launch(
        x, lib.rf_stencil_apply_mc,
        int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(), op.c_in, op.c_out, h, w,
        op.rh, op.rw, int(mode == "zero"), th, tw, int(form != "global"), *ptrs[:3], op.n_terms,
        _STENCIL_MC_FORMS[form], *ptrs[3:], op.nonempty, int(vec), smem, _stream(x),
    )
    _check_launch(lib, rc, "stencil_apply_mc")
    LAUNCHES["stencil_apply_mc"] += 1
    return out
