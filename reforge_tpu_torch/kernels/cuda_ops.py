"""Hand-written Hopper kernels for the port's main path, their plain
PyTorch versions, launch counters and the build loader.

Each wrapper takes its kernel's plain version when the tensor it is given
lies on the CPU (or on the ``meta`` device, which the program uses to
check shapes) and launches its CUDA kernel when the tensor lies on a GPU.
There is no fallback from one to the other: a kernel that cannot launch
raises.

Kernels (sources in ``reforge_tpu_torch/csrc/``, one shared library built
for ``sm_90a`` with nvcc at first use and bound with ctypes):

  * ``sep_conv_multi`` (sep_conv.cu) serves three entry points:
    ``sep_conv_fused``, ``sep_conv_fused_multi`` and ``sep_conv_fused_mxu``.
  * ``graph_strip`` (graph_strip.cu): the single-tier whole-graph kernel.

Both kernels read each input pixel of a tile once (plus its halo) and
write each output once, and spend 2R+1 multiply-adds per pass per pixel
per conv from shared memory.  At the flagship's radii (12 and 6) the tap
loops, not device memory, bound them (each wrapper notes its time): there
is no tensor-core, TMA or register-blocking work in them yet.
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

# ---- build and bind ---------------------------------------------------------

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/reforge_tpu_torch, found from this file (never the CWD).
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "reforge_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

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
    """Compile every ``csrc/*.cu`` into one shared library, keyed on a hash
    of the sources and flags, unless that library exists already.  The
    compiler's output (ptxas register and spill counts) goes to
    ``build.log`` beside it."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    target = BUILD_DIR / f"librf_kernels_{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
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
            _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
            _P, _P, _I, _I, _I, _F, _I, _P,
        ]
        lib.rf_graph_strip.restype = _I
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
    """choose_tile, raising when no tile fits (the gaussian radius is
    capped at 96, which fits)."""
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

# Storage rounding after every node (csrc enum Store).
STORE_MODES = {"rgba32f": 0, "rgba16f": 1, "rgba8": 2}


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
        if any(len(op.params) > 4 for op in self.ops):
            raise ValueError("graph_strip ops take at most 4 float params")

    def packed(self, device: torch.device):
        """(op ints, op floats) tensors on ``device``, built once."""
        hit = self._packed.get(device)
        if hit is None:
            op_i = np.array(
                [[op.code, op.ins[0], op.ins[1], op.out, op.plane] for op in self.ops],
                np.int32,
            ).reshape(-1, 5)
            op_f = np.zeros((len(self.ops), 4), np.float32)
            for j, op in enumerate(self.ops):
                op_f[j, : len(op.params)] = op.params
            hit = (torch.from_numpy(op_i).to(device), torch.from_numpy(op_f).to(device))
            self._packed[device] = hit
        return hit


def _store(v: torch.Tensor, fmt: str) -> torch.Tensor:
    from .base import quantize_rgba8

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
    rc = lib.rf_graph_strip(
        int(dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(),
        0 if aux is None else aux.data_ptr(), c, h, w, taps.data_ptr(), meta.data_ptr(),
        len(strip.plans), taps.numel(), rh, rw, th, tw, op_i.data_ptr(), op_f.data_ptr(),
        len(strip.ops), strip.out_slot, STORE_MODES[strip.fmt], float(t), smem,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, rc, "graph_strip")
    LAUNCHES["graph_strip"] += 1
    return out
