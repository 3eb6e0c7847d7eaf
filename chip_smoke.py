#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from
``reforge_tpu_torch/csrc`` (first use; one nvcc per source, in parallel),
holds each kernel against its plain PyTorch version on the card, and
drives five main paths at 3840x2160 through ``Engine``, each with the
launch counters set to 0 just before it and read just after:

  A. the flagship graph in rgba32f and rgba16f on both tiers (one-shot
     per node with conv bundles, and the graph_strip tier);
  B. the classic demo (blur sigma 8, sharpen, blend) and edges (median3,
     sobel) in rgba32f and rgba16f: one-shot per node (the x3, mxu and
     stencil kernels) and the mc tier (graph_strip_mc);
  C. the stylized graphs newsprint (bilateral, levels, halftone),
     watercolor (kuwahara, bilateral, levels, noise, vignette) and oil
     paint (kuwahara, tonemap) in rgba32f and rgba16f, per node on every
     tier: bilateral through stencil_reduce_mc, kuwahara's four quadrant
     convs through sep_conv_fused (never the bf16 entry);
  D. the rest of the builtin library in rgba32f and rgba16f: film look,
     old film, pop art and psychedelic per node (plain PyTorch gathers and
     colour math), neon edges on the mc tier, frost (a radius-160 box
     blur) through conv1d_h and conv1d_w, and box_blur radius 120 and
     kuwahara radius 130, whose windows fit no shared-memory tile of the
     fused conv kernels;
  E. GLSL shaders on images, with the shipped shaders of ``shaders/``:
     the default config (passthrough.comp), glsl-blur (gaussian_h.comp ->
     gaussian_v.comp) and glsl-blur-sharpen (plus sharpen.comp) on the mc
     tier as synthesized conv and stencil stages of graph_strip_mc, the
     reference's glsl-chain and glsl-sharpen per node (tonemap.comp is a
     point shader), and the examples whose shaders touch only images.

Paths A-D use an empty shader path, so the builtins they measure are not
replaced by the shipped shaders of the same names.  ``stencil_apply_mc``
has no caller in either package: only the kernel checks launch it.

It checks the outputs, prints fps, latency, a device-time profile and
each kernel's time beside its plain version, its bound and a library
call, all beside the card's name and power limit.  The line before the
last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without printing a result; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

WIDTH, HEIGHT = 3840, 2160
SEED = 0
# H100 SXM published peaks (NVIDIA's data sheet): device memory and
# float32 outside the tensor cores (an FMA counts two operations).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

def _f32_tol(plans) -> float:
    # Kernel (one FMA per tap) and plain version (a multiply then an add
    # per tap) round differently at every tap of both passes; the worst
    # case grows with the tap count.  2e-6 covers the flagship's radii.
    taps = max(len(wh) + len(ww) for wh, ww in plans)
    return max(2e-6, 6e-8 * taps)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} above {tol}")
    print(f"check {name}: max abs error {err:.3g} <= {tol:.3g}")


def _rgba8_check(name: str, a: torch.Tensor, b: torch.Tensor, steps: int = 2) -> float:
    # A pre-quantization difference of one rounding flips a 1/255 bucket
    # where a value sits on its edge, and a flip can cascade through one
    # more quantized node downstream: at most two steps, on few pixels.
    # Where a stencil follows a quantized conv the flip is amplified before
    # the next store (sobel moves its magnitude by up to 2*sqrt(2) buckets
    # per flipped tap, and ACES tonemap's slope reaches 1.3): ``steps`` 4.
    d = (a.float() - b.float()).abs()
    err = float(d.max())
    frac = float((d > 1.0 / 512.0).float().mean())
    if err > steps / 255.0 + 1e-6 or frac > 1e-3:
        raise AssertionError(f"{name}: rgba8 max {err}, flipped fraction {frac}")
    print(f"check {name}: rgba8 max abs error {err:.3g}, flipped fraction {frac:.3g}")
    return err


def _check_fmt(name: str, fmt: str, got: torch.Tensor, want: torch.Tensor,
               rgba8_steps: int = 2) -> float:
    if fmt == "rgba8":
        return _rgba8_check(name, got, want, rgba8_steps)
    err = _max_err(got, want)
    _check(name, err, 1e-5 if fmt == "rgba32f" else 2e-2)
    return err


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _reduce_bound(n_pixels: int, n_taps: int, max_sm_mhz: float, n_sms: int) -> tuple[float, str, str]:
    """(ms, what bounds it, the three terms) of bilateral's reduction: four
    f32 planes read and three written; 11 f32 operations per tap and
    pixel (a difference, a square, a scale, the exponential counted as
    one, the spatial weight, three products, four sums) and three
    divisions a pixel; one exponential per tap and pixel on the SFUs, 16
    per SM per clock at the highest SM clock."""
    t_bytes = 7 * 4 * n_pixels / HBM_BYTES_PER_S * 1e3
    t_ops = (11 * n_taps + 3) * n_pixels / F32_OPS_PER_S * 1e3
    t_sfu = n_taps * n_pixels / (16 * n_sms * max_sm_mhz * 1e6) * 1e3
    terms = f"bytes {t_bytes:.4f}, f32 operations {t_ops:.4f}, exponentials {t_sfu:.4f} ms"
    if t_bytes >= max(t_ops, t_sfu):
        return t_bytes, "bytes", terms
    return max(t_ops, t_sfu), "operations", terms


def _library_sep_conv(x: torch.Tensor, plans):
    """One replicate pad and one depthwise F.conv2d per pass and plan (the
    library yardstick of the conv kernels; TF32 is off)."""
    c = x.shape[0]
    weights = [
        (torch.from_numpy(wh).to(x.device).view(1, 1, -1, 1).repeat(c, 1, 1, 1),
         torch.from_numpy(ww).to(x.device).view(1, 1, 1, -1).repeat(c, 1, 1, 1),
         (len(wh) - 1) // 2, (len(ww) - 1) // 2)
        for wh, ww in plans
    ]

    def run():
        xf = x.float()[None]
        outs = []
        for kh, kw, rh, rw in weights:
            y = F.conv2d(F.pad(xf, (0, 0, rh, rh), mode="replicate"), kh, groups=c)
            outs.append(F.conv2d(F.pad(y, (rw, rw, 0, 0), mode="replicate"), kw, groups=c)[0])
        return outs

    return run


def _library_stencil(x: torch.Tensor, table: np.ndarray):
    c = x.shape[0]
    r = table.shape[0] // 2
    k = torch.from_numpy(table).to(x.device).view(1, 1, *table.shape).repeat(c, 1, 1, 1)
    return lambda: F.conv2d(F.pad(x[None], (r, r, r, r), mode="replicate"), k, groups=c)[0]


def _library_conv1d(x: torch.Tensor, w: np.ndarray, along_h: bool):
    """One replicate pad and one depthwise F.conv2d along one axis (TF32
    off): the library yardstick of the 1-D kernels."""
    c, r = x.shape[0], (len(w) - 1) // 2
    shape = (1, 1, -1, 1) if along_h else (1, 1, 1, -1)
    k = torch.from_numpy(w).to(x.device).view(*shape).repeat(c, 1, 1, 1)
    pad = (0, 0, r, r) if along_h else (r, r, 0, 0)
    return lambda: F.conv2d(F.pad(x[None], pad, mode="replicate"), k, groups=c)[0]


def _mc_ops_per_pixel(prog, cuda_ops) -> float:
    """Operations per pixel (all channels) of an mc plan's stages at the
    tile itself, halo recompute not counted: conv FMAs count two, wsum
    terms two, each exchange of the median network two, point ops by
    their arithmetic."""
    point_ops = {cuda_ops.MC_COPY: 0, cuda_ops.MC_MIX: 12, cuda_ops.MC_ACES: 30,
                 cuda_ops.MC_REINHARD: 9, cuda_ops.MC_VIGNETTE: 21, cuda_ops.MC_GRAYSCALE: 5,
                 cuda_ops.MC_SATURATION: 14, cuda_ops.MC_THRESHOLD: 6,
                 cuda_ops.MC_BLOOM_PRE: 14}
    total = 0.0
    for st in prog.stages:
        if st.kind == cuda_ops.MC_CONV:
            total += 4 * 2 * (len(st.taps[0]) + len(st.taps[1])) + 6
        elif st.kind == cuda_ops.MC_STENCIL:
            terms = sum(int(np.count_nonzero(t)) for t in st.taps)
            if st.op.code == cuda_ops.MC_MEDIAN3:
                total += 3 * 19 * 2
            elif st.op.code == cuda_ops.MC_SOBEL:
                total += 9 * 5 + 2 * terms + 4
            else:
                total += 3 * (2 * terms + 2)
        else:
            total += point_ops.get(st.op.code, 0)
    return total


def _card_state() -> str:
    """The card's SM clock, power draw, temperature and active clock
    throttle reasons, as nvidia-smi reads them now (or what it says)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    return (out.stdout or out.stderr).strip().replace("\n", " | ")


def _profile(fn, frames: int) -> tuple[list, float]:
    """[(kernel name, device ms per frame)] by device time, and the busy
    share of the window (device kernel time over the synchronized wall
    time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's self device
        # time repeats the time of the kernels it launched
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            rows.append((evt.key, evt.self_device_time_total / 1e3 / frames))
    rows.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows) * frames / 1e3 / wall
    return rows, busy


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from reforge_tpu_torch.benchmarks import (
        CHAIN3_CONFIG, CW_CHECK_CONFIG, DEMO_CONFIG, EDGES_CONFIG, FLAGSHIP_CONFIG, GLSL_EXAMPLES,
        GLSL_GRAPHS, LIBRARY_GRAPHS, MC_CHECK_CONFIG, MC_TEST_GRAPHS, MIX_SECOND_FIRST_CONFIG,
        SHADER_DIR, STYLIZED_GRAPHS, bench_program, bench_program_sequenced, build_flagship,
        build_program, example_config,
    )
    from reforge_tpu_torch.engine import Engine, RenderInfo
    from reforge_tpu_torch.glsl import affine
    from reforge_tpu_torch.kernels import cuda_ops, library
    from reforge_tpu_torch.kernels.ops import box_weights, gaussian_weights, luma

    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    # The SFU term of a bound counts at the card's highest SM clock.
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    max_sm_mhz = float(clocks.split(",")[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"SM clock max, now (MHz): {clocks}; SMs {n_sms}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    # The GLSL conv-synthesis cache of this run (removed when the script
    # ends), so the affine probe runs and its time shows.
    synth_cache = tempfile.TemporaryDirectory(prefix="rf_chip_smoke_synth_")

    # ---- 2. build -----------------------------------------------------------
    start = time.perf_counter()
    cuda_ops.load_library()
    print(f"build: {time.perf_counter() - start:.2f} s (nvcc per source in parallel, sm_90a)")
    log = cuda_ops.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "stack frame" in line:
                print(f"ptxas: {line.strip()}")

    # ---- 3. each kernel against its plain version ----------------------------
    cuda_ops.reset_launches()
    w4, w2 = gaussian_weights(4.0), gaussian_weights(2.0)  # soften, crisp
    w1, w96 = np.array([0.25, 0.5, 0.25], np.float32), gaussian_weights(32.0)
    w8, w66 = gaussian_weights(8.0), gaussian_weights(22.0)  # radii 24 (the demo), 66
    big = (4, HEIGHT, WIDTH)
    x4k = torch.from_numpy(rng.random(big, dtype=np.float32)).to(dev)
    x4k_bf = x4k.to(torch.bfloat16)
    ragged = torch.from_numpy(rng.random((4, 37, 71), dtype=np.float32)).to(dev)
    errs: dict[str, float] = {}

    def conv_case(name, entry, x, plans, mode, main_shape):
        got = entry(x, plans, mode)
        want = cuda_ops.sep_conv_plain(x, plans, mode)
        torch.cuda.synchronize()
        err = max(_max_err(g, w) for g, w in zip(got, want))
        shape = "x".join(map(str, x.shape))
        _check(f"{name} {shape} {x.dtype} r={[(len(a) - 1) // 2 for a, _ in plans]} {mode}",
               err, _f32_tol(plans))
        if main_shape:
            errs[name] = err

    entries = {
        "sep_conv_fused": lambda x, p, m: [cuda_ops.sep_conv_fused(x, *p[0], mode=m)],
        "sep_conv_fused_multi": lambda x, p, m: cuda_ops.sep_conv_fused_multi(x, p, mode=m),
        "sep_conv_fused_mxu": lambda x, p, m: [cuda_ops.sep_conv_fused_mxu(x, *p[0], mode=m)],
        "sep_conv_fused_mxu_x3": lambda x, p, m: [cuda_ops.sep_conv_fused_mxu_x3(x, *p[0], mode=m)],
    }
    conv_case("sep_conv_fused", entries["sep_conv_fused"], x4k, [(w4, w4)], "edge", True)
    conv_case("sep_conv_fused_multi", entries["sep_conv_fused_multi"], x4k,
              [(w2, w2), (w4, w4)], "edge", True)
    conv_case("sep_conv_fused_mxu", entries["sep_conv_fused_mxu"], x4k_bf, [(w4, w4)], "edge", True)
    conv_case("sep_conv_fused_mxu_x3", entries["sep_conv_fused_mxu_x3"], x4k, [(w8, w8)], "edge",
              True)
    for mode in ("edge", "zero"):
        for w in (w1, w96):
            conv_case("sep_conv_fused", entries["sep_conv_fused"], ragged, [(w, w)], mode, False)
            conv_case("sep_conv_fused_mxu", entries["sep_conv_fused_mxu"],
                      ragged.to(torch.bfloat16), [(w, w)], mode, False)
        conv_case("sep_conv_fused_multi", entries["sep_conv_fused_multi"], ragged,
                  [(w1, w1), (w96, w96), (w4, w2)], mode, False)
        conv_case("sep_conv_fused_mxu_x3", entries["sep_conv_fused_mxu_x3"], ragged,
                  [(w66, w66)], mode, False)

    # stencil_apply: the tables of the main path (sharpen and emboss on four
    # channels, sobel on the luma plane) and the median, edge and zero.
    # Every product and sum rounds as in the plain version: expected 0.
    luma4k = luma(x4k)[None].contiguous()
    stencils = [("sharpen", cuda_ops.wsum(library.SHARPEN_TAPS), False),
                ("sobel_x", cuda_ops.wsum(library.SOBEL_X_TAPS), True),
                ("emboss", cuda_ops.wsum(library.EMBOSS_TAPS), False),
                ("median9", cuda_ops.MEDIAN9, False)]
    for x in (x4k, ragged):
        for mode in ("edge", "zero"):
            for sname, op, one_channel in stencils:
                xin = (luma4k if x is x4k else luma(x)[None].contiguous()) if one_channel else x
                got = cuda_ops.stencil_apply(xin, 1, 1, op, mode)
                want = cuda_ops.stencil_apply_plain(xin, 1, 1, op, mode)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                _check(f"stencil_apply {sname} {'x'.join(map(str, xin.shape))} {mode}", err, 0.0)
                if x is x4k and mode == "edge" and sname == "sharpen":
                    errs["stencil_apply"] = err

    # stencil_reduce_mc: bilateral's reduction at newsprint's radius 4 and
    # watercolor's radius 3 at 4K, and radius 60 (no shared-memory tile
    # fits it; every tap through global memory) on the ragged frame, in
    # both border modes.  Kernel and plain version call the same expf and
    # round every product and sum alike; 1e-6 allows a few f32 ulps of
    # [0, 1] values.
    stack4k = torch.cat([x4k[:3], luma(x4k)[None]]).contiguous()
    stack_ragged = torch.cat([ragged[:3], luma(ragged)[None]]).contiguous()
    reduce_ops = {"r4": library.bilateral_op(4, 2.5, 0.12), "r3": library.bilateral_op(3, 2.5, 0.12),
                  "r60": library.bilateral_op(60, 8.0, 0.12)}
    if cuda_ops.choose_reduce_tile(60, 60, len(reduce_ops["r60"][1].taps)) is not None:
        raise AssertionError("radius 60 should fit no shared-memory tile")
    for rname, (r, op) in reduce_ops.items():
        x = stack_ragged if rname == "r60" else stack4k
        for mode in ("edge", "zero"):
            got = cuda_ops.stencil_reduce_mc(x, r, r, op, mode)
            want = cuda_ops.stencil_reduce_mc_plain(x, r, r, op, mode)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            _check(f"stencil_reduce_mc bilateral {'x'.join(map(str, x.shape))} r={r} "
                   f"({len(op.taps)} taps) {mode}", err, 1e-6)
            if rname == "r4" and mode == "edge":
                errs["stencil_reduce_mc"] = err

    # conv1d_h / conv1d_w: frost's radius 160 and radius 400 (where the
    # reference itself takes its 1-D kernels at 4K) on the 4K frame; on an
    # odd 6-channel frame (kuwahara's stack) a radius past every
    # shared-memory window (3000: the global-memory path), kuwahara's
    # quadrant vector at radius 130 (zero taps) and radius 160; edge and
    # zero borders.  Both sides add the nonzero taps in ascending order
    # and round every product and sum alike: expected bit-equal (0).
    odd6 = torch.from_numpy(rng.random((6, 33, 47), dtype=np.float32)).to(dev)
    quadrant = np.zeros(261, np.float32)
    quadrant[130:] = 1.0 / 131
    conv1d_cases = [(x4k, box_weights(160), True), (x4k, box_weights(400), False),
                    (odd6, box_weights(3000), False), (odd6, quadrant, False),
                    (odd6, box_weights(160), False)]
    for along_h in (True, False):
        kname = "conv1d_h" if along_h else "conv1d_w"
        entry = cuda_ops.conv1d_h if along_h else cuda_ops.conv1d_w
        if cuda_ops.choose_conv1d_tile(along_h, 3000, 6001) is not None:
            raise AssertionError("radius 3000 should fit no shared-memory window")
        for x, w, main_shape in conv1d_cases:
            r = (len(w) - 1) // 2
            tile = cuda_ops.choose_conv1d_tile(along_h, r, int(np.count_nonzero(w)))
            where = f"tile {tile[:2]}" if tile else "global path"
            for mode in ("edge", "zero"):
                got = entry(x, w, mode)
                want = cuda_ops.correlate1d(x, w, -2 if along_h else -1, mode)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                _check(f"{kname} {'x'.join(map(str, x.shape))} r={r} "
                       f"({np.count_nonzero(w)} taps) {mode} {where}", err, 0.0)
                if main_shape and r == 160 and mode == "edge":
                    errs[kname] = err
            del got, want

    # stencil_apply_mc: a dense cross-channel table at 4K (C_in 4 -> C_out
    # 4, radius 2: 400 terms), C_out 3 at radii (2, 3) and C_out 4 at
    # radius 1, f32 and bf16, edge and zero, on the 4K and the ragged
    # frame; radius 24 on the ragged frame, where no shared-memory tile
    # holds the window and the terms (every term reads global memory).
    # Both sides add each output's products in the table's order, each
    # rounded alone: expected bit-equal (0).
    lin_ops = {name: cuda_ops.LinearStencilOp(rng.standard_normal(shape).astype(np.float32))
               for name, shape in (("4->4 r2", (4, 4, 5, 5)), ("4->3 r2,3", (3, 4, 5, 7)),
                                   ("4->4 r1", (4, 4, 3, 3)), ("4->3 r24", (3, 4, 49, 49)))}
    if cuda_ops.choose_stencil_mc_tile(4, 24, 24, lin_ops["4->3 r24"].n_terms, 3) is not None:
        raise AssertionError("radius 24 should fit no shared-memory tile")
    for tname, op in lin_ops.items():
        tile = cuda_ops.choose_stencil_mc_tile(op.c_in, op.rh, op.rw, op.n_terms, op.c_out)
        where = f"tile {tile[:2]}" if tile else "global path"
        for x in ((ragged,) if tname.endswith("r24") else (x4k, ragged)):
            for dt in (torch.float32, torch.bfloat16):
                for mode in ("edge", "zero"):
                    xin = x.to(dt)
                    got = cuda_ops.stencil_apply_mc(xin, op, mode)
                    want = cuda_ops.stencil_apply_mc_plain(xin, op, mode)
                    torch.cuda.synchronize()
                    err = _max_err(got, want)
                    _check(f"stencil_apply_mc {tname} ({op.n_terms} terms) "
                           f"{'x'.join(map(str, x.shape))} {dt} {mode} {where}", err, 0.0)
                    if x is x4k and tname == "4->4 r2" and dt == torch.float32 and mode == "edge":
                        errs["stencil_apply_mc"] = err
    del got, want

    # Device forms: every channel-local builtin's cw_op on graph_strip and
    # every new mc point op on graph_strip_mc (the two check graphs),
    # against per node on the card, at 4K and on a ragged frame.
    for cname, config, kname in (("cw_check", CW_CHECK_CONFIG, "graph_strip"),
                                 ("mc_check", MC_CHECK_CONFIG, "graph_strip_mc")):
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            for h, w in ((HEIGHT, WIDTH), (37, 71)):
                prog = build_program(config, w, h, fmt, device=dev)
                if prog._strip_plan[0] != ("single" if kname == "graph_strip" else "mc"):
                    raise AssertionError(f"{cname} {fmt}: tier {prog._strip_plan[0]}")
                xin = (x4k if h == HEIGHT else ragged).to(prog.storage_dtype)
                before = cuda_ops.LAUNCHES[kname]
                got = prog._forward(xin, 0.5)
                per_node = prog._forward_nostrip(xin, 0.5)
                torch.cuda.synchronize()
                if cuda_ops.LAUNCHES[kname] != before + 1:
                    raise AssertionError(f"{cname} {fmt}: {kname} not launched once")
                _check_fmt(f"{kname} {cname} {fmt} {h}x{w} vs per node on the card", fmt, got,
                           per_node)

    strips = {}
    for fmt in ("rgba32f", "rgba16f", "rgba8"):
        for h, w in ((HEIGHT, WIDTH), (37, 71)):
            prog = build_flagship(w, h, fmt, device=dev)
            prog._strip_program = prog._build_strip_program()
            strip = prog._strip_program
            x = (x4k if h == HEIGHT else ragged).to(prog.storage_dtype)
            got = cuda_ops.graph_strip(x, 0.5, strip)
            want = cuda_ops.graph_strip_plain(x, 0.5, strip)
            torch.cuda.synchronize()
            err = _check_fmt(f"graph_strip {fmt} {h}x{w}", fmt, got, want)
            if h == HEIGHT:
                strips[fmt] = (prog, x)
                if fmt == "rgba32f":
                    errs["graph_strip"] = err

    graphs = {"demo": DEMO_CONFIG, "edges": EDGES_CONFIG, "chain3": CHAIN3_CONFIG}
    mc_progs = {}

    def mc_case(name, config, fmt, h, w, x, shader_path=None):
        prog = build_program(config, w, h, fmt, device=dev, shader_path=shader_path)
        if prog._strip_plan is None or prog._strip_plan[0] != "mc":
            raise AssertionError(f"{name} {fmt} {h}x{w}: no mc plan")
        mc = prog._strip_plan[1]
        xin = x.to(prog.storage_dtype)
        got = cuda_ops.graph_strip_mc(xin, 0.5, mc)
        want = cuda_ops.graph_strip_mc_plain(xin, 0.5, mc)
        torch.cuda.synchronize()
        # A stencil after a quantized conv amplifies a bucket flip (chain3,
        # conv_stencil_point): four steps there, two elsewhere;
        # sharpen.comp at amount 0.7 by up to 1 + 8 * 0.7 = 6.6: seven.
        steps = {"chain3": 4, "conv_stencil_point": 4, "glsl_blur_sharpen": 7}.get(
            name.split()[0], 2)
        err = _check_fmt(f"graph_strip_mc {name} {fmt} {h}x{w} tile {mc.tile()[:2]}", fmt, got,
                         want, rgba8_steps=steps)
        return prog, xin, err

    for name, config in graphs.items():
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            prog, xin, err = mc_case(name, config, fmt, HEIGHT, WIDTH, x4k)
            mc_progs[(name, fmt)] = (prog, xin)
            if name == "demo" and fmt == "rgba32f":
                errs["graph_strip_mc"] = err
    # The GLSL graphs of path E: gaussian_h.comp -> gaussian_v.comp (one
    # composed conv in rgba32f, two where storage rounds between them, each
    # an identity conv and an MC_AFFINE point stage) and sharpen.comp (an
    # emboss-form stencil stage), in three formats at 4K and on the ragged
    # frame.
    # The first build runs the affine probe (the synthesis cache starts
    # empty).
    affine.CACHE_DIR = Path(synth_cache.name)
    affine._SYNTH_CACHE.clear()
    start = time.perf_counter()
    build_program(GLSL_GRAPHS["glsl_blur"], WIDTH, HEIGHT, device=dev, shader_path=SHADER_DIR)
    print(f"E2 glsl_blur graph build at 4K, affine probe included: "
          f"{time.perf_counter() - start:.3f} s; again (cached): ", end="")
    start = time.perf_counter()
    build_program(GLSL_GRAPHS["glsl_blur"], WIDTH, HEIGHT, device=dev, shader_path=SHADER_DIR)
    print(f"{time.perf_counter() - start:.3f} s")
    for name in ("glsl_blur", "glsl_blur_sharpen"):
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            for h, w, x in ((HEIGHT, WIDTH, x4k), (37, 71, ragged)):
                prog, xin, _err = mc_case(name, GLSL_GRAPHS[name], fmt, h, w, x, SHADER_DIR)
                if h == HEIGHT and fmt != "rgba8":
                    mc_progs[(name, fmt)] = (prog, xin)
    # Every mc test graph on a ragged frame (border blocks only) and on one
    # with interior blocks; the mix wired second input first also against
    # the per-node tier on the card.
    small = dict(graphs, **MC_TEST_GRAPHS, mix_second_first=MIX_SECOND_FIRST_CONFIG)
    mid = torch.from_numpy(rng.random((4, 288, 512), dtype=np.float32)).to(dev)
    for name, config in small.items():
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            mc_case(name, config, fmt, 37, 71, ragged)
            prog, xin, _ = mc_case(name, config, fmt, 288, 512, mid)
            if name == "mix_second_first":
                _check_fmt(f"graph_strip_mc {name} vs per-node {fmt} 288x512", fmt,
                           cuda_ops.graph_strip_mc(xin, 0.5, prog._strip_plan[1]),
                           prog._forward_nostrip(xin, 0.5))
    # A one-pixel band: the frame one pixel taller and wider than the tile.
    band_cfg = MC_TEST_GRAPHS["coord_point_feeding_conv"]
    th, tw, _ = build_program(band_cfg, 71, 37, device=dev)._strip_plan[1].tile()
    band = torch.from_numpy(rng.random((4, th + 1, tw + 1), dtype=np.float32)).to(dev)
    for fmt in ("rgba32f", "rgba16f", "rgba8"):
        prog, xin, _ = mc_case("coord_point_feeding_conv band", band_cfg, fmt, th + 1, tw + 1, band)
        per_node = prog._forward_nostrip(xin, 0.5)
        _check_fmt(f"graph_strip_mc band vs per-node {fmt}", fmt,
                   cuda_ops.graph_strip_mc(xin, 0.5, prog._strip_plan[1]), per_node)
    for name, count in cuda_ops.LAUNCHES.items():
        if count == 0:
            raise AssertionError(f"{name} never launched in the kernel checks")

    # ---- 4. the main paths at 3840x2160 through Engine ---------------------------
    u8 = rng.integers(0, 256, size=(HEIGHT, WIDTH, 4), dtype=np.uint8)
    # Removed when the script ends, failed or not (TemporaryDirectory's finalizer).
    tmp_dir = tempfile.TemporaryDirectory(prefix="rf_chip_smoke_")
    tmp = tmp_dir.name
    configs = {}
    large_radius = {
        "box_blur_120": "input -> n -> output\nn: box_blur { radius: 120 }",
        "kuwahara_130": "input -> n -> output\nn: kuwahara { radius: 130 }",
    }
    graphs_d = {**LIBRARY_GRAPHS, **large_radius}
    for name, text in (("flagship", FLAGSHIP_CONFIG), ("demo", DEMO_CONFIG),
                       ("edges", EDGES_CONFIG), ("chain3", CHAIN3_CONFIG),
                       *STYLIZED_GRAPHS.items(), *graphs_d.items()):
        configs[name] = os.path.join(tmp, f"{name}.rf")
        with open(configs[name], "w") as f:
            f.write(text)
    for name in GLSL_EXAMPLES:
        configs[name] = os.path.join(tmp, f"{name}.rf")
        with open(configs[name], "w") as f:
            f.write(example_config(name))
    for name, text in GLSL_GRAPHS.items():
        configs[name] = os.path.join(tmp, f"{name}.rf")
        with open(configs[name], "w") as f:
            f.write(text)
    # Paths A-D: an empty shader path, so that shaders/tonemap.comp,
    # vignette.comp, sharpen.comp, sobel.comp, blend.comp, kuwahara.comp and
    # the rest do not replace the builtins these paths measure.
    shader_dir = os.path.join(tmp, "shaders")
    os.mkdir(shader_dir)

    def info(graph, fmt, one_shot, shader_path=shader_dir):
        return RenderInfo(WIDTH, HEIGHT, "cuda", config_path=configs[graph],
                          shader_path=shader_path, fmt=fmt, has_input_image=True,
                          one_shot=one_shot)

    def drive(graph, fmt, shader_path=shader_dir):
        """One-shot (per node), the strip tier (render_frame, blocking, a
        sequence of 4) and run_per_node; returns the outputs and the
        counter deltas of the one-shot and of the strip tier."""
        before = dict(cuda_ops.LAUNCHES)
        one_shot = Engine(info(graph, fmt, True, shader_path)).render_one_shot(u8, 0.5)
        mid = dict(cuda_ops.LAUNCHES)
        engine = Engine(info(graph, fmt, False, shader_path))
        engine.load_input(u8)
        frame = engine.render_frame(0.5)
        engine.render_frame_blocking(0.516)
        seq = engine.program.render_sequence(engine._file_input(), 0.5, 0.016, 4, stack=True)
        after = dict(cuda_ops.LAUNCHES)
        per_node, times = engine.program.run_per_node(engine._file_input(), 0.5)
        engine.close()
        shot = {k: mid[k] - before[k] for k in before}
        tier = {k: after[k] - mid[k] for k in before}
        print(f"{graph} {fmt} per-node ms (host clock after sync): "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" [{smi}]")
        return one_shot, frame, seq, per_node, engine, shot, tier

    def check_outputs(graph, fmt, one_shot, frame, seq, per_node, engine, tier="strip tier",
                      shot_vs_per_node=False):
        """The tier against per node, a sequence against a frame, and the
        one-shot (per node) against the tier's frame in u8 codes, or against
        the per-node output where the tier's bound allows more than a code
        (``shot_vs_per_node``)."""
        for what, v in (("frame", frame), ("per-node", per_node)):
            if tuple(v.shape) != big or not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"{graph} {fmt} {what}: bad shape or non-finite values")
        if one_shot.shape != (HEIGHT, WIDTH, 4) or one_shot.dtype != np.uint8:
            raise AssertionError(f"{graph} {fmt} one-shot: bad image {one_shot.shape}")
        _check(f"{graph} {fmt} {tier} vs per-node tier 4K", _max_err(frame, per_node),
               1e-5 if fmt == "rgba32f" else 2e-2)
        _check(f"{graph} {fmt} render_sequence frame 0 vs render_frame", _max_err(seq[0], frame),
               0.0)
        strip_u8 = engine.read_output(per_node if shot_vs_per_node else frame).astype(np.int16)
        _check(f"{graph} {fmt} one-shot vs {'per-node tier' if shot_vs_per_node else tier} "
               f"(u8 codes)", float(np.abs(strip_u8 - one_shot.astype(np.int16)).max()), 1.0)

    # Path A: the flagship.
    cuda_ops.reset_launches()
    outputs = {fmt: drive("flagship", fmt) for fmt in ("rgba32f", "rgba16f")}
    counts_a = dict(cuda_ops.LAUNCHES)
    print(f"main path A (flagship) launches: {json.dumps(counts_a)}")
    for name in ("sep_conv_fused", "sep_conv_fused_multi", "sep_conv_fused_mxu", "graph_strip"):
        if counts_a[name] == 0:
            raise AssertionError(f"main path A never launched {name}")
    for fmt, out in outputs.items():
        check_outputs("flagship", fmt, *out[:5])

    # Path B: the demo and edges.
    cuda_ops.reset_launches()
    outputs = {(g, fmt): drive(g, fmt) for g in ("demo", "edges") for fmt in ("rgba32f", "rgba16f")}
    counts_b = dict(cuda_ops.LAUNCHES)
    print(f"main path B (demo, edges) launches: {json.dumps(counts_b)}")
    for name in ("sep_conv_fused_mxu_x3", "sep_conv_fused_mxu", "stencil_apply", "graph_strip_mc"):
        if counts_b[name] == 0:
            raise AssertionError(f"main path B never launched {name}")
    for (graph, fmt), out in outputs.items():
        shot, tier = out[5], out[6]
        needed = ["stencil_apply"]
        if graph == "demo":
            needed.append("sep_conv_fused_mxu_x3" if fmt == "rgba32f" else "sep_conv_fused_mxu")
        for name in needed:
            if shot[name] == 0:
                raise AssertionError(f"{graph} {fmt} one-shot never launched {name}")
        if tier["graph_strip_mc"] != 6:
            raise AssertionError(f"{graph} {fmt}: {tier['graph_strip_mc']} graph_strip_mc launches "
                                 "for 6 strip-tier frames")
        check_outputs(graph, fmt, *out[:5])

    # Path C: the stylized graphs, per node on every tier.  Launches per
    # frame: bilateral one stencil_reduce_mc, kuwahara four sep_conv_fused
    # (its (6, H, W) stack in f32 in either format), nothing else.
    per_frame_c = {"newsprint": {"stencil_reduce_mc": 1},
                   "watercolor": {"stencil_reduce_mc": 1, "sep_conv_fused": 4},
                   "oil_paint": {"sep_conv_fused": 4}}
    cuda_ops.reset_launches()
    outputs, built = {}, {}
    for graph in STYLIZED_GRAPHS:
        for fmt in ("rgba32f", "rgba16f"):
            outputs[(graph, fmt)] = drive(graph, fmt)
            before = dict(cuda_ops.LAUNCHES)
            prog = build_program(STYLIZED_GRAPHS[graph], WIDTH, HEIGHT, fmt, device=dev)
            xin = x4k.to(prog.storage_dtype)
            out = prog._forward(xin, 0.5)
            torch.cuda.synchronize()
            built[(graph, fmt)] = (prog, xin, out,
                                   {k: cuda_ops.LAUNCHES[k] - before[k] for k in before})
    counts_c = dict(cuda_ops.LAUNCHES)
    print(f"main path C (newsprint, watercolor, oil paint) launches: {json.dumps(counts_c)}")
    for (graph, fmt), out in outputs.items():
        prog, _xin, frame, built_counts = built[(graph, fmt)]
        if prog._strip_plan is not None:
            raise AssertionError(f"{graph} {fmt}: a strip plan where the reference has none")
        # one-shot: 1 frame; Engine's frame path: 6 (render_frame, blocking, 4 in a sequence);
        # build_program's program: 1
        for what, counts, frames in (("one-shot", out[5], 1), ("frame path", out[6], 6),
                                     ("build_program", built_counts, 1)):
            want = {k: frames * per_frame_c[graph].get(k, 0) for k in counts}
            if counts != want:
                raise AssertionError(f"{graph} {fmt} {what}: launches {counts}, expected {want}")
        if tuple(frame.shape) != big or not bool(torch.isfinite(frame.float()).all()):
            raise AssertionError(f"{graph} {fmt} build_program: bad shape or non-finite values")
        check_outputs(graph, fmt, *out[:5], tier="frame path")

    # Path D: the rest of the builtin library, and the large-radius convs
    # that raised on the card before.  Launches per frame on the frame path
    # and build_program's program: frost and box_blur r120 one conv1d_h and
    # one conv1d_w, kuwahara r130 four of each (its quadrant convs of the
    # 6-channel stack), neon edges one graph_strip_mc; the rest none (plain
    # PyTorch).  The one-shot runs neon edges per node: its two gaussian
    # convs (sep_conv_fused, or the bf16 entry in rgba16f) and sobel's two
    # stencil passes.
    per_frame_d = {name: {} for name in graphs_d}
    per_frame_d.update(neon_edges={"graph_strip_mc": 1},
                       frost={"conv1d_h": 1, "conv1d_w": 1},
                       box_blur_120={"conv1d_h": 1, "conv1d_w": 1},
                       kuwahara_130={"conv1d_h": 4, "conv1d_w": 4})
    cuda_ops.reset_launches()
    outputs, built_d = {}, {}
    for graph in graphs_d:
        for fmt in ("rgba32f", "rgba16f"):
            outputs[(graph, fmt)] = drive(graph, fmt)
            before = dict(cuda_ops.LAUNCHES)
            prog = build_program(graphs_d[graph], WIDTH, HEIGHT, fmt, device=dev)
            xin = x4k.to(prog.storage_dtype)
            out = prog._forward(xin, 0.5)
            torch.cuda.synchronize()
            built_d[(graph, fmt)] = (prog, xin, out,
                                     {k: cuda_ops.LAUNCHES[k] - before[k] for k in before})
    counts_d = dict(cuda_ops.LAUNCHES)
    print(f"main path D (film look, old film, pop art, psychedelic, neon edges, frost, box_blur "
          f"r120, kuwahara r130) launches: {json.dumps(counts_d)}")
    for name in ("conv1d_h", "conv1d_w", "graph_strip_mc"):
        if counts_d[name] == 0:
            raise AssertionError(f"main path D never launched {name}")
    for (graph, fmt), out in outputs.items():
        prog, _xin, frame, built_counts = built_d[(graph, fmt)]
        tier = prog._strip_plan[0] if prog._strip_plan else None
        if tier != ("mc" if graph == "neon_edges" else None):
            raise AssertionError(f"{graph} {fmt}: tier {tier}")
        shot_want = per_frame_d[graph]
        if graph == "neon_edges":
            conv = "sep_conv_fused" if fmt == "rgba32f" else "sep_conv_fused_mxu"
            shot_want = {conv: 2, "stencil_apply": 2}
        for what, counts, want1, frames in (("one-shot", out[5], shot_want, 1),
                                            ("frame path", out[6], per_frame_d[graph], 6),
                                            ("build_program", built_counts, per_frame_d[graph], 1)):
            want = {k: frames * want1.get(k, 0) for k in counts}
            if counts != want:
                raise AssertionError(f"{graph} {fmt} {what}: launches {counts}, expected {want}")
        if tuple(frame.shape) != big or not bool(torch.isfinite(frame.float()).all()):
            raise AssertionError(f"{graph} {fmt} build_program: bad shape or non-finite values")
        check_outputs(graph, fmt, *out[:5],
                      tier="mc tier" if graph == "neon_edges" else "frame path")
    del outputs

    # Path E: GLSL shaders on images through Engine from the repository
    # root, with the default shader path ("shaders").  E1 the default config
    # (passthrough.comp, per node through the interpreter); E2 glsl_blur and
    # E3 glsl_blur_sharpen on the mc tier (one graph_strip_mc a frame;
    # their one-shot runs the interpreter per node and launches nothing);
    # E4 the reference's glsl_chain and glsl_sharpen per node (tonemap.comp
    # is a point shader: no device form, no kernel); E5 the image-only
    # examples in rgba32f, one frame each on the tier the planner picks,
    # and their per-node times.
    if not os.path.isfile(os.path.join("shaders", "passthrough.comp")):
        raise AssertionError("path E runs from the repository root (shaders/passthrough.comp)")
    cuda_ops.reset_launches()
    for fmt in ("rgba32f", "rgba16f"):
        engine = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", fmt=fmt))
        engine.load_input(u8)
        frame = engine.render_frame_blocking(0.5)
        if engine.program._strip_plan is not None:
            raise AssertionError(f"E1 {fmt}: a strip plan for the default config")
        _check(f"E1 default config (passthrough.comp) {fmt} 4K vs its input", _max_err(
            frame, engine._file_input().to(engine.program.storage_dtype)), 0.0)
        engine.close()
    outputs = {(g, fmt): drive(g, fmt, SHADER_DIR) for g in GLSL_GRAPHS
               for fmt in ("rgba32f", "rgba16f")}
    e5 = {}
    for name in GLSL_EXAMPLES:
        engine = Engine(info(name, "rgba32f", False, SHADER_DIR))
        engine.load_input(u8)
        before = dict(cuda_ops.LAUNCHES)
        start = time.perf_counter()
        frame = engine.render_frame_blocking(0.5)
        frame_ms = (time.perf_counter() - start) * 1e3
        launched = {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items() if v != before[k]}
        _out, times = engine.program.run_per_node(engine._file_input(), 0.5)
        engine.close()
        if tuple(frame.shape) != big or not bool(torch.isfinite(frame.float()).all()):
            raise AssertionError(f"E5 {name}: bad shape or non-finite values")
        tier = engine.program._strip_plan[0] if engine.program._strip_plan else "per-node"
        e5[name] = (tier, frame_ms, times)
        print(f"E5 {name} rgba32f 4K: {tier}, first frame {frame_ms:.2f} ms, launches "
              f"{json.dumps(launched)}; per-node ms (host clock after sync): "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" [{smi}]")
    counts_e = dict(cuda_ops.LAUNCHES)
    print(f"main path E (GLSL: default config, glsl_blur, glsl_blur_sharpen, glsl_chain, "
          f"glsl_sharpen, {len(GLSL_EXAMPLES)} examples) launches: {json.dumps(counts_e)}")
    if counts_e["graph_strip_mc"] == 0:
        raise AssertionError("main path E never launched graph_strip_mc")
    for (graph, fmt), out in outputs.items():
        prog = out[4].program
        on_mc = graph in ("glsl_blur", "glsl_blur_sharpen")
        tier = prog._strip_plan[0] if prog._strip_plan else None
        if tier != ("mc" if on_mc else None):
            raise AssertionError(f"{graph} {fmt}: tier {tier}")
        frame_want = {"graph_strip_mc": 6} if on_mc else {}
        for what, counts, want1 in (("one-shot", out[5], {}), ("frame path", out[6], frame_want)):
            want = {k: want1.get(k, 0) for k in counts}
            if counts != want:
                raise AssertionError(f"{graph} {fmt} {what}: launches {counts}, expected {want}")
        # rgba16f: the mc tier's bf16 roundings differ from per node's by up
        # to 2e-2, which sRGB's slope turns into more than one u8 code.
        check_outputs(graph, fmt, *out[:5], tier="mc tier" if on_mc else "frame path",
                      shot_vs_per_node=on_mc and fmt == "rgba16f")
    del outputs

    # Small renders on the card against the port's CPU path, both tiers.
    small_x = rng.random((4, 288, 512), dtype=np.float32)
    for graph in ("flagship", "demo", "edges", "chain3"):
        config = {"flagship": FLAGSHIP_CONFIG, **graphs}[graph]
        for fmt in ("rgba32f", "rgba16f"):
            for plan_strips in (True, False):
                gpu = build_program(config, 512, 288, fmt, device=dev, plan_strips=plan_strips)
                cpu = build_program(config, 512, 288, fmt, device="cpu", plan_strips=plan_strips)
                got = gpu._forward(torch.from_numpy(small_x).to(dev), 0.5).cpu()
                want = cpu._forward(torch.from_numpy(small_x), 0.5)
                tier = gpu._strip_plan[0] if plan_strips else "per-node"
                _check(f"{graph} {fmt} {tier} 512x288 card vs CPU", _max_err(got, want),
                       1e-5 if fmt == "rgba32f" else 2e-2)
    # The stylized graphs, per node, in three formats.  rgba32f: exp and
    # pow differ by an ulp or two between the card and the CPU, within
    # 1e-5.  rgba16f and rgba8: such an ulp flips a bf16 rounding or a
    # 1/255 bucket before a store, and halftone's dot radius amplifies a
    # flip of its cell's luma near the dot's rim; held as a fraction: at
    # most 1e-3 of the values may differ by more than the storage step
    # (2e-2, or two buckets), none by more than 0.25.
    for graph, config in STYLIZED_GRAPHS.items():
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            gpu = build_program(config, 512, 288, fmt, device=dev)
            cpu = build_program(config, 512, 288, fmt, device="cpu")
            got = gpu._forward(torch.from_numpy(small_x).to(dev), 0.5).cpu().float()
            want = cpu._forward(torch.from_numpy(small_x), 0.5).float()
            d = (got - want).abs()
            if fmt == "rgba32f":
                _check(f"{graph} {fmt} per-node 512x288 card vs CPU", float(d.max()), 1e-5)
                continue
            step = 2e-2 if fmt == "rgba16f" else 2.0 / 255.0 + 1e-6
            frac = float((d > step).float().mean())
            if frac > 1e-3 or float(d.max()) > 0.25:
                raise AssertionError(f"{graph} {fmt} 512x288 card vs CPU: max {float(d.max())}, "
                                     f"fraction above {step:.3g} {frac}")
            print(f"check {graph} {fmt} per-node 512x288 card vs CPU: max abs error "
                  f"{float(d.max()):.3g}, fraction above {step:.3g} {frac:.3g}")

    # Path D's graphs at 512x288 on the card against the CPU path: rgba32f
    # within 1e-5 (the mc kernel's conv FMAs, pow by an ulp); psychedelic
    # within 1e-4: swirl's cos and sin differ by an ulp between the card
    # and the CPU, which moves a sample by up to its distance from the
    # centre (about 290 px) times 1.2e-7, and a random image changes by up
    # to 1 a pixel (measured 2.8e-5).  rgba16f within one bf16 step of the
    # value and rgba8 within one code, where such a difference flips a
    # rounding before a store.
    tol32_d = {"psychedelic": 1e-4}
    for graph, config in graphs_d.items():
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            gpu = build_program(config, 512, 288, fmt, device=dev)
            cpu = build_program(config, 512, 288, fmt, device="cpu")
            got = gpu._forward(torch.from_numpy(small_x).to(dev), 0.5).cpu().float()
            want = cpu._forward(torch.from_numpy(small_x), 0.5).float()
            d = (got - want).abs()
            what = f"{graph} {fmt} {'mc tier' if gpu._strip_plan else 'per-node'} 512x288 card vs CPU"
            if fmt == "rgba32f":
                _check(what, float(d.max()), tol32_d.get(graph, 1e-5))
                continue
            if fmt == "rgba16f":
                mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
                step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            else:
                step = torch.full_like(d, 1.0 / 255.0)
            excess = float((d - step).max())
            if excess > 1e-6:
                raise AssertionError(f"{what}: a difference {excess} past one storage step")
            print(f"check {what}: max abs error {float(d.max()):.3g} (one storage step), "
                  f"values that differ {float((d > 0).float().mean()):.3g}")

    # Path E's graphs at 512x288 on the card against the CPU path.  rgba32f
    # within 1e-5 but where an ulp of a transcendental moves a sample:
    # glass.comp (refraction by sin and cos) and raymarch.comp (a march of
    # up to 64 steps) within 1e-4 (measured 3.4e-5 and 3.9e-5), and
    # psychedelic as in path D; mandelzoom (mandelbrot.comp) as a share of
    # values, since an escape-time edge flips a pixel's whole colour (as
    # tests/test_scalar_ref.py notes): at most 1% of the values may differ
    # by more than 1e-4 (measured 0.3%).  rgba16f and rgba8 (the GLSL
    # graphs) within one storage step of the value, or seven where
    # sharpen.comp (amount 0.7: 1 + 8 * 0.7 = 6.6) follows a conv whose
    # FMAs on the card flip a rounding of the CPU's multiply-adds.
    tol32_e = {"glass": 1e-4, "raymarch": 1e-4, "psychedelic": 1e-4}
    cases_e = [(g, c, fmt) for g, c in GLSL_GRAPHS.items() for fmt in ("rgba32f", "rgba16f", "rgba8")]
    cases_e += [(g, example_config(g), "rgba32f") for g in GLSL_EXAMPLES]
    for graph, config, fmt in cases_e:
        gpu = build_program(config, 512, 288, fmt, device=dev, shader_path=SHADER_DIR)
        cpu = build_program(config, 512, 288, fmt, device="cpu", shader_path=SHADER_DIR)
        got = gpu._forward(torch.from_numpy(small_x).to(dev), 0.5).cpu().float()
        want = cpu._forward(torch.from_numpy(small_x), 0.5).float()
        d = (got - want).abs()
        what = f"{graph} {fmt} {'mc tier' if gpu._strip_plan else 'per-node'} 512x288 card vs CPU"
        if graph == "mandelzoom":
            share = float((d > 1e-4).float().mean())
            if share > 1e-2:
                raise AssertionError(f"{what}: {share} of the values differ by more than 1e-4")
            print(f"check {what}: share of values off by more than 1e-4 {share:.3g} <= 0.01 "
                  f"(max {float(d.max()):.3g})")
            continue
        if fmt == "rgba32f":
            _check(what, float(d.max()), tol32_e.get(graph, 1e-5))
            continue
        if fmt == "rgba16f":
            mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
            step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        else:
            step = torch.full_like(d, 1.0 / 255.0)
        steps = 7 if graph == "glsl_blur_sharpen" else 1
        excess = float((d - steps * step).max())
        if excess > 1e-6:
            raise AssertionError(f"{what}: a difference {excess} past {steps} storage steps")
        print(f"check {what}: max abs error {float(d.max()):.3g} ({steps} storage steps), "
              f"values that differ {float((d > 0).float().mean()):.3g}")

    # ---- 5. timings -----------------------------------------------------------
    # The kernel table first, while the card is cool (the frame timings
    # below keep it busy for a minute); the card's clock, power and
    # temperature before and after each group of timings.
    print(f"card state before the kernel timings: {_card_state()}")
    n_px = 4 * HEIGHT * WIDTH
    prog32, x32 = strips["rgba32f"]
    epilogue_ops = {cuda_ops.OP_COPY: 0, cuda_ops.OP_TAKE1: 0, cuda_ops.OP_UNSHARP: 3,
                    cuda_ops.OP_MIX: 3, cuda_ops.OP_ACES: 10, cuda_ops.OP_REINHARD: 3,
                    cuda_ops.OP_VIGNETTE: 15, cuda_ops.OP_FADE_PLANE: 1}
    strip_ops = n_px * (2 * sum(len(a) + len(b) for a, b in prog32._strip_program.plans)
                        + sum(epilogue_ops[op.code] for op in prog32._strip_program.ops))
    demo_prog, demo_x = mc_progs[("demo", "rgba32f")]
    demo_mc = demo_prog._strip_plan[1]
    timed = {
        "sep_conv_fused": (lambda: cuda_ops.sep_conv_fused(x4k, w4, w4),
                           lambda: cuda_ops.sep_conv_plain(x4k, [(w4, w4)]),
                           _library_sep_conv(x4k, [(w4, w4)]),
                           _bound(2 * 4 * n_px, 2 * 50 * n_px)),
        "sep_conv_fused_multi": (
            lambda: cuda_ops.sep_conv_fused_multi(x4k, [(w2, w2), (w4, w4)]),
            lambda: cuda_ops.sep_conv_plain(x4k, [(w2, w2), (w4, w4)]),
            _library_sep_conv(x4k, [(w2, w2), (w4, w4)]),
            _bound(3 * 4 * n_px, 2 * 76 * n_px)),
        "sep_conv_fused_mxu": (lambda: cuda_ops.sep_conv_fused_mxu(x4k_bf, w4, w4),
                               lambda: cuda_ops.sep_conv_plain(x4k_bf, [(w4, w4)]),
                               _library_sep_conv(x4k_bf, [(w4, w4)]),
                               _bound(6 * n_px, 2 * 50 * n_px)),
        "graph_strip": (lambda: cuda_ops.graph_strip(x32, 0.5, prog32._strip_program),
                        lambda: cuda_ops.graph_strip_plain(x32, 0.5, prog32._strip_program),
                        None,
                        _bound(2 * 4 * n_px + 4 * HEIGHT * WIDTH, strip_ops)),
        "sep_conv_fused_mxu_x3": (lambda: cuda_ops.sep_conv_fused_mxu_x3(x4k, w8, w8),
                                  lambda: cuda_ops.sep_conv_plain(x4k, [(w8, w8)]),
                                  _library_sep_conv(x4k, [(w8, w8)]),
                                  _bound(2 * 4 * n_px, 2 * 98 * n_px)),
        "stencil_apply": (
            lambda: cuda_ops.stencil_apply(x4k, 1, 1, cuda_ops.wsum(library.SHARPEN_TAPS)),
            lambda: cuda_ops.stencil_apply_plain(x4k, 1, 1, cuda_ops.wsum(library.SHARPEN_TAPS)),
            _library_stencil(x4k, library.SHARPEN_TAPS),
            _bound(2 * 4 * n_px, 9 * n_px)),
        "graph_strip_mc": (lambda: cuda_ops.graph_strip_mc(demo_x, 0.5, demo_mc),
                           lambda: cuda_ops.graph_strip_mc_plain(demo_x, 0.5, demo_mc),
                           None,
                           _bound(2 * 4 * n_px, HEIGHT * WIDTH * _mc_ops_per_pixel(demo_mc, cuda_ops))),
    }
    for r in (160, 400):
        wr = box_weights(r)
        for along_h in (True, False):
            kname = "conv1d_h" if along_h else "conv1d_w"
            entry = cuda_ops.conv1d_h if along_h else cuda_ops.conv1d_w
            timed[kname if r == 160 else f"{kname} r={r}"] = (
                lambda e=entry, w=wr: e(x4k, w),
                lambda w=wr, d=-2 if along_h else -1: cuda_ops.correlate1d(x4k, w, d),
                _library_conv1d(x4k, wr, along_h),
                _bound(2 * 4 * n_px, 2 * len(wr) * n_px))
    r4, op4 = reduce_ops["r4"]
    reduce_bound_ms, reduce_bound_by, reduce_terms = _reduce_bound(
        HEIGHT * WIDTH, len(op4.taps), max_sm_mhz, n_sms)
    print(f"stencil_reduce_mc bound terms at 4K r={r4} ({len(op4.taps)} taps): {reduce_terms}")
    timed["stencil_reduce_mc"] = (lambda: cuda_ops.stencil_reduce_mc(stack4k, r4, r4, op4),
                                  lambda: cuda_ops.stencil_reduce_mc_plain(stack4k, r4, r4, op4),
                                  None, (reduce_bound_ms, reduce_bound_by))
    # stencil_apply_mc: 4 -> 4 channels at radius 2 (400 terms).  Bound:
    # four planes read and four written, or a multiply and an add per term
    # and pixel.  Library: one replicate (or zero) pad and one dense
    # F.conv2d with the (4, 4, 5, 5) table.
    op9 = lin_ops["4->4 r2"]
    k9 = torch.from_numpy(op9.weights).to(dev)
    timed["stencil_apply_mc"] = (
        lambda: cuda_ops.stencil_apply_mc(x4k, op9),
        lambda: cuda_ops.stencil_apply_mc_plain(x4k, op9),
        lambda: F.conv2d(F.pad(x4k[None], (2, 2, 2, 2), mode="replicate"), k9)[0],
        _bound(2 * 4 * n_px, 2 * op9.n_terms * HEIGHT * WIDTH))
    lib9 = F.conv2d(F.pad(x4k[None], (2, 2, 2, 2), mode="replicate"), k9)[0]
    print(f"library stencil (replicate pad + dense conv2d, TF32 off) vs plain, 4->4 r2: "
          f"{_max_err(lib9, cuda_ops.stencil_apply_mc_plain(x4k, op9)):.3g}")
    del lib9
    ms = {}
    for name, (kernel, plain, lib_call, (bound_ms, bound_by)) in timed.items():
        k_ms = _time_ms(kernel, 20)
        p_ms = _time_ms(plain, 5)
        l_ms = _time_ms(lib_call, 20) if lib_call is not None else None
        ms[name] = (k_ms, p_ms, bound_ms, bound_by, l_ms)
        lib_txt = f"{l_ms:.3f}" if l_ms is not None else "no single call"
        print(f"{name} 4K: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), library {lib_txt} [{smi}]")
    lib_err = max(_max_err(g, w) for g, w in zip(_library_sep_conv(x4k, [(w8, w8)])(),
                                                  cuda_ops.sep_conv_plain(x4k, [(w8, w8)])))
    print(f"library conv (replicate pad + depthwise conv2d, TF32 off) vs plain, r=24: {lib_err:.3g}")
    extra = {
        "graph_strip rgba16f": (lambda: cuda_ops.graph_strip(strips["rgba16f"][1], 0.5,
                                                             strips["rgba16f"][0]._strip_program)),
        "stencil_apply median9 4ch": lambda: cuda_ops.stencil_apply(x4k, 1, 1, cuda_ops.MEDIAN9),
        "stencil_apply sobel_x 1ch": lambda: cuda_ops.stencil_apply(
            luma4k, 1, 1, cuda_ops.wsum(library.SOBEL_X_TAPS)),
        "stencil_reduce_mc bilateral r=3 (watercolor)": lambda: cuda_ops.stencil_reduce_mc(
            stack4k, 3, 3, reduce_ops["r3"][1]),
    }
    for (graph, fmt), (prog, x) in mc_progs.items():
        if fmt != "rgba8":
            extra[f"graph_strip_mc {graph} {fmt}"] = (
                lambda p=prog, v=x: cuda_ops.graph_strip_mc(v, 0.5, p._strip_plan[1]))
    for name, fn in extra.items():
        print(f"{name} 4K: kernel {_time_ms(fn, 20):.3f} ms [{smi}]")
    print(f"card state after the kernel timings: {_card_state()}")
    for fmt in ("rgba32f", "rgba16f"):
        prog, x = strips[fmt]
        seq = bench_program_sequenced(prog, x, frames=96, chunk=24)
        disp = bench_program(prog, x, frames=48)
        print(f"flagship {fmt} strip tier 4K: sequenced {seq['fps']:.2f} fps, per-dispatch "
              f"{disp['fps']:.2f} fps [{smi}]")
    for graph in graphs:
        for fmt in ("rgba32f", "rgba16f"):
            prog, x = mc_progs[(graph, fmt)]
            seq = bench_program_sequenced(prog, x, frames=96, chunk=24)
            disp = bench_program(prog, x, frames=48)
            pn = build_program(graphs[graph], WIDTH, HEIGHT, fmt, device=dev, plan_strips=False)
            pn_ms = _time_ms(lambda: pn._forward(x, 0.5), 10)
            print(f"{graph} {fmt} mc tier 4K: sequenced {seq['fps']:.2f} fps, per-dispatch "
                  f"{disp['fps']:.2f} fps; per-node tier {pn_ms:.3f} ms a frame [{smi}]")
    # Path E: the GLSL graphs on their tiers (E2 and E3 on the mc tier,
    # against their per-node tier: the interpreter), E4 per node.
    for graph, config in GLSL_GRAPHS.items():
        for fmt in ("rgba32f", "rgba16f"):
            prog = build_program(config, WIDTH, HEIGHT, fmt, device=dev, shader_path=SHADER_DIR)
            x = x4k.to(prog.storage_dtype)
            seq = bench_program_sequenced(prog, x, frames=48, chunk=24)
            tier = "mc tier" if prog._strip_plan else "per-node"
            line = (f"{graph} {fmt} {tier} 4K: sequenced {seq['ms_per_frame']:.3f} ms a frame "
                    f"({seq['fps']:.2f} fps)")
            if prog._strip_plan:
                pn = build_program(config, WIDTH, HEIGHT, fmt, device=dev, plan_strips=False,
                                   shader_path=SHADER_DIR)
                line += f"; per-node tier {_time_ms(lambda: pn._forward(x, 0.5), 5):.3f} ms a frame"
            print(f"{line} [{smi}]")
    for (graph, fmt), (prog, x, _out, _counts) in built.items():
        seq = bench_program_sequenced(prog, x, frames=48, chunk=24)
        disp = bench_program(prog, x, frames=24)
        print(f"{graph} {fmt} per-node 4K: sequenced {seq['ms_per_frame']:.3f} ms a frame "
              f"({seq['fps']:.2f} fps), per-dispatch {disp['ms_per_frame']:.3f} ms "
              f"({disp['fps']:.2f} fps) [{smi}]")
    frame_ms_d = {}
    for (graph, fmt), (prog, x, _out, _counts) in built_d.items():
        seq = bench_program_sequenced(prog, x, frames=48, chunk=24)
        disp = bench_program(prog, x, frames=24)
        frame_ms_d[(graph, fmt)] = seq["ms_per_frame"]
        tier = "mc tier" if prog._strip_plan else "per-node"
        print(f"{graph} {fmt} {tier} 4K: sequenced {seq['ms_per_frame']:.3f} ms a frame "
              f"({seq['fps']:.2f} fps), per-dispatch {disp['ms_per_frame']:.3f} ms "
              f"({disp['fps']:.2f} fps) [{smi}]")
    # Neon edges: the port's tier rule (mc whenever a plan fits) meets the
    # first graph the reference runs as segments; against per node.
    for fmt in ("rgba32f", "rgba16f"):
        prog, x, _out, _counts = built_d[("neon_edges", fmt)]
        pn = build_program(LIBRARY_GRAPHS["neon_edges"], WIDTH, HEIGHT, fmt, device=dev,
                           plan_strips=False)
        mc_ms = _time_ms(lambda: prog._forward(x, 0.5), 20)
        pn_ms = _time_ms(lambda: pn._forward(x, 0.5), 20)
        print(f"neon_edges {fmt} 4K: mc tier {mc_ms:.3f} ms a frame (tile "
              f"{prog._strip_plan[1].tile()[:2]}), per-node tier {pn_ms:.3f} ms a frame [{smi}]")
    for graph in ("flagship", "demo", "newsprint", "frost"):
        for fmt in ("rgba32f", "rgba16f"):
            engine = Engine(info(graph, fmt, True))
            lat = []
            for _ in range(5):
                start = time.perf_counter()
                engine.render_one_shot(u8, 0.5)
                lat.append((time.perf_counter() - start) * 1000.0)
            print(f"{graph} {fmt} one-shot 4K latency (u8 in, u8 on the host out): median "
                  f"{statistics.median(lat):.2f} ms of {len(lat)} [{smi}]")

    print(f"card state after the frame timings: {_card_state()}")

    # Where the device time goes: the mc tier over 24 frames and the
    # per-node tier over 3, rgba32f.
    for graph in graphs:
        prog, x = mc_progs[(graph, "rgba32f")]
        pn = build_program(graphs[graph], WIDTH, HEIGHT, "rgba32f", device=dev, plan_strips=False)
        for tier, fn, frames in (("mc", lambda: prog._forward(x, 0.5), 24),
                                 ("per-node", lambda: pn._forward(x, 0.5), 3)):
            rows, busy = _profile(fn, frames)
            top = "; ".join(f"{k[:60]} {ms:.3f}" for k, ms in rows[:6])
            print(f"profile {graph} rgba32f {tier}: device busy {busy:.1%}; ms a frame: {top} [{smi}]")
    slowest = max(LIBRARY_GRAPHS, key=lambda g: frame_ms_d[(g, "rgba32f")])
    for graph in ("watercolor", "newsprint", "frost", slowest):
        prog, x, _out, _counts = (built_d if graph in graphs_d else built)[(graph, "rgba32f")]
        rows, busy = _profile(lambda: prog._forward(x, 0.5), 3)
        top = "; ".join(f"{k[:60]} {ms:.3f}" for k, ms in rows[:10])
        print(f"profile {graph} rgba32f per-node: device busy {busy:.1%}; device ms a frame "
              f"{sum(ms for _, ms in rows):.3f}: {top} [{smi}]")


    sources = {
        "graph_strip": "reforge_tpu_torch/csrc/graph_strip.cu",
        "stencil_apply": "reforge_tpu_torch/csrc/stencil.cu",
        "graph_strip_mc": "reforge_tpu_torch/csrc/graph_strip_mc.cu",
        "stencil_reduce_mc": "reforge_tpu_torch/csrc/stencil_reduce.cu",
        "conv1d_h": "reforge_tpu_torch/csrc/conv1d.cu",
        "conv1d_w": "reforge_tpu_torch/csrc/conv1d.cu",
        "stencil_apply_mc": "reforge_tpu_torch/csrc/stencil_mc.cu",
    }
    replaces = {
        "sep_conv_fused": "reforge_tpu/kernels/pallas_ops.py:1723",
        "sep_conv_fused_multi": "reforge_tpu/kernels/pallas_ops.py:953",
        "sep_conv_fused_mxu": "reforge_tpu/kernels/pallas_ops.py:496",
        "graph_strip": "reforge_tpu/kernels/pallas_ops.py:1396",
        "sep_conv_fused_mxu_x3": "reforge_tpu/kernels/pallas_ops.py:739",
        "stencil_apply": "reforge_tpu/kernels/pallas_ops.py:1935",
        "graph_strip_mc": "reforge_tpu/kernels/pallas_ops.py:2955",
        "stencil_reduce_mc": "reforge_tpu/kernels/pallas_ops.py:2197",
        "conv1d_h": "reforge_tpu/kernels/pallas_ops.py:65",
        "conv1d_w": "reforge_tpu/kernels/pallas_ops.py:101",
        "stencil_apply_mc": "reforge_tpu/kernels/pallas_ops.py:2082",
    }
    # Each kernel's launches come from the main path it belongs to;
    # stencil_apply_mc's from path E, where nothing calls it (0).
    path_of = {"sep_conv_fused": counts_a, "sep_conv_fused_multi": counts_a,
               "sep_conv_fused_mxu": counts_a, "graph_strip": counts_a,
               "stencil_reduce_mc": counts_c, "conv1d_h": counts_d, "conv1d_w": counts_d,
               "stencil_apply_mc": counts_e}
    launches = {name: path_of.get(name, counts_b)[name] for name in replaces}
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": sources.get(name, "reforge_tpu_torch/csrc/sep_conv.cu"),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms[name][0], "plain_ms": ms[name][1],
            "bound_ms": ms[name][2], "bound_by": ms[name][3], "library_ms": ms[name][4],
        }
        for name in replaces
    ]
    tmp_dir.cleanup()
    synth_cache.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
