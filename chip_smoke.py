#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from
``reforge_tpu_torch/csrc`` (first use), holds each kernel against its
plain PyTorch version on the card, renders the flagship graph at
3840x2160 in rgba32f and rgba16f through ``Engine`` on both tiers
(one-shot per node with conv bundles, and the graph_strip tier), checks
the outputs, and prints timings beside the card's name and power limit.
The line before the last is a JSON object of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero without printing a result; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WIDTH, HEIGHT = 3840, 2160
SEED = 0


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


def _rgba8_check(name: str, a: torch.Tensor, b: torch.Tensor) -> float:
    # A pre-quantization difference of one rounding flips a 1/255 bucket
    # where a value sits on its edge, and a flip can cascade through one
    # more quantized node downstream: at most two steps, on few pixels.
    d = (a.float() - b.float()).abs()
    err = float(d.max())
    frac = float((d > 1.0 / 512.0).float().mean())
    if err > 2.0 / 255.0 + 1e-6 or frac > 1e-3:
        raise AssertionError(f"{name}: rgba8 max {err}, flipped fraction {frac}")
    print(f"check {name}: rgba8 max abs error {err:.3g}, flipped fraction {frac:.3g}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from reforge_tpu_torch.benchmarks import (
        FLAGSHIP_CONFIG, bench_program, bench_program_sequenced, build_flagship,
    )
    from reforge_tpu_torch.engine import Engine, RenderInfo
    from reforge_tpu_torch.kernels import cuda_ops
    from reforge_tpu_torch.kernels.ops import gaussian_weights

    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # ---- 2. build -----------------------------------------------------------
    start = time.perf_counter()
    cuda_ops.load_library()
    print(f"build: {time.perf_counter() - start:.2f} s (nvcc, sm_90a)")
    log = cuda_ops.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}", file=sys.stderr)

    # ---- 3. each kernel against its plain version ----------------------------
    cuda_ops.reset_launches()
    w4, w2 = gaussian_weights(4.0), gaussian_weights(2.0)  # soften, crisp
    w1, w96 = np.array([0.25, 0.5, 0.25], np.float32), gaussian_weights(32.0)
    big = (4, HEIGHT, WIDTH)
    x4k = torch.from_numpy(rng.random(big, dtype=np.float32)).to(dev)
    x4k_bf = x4k.to(torch.bfloat16)
    errs: dict[str, float] = {}

    def conv_case(name, entry, x, plans, mode, flagship):
        got = entry(x, plans, mode)
        want = cuda_ops.sep_conv_plain(x, plans, mode)
        torch.cuda.synchronize()
        err = max(_max_err(g, w) for g, w in zip(got, want))
        shape = "x".join(map(str, x.shape))
        _check(f"{name} {shape} {x.dtype} r={[(len(a) - 1) // 2 for a, _ in plans]} {mode}",
               err, _f32_tol(plans))
        if flagship:
            errs[name] = err

    entries = {
        "sep_conv_fused": lambda x, p, m: [cuda_ops.sep_conv_fused(x, *p[0], mode=m)],
        "sep_conv_fused_multi": lambda x, p, m: cuda_ops.sep_conv_fused_multi(x, p, mode=m),
        "sep_conv_fused_mxu": lambda x, p, m: [cuda_ops.sep_conv_fused_mxu(x, *p[0], mode=m)],
    }
    conv_case("sep_conv_fused", entries["sep_conv_fused"], x4k, [(w4, w4)], "edge", True)
    conv_case("sep_conv_fused_multi", entries["sep_conv_fused_multi"], x4k,
              [(w2, w2), (w4, w4)], "edge", True)
    conv_case("sep_conv_fused_mxu", entries["sep_conv_fused_mxu"], x4k_bf, [(w4, w4)], "edge", True)
    ragged = torch.from_numpy(rng.random((4, 37, 71), dtype=np.float32)).to(dev)
    for mode in ("edge", "zero"):
        for w in (w1, w96):
            conv_case("sep_conv_fused", entries["sep_conv_fused"], ragged, [(w, w)], mode, False)
            conv_case("sep_conv_fused_mxu", entries["sep_conv_fused_mxu"],
                      ragged.to(torch.bfloat16), [(w, w)], mode, False)
        conv_case("sep_conv_fused_multi", entries["sep_conv_fused_multi"], ragged,
                  [(w1, w1), (w96, w96), (w4, w2)], mode, False)

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
            name = f"graph_strip {fmt} {h}x{w}"
            if fmt == "rgba8":
                err = _rgba8_check(name, got, want)
            else:
                err = _max_err(got, want)
                _check(name, err, 1e-5 if fmt == "rgba32f" else 2e-2)
            if h == HEIGHT:
                strips[fmt] = (prog, x)
                if fmt == "rgba32f":
                    errs["graph_strip"] = err
    for name, count in cuda_ops.LAUNCHES.items():
        if count == 0:
            raise AssertionError(f"{name} never launched in the kernel checks")

    # ---- 4. the main path at 3840x2160 through Engine ---------------------------
    u8 = rng.integers(0, 256, size=(HEIGHT, WIDTH, 4), dtype=np.uint8)
    # Removed when the script ends, failed or not (TemporaryDirectory's finalizer).
    tmp_dir = tempfile.TemporaryDirectory(prefix="rf_chip_smoke_")
    tmp = tmp_dir.name
    config_path = os.path.join(tmp, "flagship.rf")
    with open(config_path, "w") as f:
        f.write(FLAGSHIP_CONFIG)
    # An empty shader path: shaders/tonemap.comp and shaders/vignette.comp
    # would otherwise replace the builtins, and GLSL is not ported yet.
    shader_dir = os.path.join(tmp, "shaders")
    os.mkdir(shader_dir)

    def info(fmt, one_shot):
        return RenderInfo(WIDTH, HEIGHT, "cuda", config_path=config_path,
                          shader_path=shader_dir, fmt=fmt, has_input_image=True,
                          one_shot=one_shot)

    cuda_ops.reset_launches()
    outputs = {}
    for fmt in ("rgba32f", "rgba16f"):
        one_shot = Engine(info(fmt, True)).render_one_shot(u8, 0.5)
        engine = Engine(info(fmt, False))
        engine.load_input(u8)
        frame = engine.render_frame(0.5)
        engine.render_frame_blocking(0.516)
        seq = engine.program.render_sequence(engine._file_input(), 0.5, 0.016, 4, stack=True)
        per_node, _times = engine.program.run_per_node(engine._file_input(), 0.5)
        engine.close()
        outputs[fmt] = (one_shot, frame, seq, per_node, engine)
    counts = dict(cuda_ops.LAUNCHES)
    print(f"main path launches: {json.dumps(counts)}")
    for name, count in counts.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")

    for fmt, (one_shot, frame, seq, per_node, engine) in outputs.items():
        for what, v in (("frame", frame), ("per-node", per_node)):
            if tuple(v.shape) != big or not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"{fmt} {what}: bad shape or non-finite values")
        if one_shot.shape != (HEIGHT, WIDTH, 4) or one_shot.dtype != np.uint8:
            raise AssertionError(f"{fmt} one-shot: bad image {one_shot.shape} {one_shot.dtype}")
        _check(f"{fmt} strip tier vs per-node tier 4K", _max_err(frame, per_node),
               1e-5 if fmt == "rgba32f" else 2e-2)
        _check(f"{fmt} render_sequence frame 0 vs render_frame", _max_err(seq[0], frame), 0.0)
        strip_u8 = engine.read_output(frame).astype(np.int16)
        _check(f"{fmt} one-shot vs strip tier (u8 codes)",
               float(np.abs(strip_u8 - one_shot.astype(np.int16)).max()), 1.0)

    # A small render on the card against the port's CPU path.
    small = rng.random((4, 288, 512), dtype=np.float32)
    for fmt in ("rgba32f", "rgba16f"):
        for plan_strips in (True, False):
            gpu = build_flagship(512, 288, fmt, device=dev, plan_strips=plan_strips)
            cpu = build_flagship(512, 288, fmt, device="cpu", plan_strips=plan_strips)
            got = gpu._forward(torch.from_numpy(small).to(dev), 0.5).cpu()
            want = cpu._forward(torch.from_numpy(small), 0.5)
            tier = "strip" if plan_strips else "per-node"
            _check(f"{fmt} {tier} 512x288 card vs CPU", _max_err(got, want),
                   1e-5 if fmt == "rgba32f" else 2e-2)

    # ---- 5. timings -----------------------------------------------------------
    for fmt in ("rgba32f", "rgba16f"):
        prog, x = strips[fmt]
        seq = bench_program_sequenced(prog, x, frames=120, chunk=24)
        disp = bench_program(prog, x, frames=60)
        print(f"{fmt} strip tier 4K: sequenced {seq['fps']:.2f} fps, per-dispatch "
              f"{disp['fps']:.2f} fps [{smi}]")
        engine = Engine(info(fmt, True))
        lat = []
        for i in range(5):
            start = time.perf_counter()
            engine.render_one_shot(u8, 0.5)
            lat.append((time.perf_counter() - start) * 1000.0)
        print(f"{fmt} one-shot 4K latency (u8 in, u8 on host out): median "
              f"{statistics.median(lat):.2f} ms of {len(lat)} [{smi}]")

    prog32, x32 = strips["rgba32f"]
    prog16, x16 = strips["rgba16f"]
    timed = {
        "sep_conv_fused": (lambda: cuda_ops.sep_conv_fused(x4k, w4, w4),
                           lambda: cuda_ops.sep_conv_plain(x4k, [(w4, w4)])),
        "sep_conv_fused_multi": (
            lambda: cuda_ops.sep_conv_fused_multi(x4k, [(w2, w2), (w4, w4)]),
            lambda: cuda_ops.sep_conv_plain(x4k, [(w2, w2), (w4, w4)])),
        "sep_conv_fused_mxu": (lambda: cuda_ops.sep_conv_fused_mxu(x4k_bf, w4, w4),
                               lambda: cuda_ops.sep_conv_plain(x4k_bf, [(w4, w4)])),
        "graph_strip": (lambda: cuda_ops.graph_strip(x32, 0.5, prog32._strip_program),
                        lambda: cuda_ops.graph_strip_plain(x32, 0.5, prog32._strip_program)),
    }
    ms = {}
    for name, (kernel, plain) in timed.items():
        ms[name] = (_time_ms(kernel, 20), _time_ms(plain, 5))
        print(f"{name} 4K: kernel {ms[name][0]:.3f} ms, plain {ms[name][1]:.3f} ms [{smi}]")
    k16 = _time_ms(lambda: cuda_ops.graph_strip(x16, 0.5, prog16._strip_program), 20)
    p16 = _time_ms(lambda: cuda_ops.graph_strip_plain(x16, 0.5, prog16._strip_program), 5)
    print(f"graph_strip rgba16f 4K: kernel {k16:.3f} ms, plain {p16:.3f} ms [{smi}]")

    source = {"graph_strip": "reforge_tpu_torch/csrc/graph_strip.cu"}
    replaces = {
        "sep_conv_fused": "reforge_tpu/kernels/pallas_ops.py:1723",
        "sep_conv_fused_multi": "reforge_tpu/kernels/pallas_ops.py:953",
        "sep_conv_fused_mxu": "reforge_tpu/kernels/pallas_ops.py:496",
        "graph_strip": "reforge_tpu/kernels/pallas_ops.py:1396",
    }
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": source.get(name, "reforge_tpu_torch/csrc/sep_conv.cu"),
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": ms[name][0], "plain_ms": ms[name][1],
        }
        for name in replaces
    ]
    tmp_dir.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
