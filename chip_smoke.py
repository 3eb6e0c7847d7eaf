#!/usr/bin/env python3
"""Parity check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from
``reforge_tpu_torch/csrc`` (first use; one nvcc per source, in parallel),
holds each kernel against its plain PyTorch version on the card, and
drives the main paths at 3840x2160 through ``Engine`` and the command
line, each with the launch counters set to 0 just before it and read just
after (eleven main paths, A-K):

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
     reference's glsl-chain and glsl-sharpen on the mc tier (tonemap.comp
     a GLSL point stage: its op list), and the examples whose shaders
     touch only images;
  F. storage buffers, atomics and lut1d: the examples equalize,
     auto_expose and waveform_scope and a lut1d graph (the port's
     gamma_curve.comp writes its Curve) per node in rgba32f and rgba16f,
     plain PyTorch (no kernel of its own): histogram counts and waveform
     columns exact at 4K, atomics bit-identical from run to run,
     expose_meter's summed luma against float64, card against CPU;
  G. live reload: config and shader edits, keep-last-good on bad ones,
     inline and with async_compile (whose build puts nothing on the card),
     resize, the preview downscale, and the adoption of
     four edits (one of them tonemap.comp in glsl-chain: translation,
     reflection and the op list's lowering), warm and cold, with the
     program cache's hits and the
     nodes each edit shape-checks;
  H. the command line (``cli.main``, no ``--backend``): a 4K PNG rendered
     headless with the flagship (one-shot per node), equal to
     ``render_one_shot``; a resize on input; card against ``--backend
     cpu``; the live loop of the demo (graph_strip_mc) with no preview and
     with the kitty preview; batch over a directory (graph_strip); an
     animated export and a transcode where the libav extension builds;
     ``python -m reforge_tpu_torch --profile``;
  I. the segments tier and a ``.py`` kernel: every graph the planner
     gives a segments plan at 4K (the shipped examples' plans printed),
     and a .py kernel at the head of gaussian -> sobel -> tonemap, in
     rgba32f and rgba16f, against per node, with the launches of a frame;
     the .py kernel in single-shader mode through ``cli.main``;
  J. GLSL point shaders and zero-border GLSL convs on the mc tier: the
     graphs of ``benchmarks.point_graphs()`` (glsl-chain, glsl-sharpen,
     tonemap.comp before sharpen.comp (its op list on an odd word),
     blur_sharpen_blend, bloom_glow; nblur.comp before a builtin tonemap
     in zero mode, and before a builtin gaussian on segments) and an op
     probe (a shader of every kind of op: time, uint, int division,
     branches, transcendentals) in three formats: the plan (with its
     halo recompute, and that of the demo, neon edges and bloom_glow's
     builtin form), the kernel
     against its plain version, each frame through Engine against the
     same program per node, and an op-count sweep of point shaders of 10
     to 160 ops after a gaussian, each kernel against its plain version.
     bloom_glow and the op probe run per node (the tier rule against
     halo recompute); their refused mc plans are checked;
  K. parallel/: graph_strip and graph_strip_mc on a slab extended by the
     plan's halo with a global row offset, against their plain versions;
     HaloShardedProgram on 4 slabs of cuda:0 (the flagship on the single
     tier, the demo on mc, chain3 with its edge hazard, a GLSL point
     shader reading its row, equalize and pixelate gathering, box_blur
     r300 on 8 slabs, a radius past a slab) in three formats against the
     unsharded program; PipelineStagedProgram's render_stream and a
     BatchProgram of 8 frames; ``python -m reforge_tpu_torch --shard 1``
     and ``--shard 4``; on distinct cards where there are two or more.

Paths A-D use an empty shader path, so the builtins they measure are not
replaced by the shipped shaders of the same names.  ``stencil_apply_mc``
has no caller in either package: only the kernel checks launch it.

It checks the outputs and prints the launches, all beside the card's
name and power limit; it times nothing (``perfbench/`` measures the
port's performance).  The line before the
last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without printing a result; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
    return float((a.float() - b.to(a.device).float()).abs().max())


def _tier(prog) -> str:
    return f"{prog._strip_plan[0]} tier" if prog._strip_plan else "per-node"


def _check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} above {tol}")
    print(f"check {name}: max abs error {err:.3g} <= {tol:.3g}")


def _rgba8_check(name: str, a: torch.Tensor, b: torch.Tensor, steps: int = 2,
                 flips: float = 1e-3) -> float:
    # A pre-quantization difference of one rounding flips a 1/255 bucket
    # where a value sits on its edge, and a flip can cascade through one
    # more quantized node downstream: at most two steps, on few pixels.
    # Where a stencil follows a quantized conv the flip is amplified before
    # the next store (sobel moves its magnitude by up to 2*sqrt(2) buckets
    # per flipped tap, and ACES tonemap's slope reaches 1.3): ``steps`` 4.
    # ``flips``: the share of values that may differ, where a graph puts
    # many values on a bucket's midpoint.
    d = (a.float() - b.float()).abs()
    err = float(d.max())
    frac = float((d > 1.0 / 512.0).float().mean())
    if err > steps / 255.0 + 1e-6 or frac > flips:
        raise AssertionError(f"{name}: rgba8 max {err}, flipped fraction {frac}")
    print(f"check {name}: rgba8 max abs error {err:.3g}, flipped fraction {frac:.3g}")
    return err


def _share_check(name: str, fmt: str, got: torch.Tensor, want: torch.Tensor,
                 share: float) -> float:
    # A shader whose output jumps where its input crosses a threshold (a
    # loop's trip count, a quantized code): one rounding apart in its input
    # (a conv's FMA against a multiply and an add) moves a few values by a
    # step, so at most ``share`` of the values may lie past the format's
    # bound.
    tol = {"rgba32f": 1e-5, "rgba16f": 2e-2, "rgba8": 1.0 / 255.0 + 1e-6}[fmt]
    d = (got.float() - want.to(got.device).float()).abs()
    frac = float((d > tol).float().mean())
    if frac > share:
        raise AssertionError(f"{name}: {frac} of the values past {tol} (at most {share})")
    print(f"check {name}: {frac:.3g} of the values past {tol:.3g} (at most {share:.3g}), "
          f"max abs error {float(d.max()):.3g}")
    return float(d.max())


def _check_fmt(name: str, fmt: str, got: torch.Tensor, want: torch.Tensor,
               rgba8_steps: int = 2, rgba8_flips: float = 1e-3, share: float = 0.0) -> float:
    if share:
        return _share_check(name, fmt, got, want, share)
    if fmt == "rgba8":
        return _rgba8_check(name, got, want, rgba8_steps, rgba8_flips)
    err = _max_err(got, want)
    _check(name, err, 1e-5 if fmt == "rgba32f" else 2e-2)
    return err


# Forms of the register-blocked kernels ptxas must compile with no stack
# frame and no spills: graph_strip per storage type, channel-op form and
# plan count (1..3), sep_conv_multi per input type, graph_strip_mc per
# storage type and form (builtins, affine, and the glsl forms, GLSL_FORM,
# two or four pixels a thread, without or with the trig ops, without or
# with the ops of loops, shifts, bit casts and inputs past the second,
# whose op lists' register files lie in shared memory, the wide form,
# one pixel a thread, every op, its files in device memory, and the gather
# forms, two or four pixels a thread, without the trig and extra ops or
# with both),
# conv1d per axis and form (shared memory with and
# without premultiplied box taps, or global), stencil_apply's radius-1
# form per kind (wsum, median9), stencil_reduce_mc's run form per radius
# (1..8) and tap list (full, or with a mask), and stencil_apply_mc's run
# forms per storage type, W radius (1..3), output channels (1..4) and
# table (full, or with a mask).
NO_STACK_FORMS = {"graph_strip_kernel": 12, "sep_conv_multi_kernel": 2,
                  "graph_strip_mc_kernel": 30, "conv1d_kernel": 6, "stencil_r1_kernel": 2,
                  "stencil_reduce_run_kernel": 16, "stencil_mc_run_kernel": 48}
# graph_strip_mc_kernel<T, kAffine = true, kGlsl = 2 or 4, kTrig, kExt,
# kWide = false, kGather>, and the wide form <T, true, 1, true, true, true,
# false>, mangled.
GLSL_FORM = re.compile(
    r"graph_strip_mc_kernelI\w+?Lb1ELi(?:[24]ELb[01]ELb[01]ELb0ELb[01]|1ELb1ELb1ELb1ELb0)EE")
# Its trig forms (kTrig, for op lists that call sinf, cosf or tanf; the
# wide form; the gather forms with every op) keep one stack frame: the
# three's argument reduction for |x| > 105615 (CUDA's math library)
# indexes seven words at run time.
TRIG_FORM = re.compile(r"graph_strip_mc_kernelI\w+?Lb1ELi[124]ELb1ELb[01]ELb[01]ELb[01]EE")
TRIG_STACK = "32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
NO_STACK = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"


def _check_no_stack(log: str) -> None:
    """Every form of NO_STACK_FORMS in ptxas's output: 0 bytes stack
    frame (graph_strip_mc's trig forms: TRIG_STACK), 0 bytes spill stores
    and loads; the glsl forms' registers and stack."""
    props, regs, entry = {}, {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "bytes stack frame" in line and entry is not None:
            props.setdefault(entry, line.strip())  # the entry's own, first after it
        elif "Used" in line and "registers" in line and entry is not None:
            regs.setdefault(entry, line.split("Used")[1].split(",")[0].strip())
    for kernel, forms in NO_STACK_FORMS.items():
        found = {k: v for k, v in props.items() if kernel in k}
        if len(found) != forms:
            raise AssertionError(f"ptxas: {len(found)} forms of {kernel}, expected {forms}")
        for name, line in found.items():
            if line != (TRIG_STACK if TRIG_FORM.search(name) else NO_STACK):
                raise AssertionError(f"ptxas: {name}: {line}")
        trig = " (the 14 trig forms: 32)" if kernel == "graph_strip_mc_kernel" else ""
        print(f"check ptxas: {forms} forms of {kernel}, each 0 bytes stack frame{trig}, no spills")
    glsl = {GLSL_FORM.search(k).group(0)[22:]: f"{regs[k]}, {props[k].split(',')[0]}"
            for k in props if GLSL_FORM.search(k)}
    if len(glsl) != 26:
        raise AssertionError(f"ptxas: {len(glsl)} glsl forms of graph_strip_mc_kernel")
    print(f"check ptxas: graph_strip_mc's glsl forms (f32, bf16; 2 and 4 pixels a thread; "
          f"without and with the trig ops; without and with loops, shifts, bit casts and "
          f"inputs past the second; the wide form, 1 pixel a thread; the gather forms): "
          f"{sorted(glsl.items())}")


# ---- paths F and G -------------------------------------------------------------

# A shader that stores the luma expose_meter.comp reduces, lane for lane.
LUMA_PROBE = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec3 c = imageLoad(input_image, pos).rgb;
    imageStore(output_image, pos, vec4(dot(c, vec3(0.2126, 0.7152, 0.0722))));
}
"""
# expose_meter's summed luma at 4K against a float64 sum of the same lanes:
# on the card one fixed-order segment reduction (a block's threads each add
# about 8.3M / 256 lanes in order, then a tree), whose typical error is
# sqrt(32400) * 2**-24, 1e-5 relative; held at 1e-4.
METER_SUM_RTOL = 1e-4
# Path F at 512x288, card against CPU in rgba32f: auto_expose's gain divides
# that sum (another order on each device), so 1e-4; the rest 1e-5 (exact
# counts, scope_overlay's exp by an ulp).
TOL32_F = {"auto_expose": 1e-4}


def _bump(path: str, text: str) -> None:
    """Write ``text`` and move the file's mtime on by at least 1 ms."""
    before = os.stat(path).st_mtime_ns if os.path.exists(path) else 0
    with open(path, "w") as f:
        f.write(text)
    st = os.stat(path)
    if st.st_mtime_ns <= before + 1_000_000:
        os.utime(path, ns=(st.st_atime_ns, before + 1_000_000))


def path_f(dev, u8: np.ndarray, tmp: str, smi: str) -> dict:
    """Path F: storage buffers, atomics and lut1d.  The three buffer
    examples and the lut1d graph at 4K through Engine in rgba32f and rgba16f
    (per node: buffer nodes stay off the strip tiers), two renders
    bit-identical, the one-shot equal to the frame path; the meters' raw
    outputs at 4K (histogram counts sum to the pixel count, every waveform
    column to the height, expose_meter's peak exact and its sum within
    METER_SUM_RTOL of float64), each twice, bit-identical, and the counts
    equal to the port's CPU path's; then card against CPU at 512x288.
    Returns the launch counts."""
    from reforge_tpu_torch.benchmarks import (
        BUFFER_EXAMPLES, LUT1D_CONFIG, PORT_SHADER_DIR, SHADER_DIR, build_program,
        example_config,
    )
    from reforge_tpu_torch.engine import Engine, RenderInfo
    from reforge_tpu_torch.glsl import translate_shader
    from reforge_tpu_torch.io import decode_image_to_planar
    from reforge_tpu_torch.kernels import cuda_ops
    from reforge_tpu_torch.kernels.base import KernelContext
    from reforge_tpu_torch.kernels.loader import load_kernel_file

    big = (4, HEIGHT, WIDTH)
    graphs = {g: (example_config(g), SHADER_DIR) for g in BUFFER_EXAMPLES}
    graphs["lut1d"] = (LUT1D_CONFIG, PORT_SHADER_DIR)
    cuda_ops.reset_launches()
    for graph, (text, shaders) in graphs.items():
        path = os.path.join(tmp, f"f_{graph}.rf")
        with open(path, "w") as f:
            f.write(text)
        for fmt in ("rgba32f", "rgba16f"):
            info = dict(config_path=path, shader_path=shaders, fmt=fmt, has_input_image=True)
            engine = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", **info))
            engine.load_input(u8)
            first = engine.render_frame_blocking(0.5)
            again = engine.render_frame_blocking(0.5)
            if tuple(first.shape) != big or not bool(torch.isfinite(first.float()).all()):
                raise AssertionError(f"F {graph} {fmt}: bad shape or non-finite values")
            if not torch.equal(first, again):
                raise AssertionError(f"F {graph} {fmt}: two renders differ")
            if engine.program._strip_plan is not None:
                raise AssertionError(f"F {graph} {fmt}: a strip plan for buffer nodes")
            per_node, times = engine.program.run_per_node(engine._file_input(), 0.5)
            if not torch.equal(per_node, first):
                raise AssertionError(f"F {graph} {fmt}: run_per_node differs from the frame")
            shot = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", one_shot=True, **info))
            if not np.array_equal(shot.render_one_shot(u8, 0.5), engine.read_output(first)):
                raise AssertionError(f"F {graph} {fmt}: one-shot differs from the frame path")
            engine.close()
    counts = dict(cuda_ops.LAUNCHES)

    # The meters' raw f32 outputs at 4K.
    x = decode_image_to_planar(torch.from_numpy(u8).to(dev))
    ctx = KernelContext(width=WIDTH, height=HEIGHT, time=0.5, device="cuda")
    cpu_ctx = KernelContext(width=WIDTH, height=HEIGHT, time=0.5, device="cpu")

    def run(stem, out, on=ctx, image=x):
        spec = load_kernel_file(os.path.join(SHADER_DIR, f"{stem}.comp"))
        return spec(on, {"input_image": image}, spec.resolve_params({}))[out]

    bins = [run("histogram", "Bins") for _ in range(2)]
    if not torch.equal(bins[0], bins[1]):
        raise AssertionError("F histogram at 4K: two runs differ")
    if float(bins[0].double().sum()) != WIDTH * HEIGHT:
        raise AssertionError(f"F histogram at 4K: bins sum to {float(bins[0].double().sum())}")
    if not torch.equal(bins[0].cpu(), run("histogram", "Bins", cpu_ctx, x.cpu())):
        raise AssertionError("F histogram at 4K: card and CPU counts differ")
    scope = [run("waveform", "output_image")[0] for _ in range(2)]
    if not torch.equal(scope[0], scope[1]):
        raise AssertionError("F waveform at 4K: two runs differ")
    columns = scope[0].double().sum(dim=0)
    if not bool((columns == HEIGHT).all()):
        raise AssertionError(f"F waveform at 4K: column sums {columns.min()}..{columns.max()}")
    if not torch.equal(scope[0].cpu(), run("waveform", "output_image", cpu_ctx, x.cpu())[0]):
        raise AssertionError("F waveform at 4K: card and CPU counts differ")
    stats = [run("expose_meter", "Expo") for _ in range(2)]
    if not torch.equal(stats[0], stats[1]):
        raise AssertionError("F expose_meter at 4K: two runs differ")
    probe = translate_shader(LUMA_PROBE, "luma_probe")
    luma = probe(ctx, {"input_image": x}, {})["output_image"][0]
    want_sum = float(luma.double().sum())
    rel = abs(float(stats[0][1]) - want_sum) / want_sum
    if float(stats[0][0]) != float(luma.max()) or rel > METER_SUM_RTOL:
        raise AssertionError(f"F expose_meter at 4K: peak {float(stats[0][0])} against "
                             f"{float(luma.max())}, sum off by {rel:.3g} of float64")
    cpu_stats = run("expose_meter", "Expo", cpu_ctx, x.cpu())
    cpu_rel = abs(float(cpu_stats[1]) - want_sum) / want_sum
    print(f"check F meters at 4K: histogram bins sum {WIDTH * HEIGHT}, every waveform column "
          f"{HEIGHT}, both equal to the CPU's and bit-identical in two runs; expose_meter "
          f"peak exact, summed luma {float(stats[0][1]):.1f} against float64 {want_sum:.1f}: "
          f"card {rel:.3g} relative (<= {METER_SUM_RTOL:g}), the CPU's lane order {cpu_rel:.3g}")

    # Card against the port's CPU path at 512x288.
    small = torch.from_numpy(np.random.default_rng(SEED).random((4, 288, 512), dtype=np.float32))
    for graph, (text, shaders) in graphs.items():
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            gpu = build_program(text, 512, 288, fmt, device=dev, shader_path=shaders)
            cpu = build_program(text, 512, 288, fmt, device="cpu", shader_path=shaders)
            got = gpu._forward(small.to(dev), 0.5).cpu().float()
            want = cpu._forward(small, 0.5).float()
            d = (got - want).abs()
            what = f"F {graph} {fmt} per-node 512x288 card vs CPU"
            if fmt == "rgba32f":
                _check(what, float(d.max()), TOL32_F.get(graph, 1e-5))
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
    return counts


def path_g(dev, u8: np.ndarray, tmp: str, smi: str) -> dict:
    """Path G: live reload at 4K.  A config edit swaps the program (its
    frame equal to a fresh engine's); a bad config edit and a bad shader
    edit keep the last good program while frames keep coming; the same
    with async_compile (check_build_alone, at the end of the run, shows
    its build alone puts nothing on the card); resize
    without an input image; read_output_scaled against a host box filter;
    then rounds of edits (reload_edits).  Returns the launch counts."""
    from reforge_tpu_torch import utils
    from reforge_tpu_torch.benchmarks import FLAGSHIP_CONFIG, GLSL_GRAPHS, SHADER_DIR
    from reforge_tpu_torch.engine import Engine, RenderInfo
    from reforge_tpu_torch.kernels import cuda_ops

    gdir = os.path.join(tmp, "g")
    shaders = os.path.join(gdir, "shaders")
    os.makedirs(shaders)
    for stem in ("gaussian_h", "gaussian_v"):
        shutil.copy(os.path.join(SHADER_DIR, f"{stem}.comp"), shaders)
    blur_src = Path(shaders, "gaussian_h.comp").read_text()
    flagship = os.path.join(gdir, "flagship.rf")
    blur = os.path.join(gdir, "glsl_blur.rf")
    edited = FLAGSHIP_CONFIG.replace("sigma: 4.0", "sigma: 3.0")
    cuda_ops.reset_launches()

    def engine(path, text, shader_path=shaders, **kw):
        with open(path, "w") as f:
            f.write(text)
        eng = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", config_path=path, shader_path=shader_path,
                                has_input_image=True, **kw))
        eng.load_input(u8)
        return eng

    def fresh(text):
        path = os.path.join(gdir, "fresh.rf")
        eng = engine(path, text)
        out = eng.render_frame_blocking(0.5)
        eng.close()
        return out

    def same(eng, before, what):
        for _ in range(3):
            if not torch.equal(eng.render_frame_blocking(0.5), before):
                raise AssertionError(f"G {what}: the last good program's frame changed")

    for async_compile in (False, True):
        mode = "async" if async_compile else "inline"
        eng = engine(flagship, FLAGSHIP_CONFIG, async_compile=async_compile)
        old = eng.render_frame_blocking(0.5)
        _bump(flagship, edited)
        frames = 0
        swapped = eng.trigger_reloads()
        while not swapped:
            eng.render_frame_blocking(0.5)  # the old program keeps rendering
            frames += 1
            swapped = eng.trigger_reloads()
            if frames > 10_000:
                raise AssertionError(f"G {mode}: the config edit was never adopted")
        new = eng.render_frame_blocking(0.5)
        edit_cache = (eng.program.from_cache, eng.program.nodes_checked)
        if torch.equal(new, old) or not torch.equal(new, fresh(edited)):
            raise AssertionError(f"G {mode}: the config edit did not swap in its program")
        utils.clear_warnings()
        _bump(flagship, edited + "\n@@@ broken\n")
        if eng.trigger_reloads():
            raise AssertionError(f"G {mode}: a bad config edit swapped")
        eng.wait_for_compiles()
        same(eng, new, f"{mode} bad config edit")
        if not any("Invalid token" in w for w in utils.recent_warnings()):
            raise AssertionError(f"G {mode}: no diagnostic for the bad config edit")
        eng.close()
        eng = engine(blur, GLSL_GRAPHS["glsl_blur"], async_compile=async_compile)
        good = eng.render_frame_blocking(0.5)
        _bump(os.path.join(shaders, "gaussian_h.comp"), "void main() { !!! }\n")
        if eng.trigger_reloads():
            raise AssertionError(f"G {mode}: a bad shader edit swapped")
        eng.wait_for_compiles()
        same(eng, good, f"{mode} bad shader edit")
        _bump(os.path.join(shaders, "gaussian_h.comp"), blur_src)
        eng.trigger_reloads()
        eng.wait_for_compiles()
        if not torch.equal(eng.render_frame_blocking(0.5), good):
            raise AssertionError(f"G {mode}: the restored shader renders another frame")
        if not eng.program.from_cache:
            raise AssertionError(f"G {mode}: the restored shader missed the program cache")
        eng.close()
        print(f"check G {mode} 4K: config edit swapped ({frames} old frames while it built; "
              f"program cache hit, nodes shape-checked: {edit_cache}), bad config and bad "
              f"shader edits kept the last good program, the restored shader hit the program "
              f"cache [{smi}]")

    # resize (no input image) and the preview downscale.
    gen = os.path.join(gdir, "checker.rf")
    with open(gen, "w") as f:
        f.write("checkerboard -> output\n")
    for async_compile in (False, True):
        eng = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", config_path=gen, shader_path=shaders,
                                async_compile=async_compile))
        eng.resize(1920, 1080)
        eng.wait_for_compiles()
        out = eng.render_frame_blocking(0.5)
        if tuple(out.shape) != (4, 1080, 1920) or (eng.info.width, eng.info.height) != (1920, 1080):
            raise AssertionError(f"G resize: {tuple(out.shape)}")
        eng.close()
    eng = engine(flagship, FLAGSHIP_CONFIG)
    out = eng.render_frame_blocking(0.5)
    small = eng.read_output_scaled(out, 960)
    cells = out.double().cpu().reshape(4, 540, 4, 960, 4).mean(dim=(2, 4)).float()
    codes = int(np.abs(small.astype(np.int16) - eng.read_output(cells).astype(np.int16)).max())
    if small.shape != (540, 960, 4) or codes > 1:
        raise AssertionError(f"G read_output_scaled: {small.shape}, {codes} codes off")
    eng.close()
    print(f"check G resize 4K -> 1920x1080 inline and async; read_output_scaled 960 px: "
          f"(540, 960, 4), {codes} codes from a float64 host box filter [{smi}]")
    reload_edits()
    return dict(cuda_ops.LAUNCHES)


def reload_edits() -> None:
    """Path G's edits with async_compile at 4K, for a flagship parameter,
    glsl-blur's gaussian_h.comp source, glsl-chain's tonemap.comp source
    (an op-list point stage) and the auto_expose graph; 8 cold edits and
    the same 8 again warm, which must hit the program cache."""
    from reforge_tpu_torch.benchmarks import (
        FLAGSHIP_CONFIG, GLSL_GRAPHS, SHADER_DIR, example_config,
    )
    from reforge_tpu_torch.engine import Engine, RenderInfo

    u8 = np.random.default_rng(SEED).integers(0, 256, size=(HEIGHT, WIDTH, 4), dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="rf_chip_smoke_reload_") as tmp:
        shaders, empty = os.path.join(tmp, "shaders"), os.path.join(tmp, "empty")
        os.makedirs(shaders)
        os.makedirs(empty)
        for stem in ("gaussian_h", "gaussian_v", "tonemap"):
            shutil.copy(os.path.join(SHADER_DIR, f"{stem}.comp"), shaders)
        blur_src = Path(shaders, "gaussian_h.comp").read_text()
        tonemap_src = Path(shaders, "tonemap.comp").read_text()
        expose_text = example_config("auto_expose")
        flagship, blur, chain, expose = (os.path.join(tmp, f"{n}.rf") for n in (
            "flagship", "glsl_blur", "glsl_chain", "auto_expose"))
        edits = {
            "flagship sigma": (flagship, FLAGSHIP_CONFIG, empty, flagship,
                               [FLAGSHIP_CONFIG.replace("sigma: 4.0", f"sigma: {3.0 + 0.25 * k}")
                                for k in range(8)]),
            "glsl-blur gaussian_h.comp": (blur, GLSL_GRAPHS["glsl_blur"], shaders,
                                          os.path.join(shaders, "gaussian_h.comp"),
                                          [blur_src + f"\n// edit {k}\n" for k in range(8)]),
            # a point shader: each cold edit lowers a new op list
            "glsl-chain tonemap.comp": (chain, GLSL_GRAPHS["glsl_chain"], shaders,
                                        os.path.join(shaders, "tonemap.comp"),
                                        [tonemap_src + f"\n// edit {k}\n" for k in range(8)]),
            "auto_expose graph": (expose, expose_text, SHADER_DIR, expose,
                                  [expose_text.replace("target: 0.95",
                                                       f"target: {0.90 + 0.01 * k:.2f}")
                                   for k in range(8)]),
        }
        for name, (cfg, text, shader_path, target, texts) in edits.items():
            with open(cfg, "w") as f:
                f.write(text)
            eng = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", config_path=cfg,
                                    shader_path=shader_path, has_input_image=True,
                                    async_compile=True))
            eng.load_input(u8)
            eng.render_frame_blocking(0.5)
            cache = {"cold": [], "warm": []}  # (program cache hit, nodes shape-checked)
            for phase in ("cold", "warm"):
                for t in texts:
                    _bump(target, t)
                    t0 = time.perf_counter()
                    swapped = eng.trigger_reloads()
                    while not swapped:
                        if time.perf_counter() - t0 > 120.0:
                            raise AssertionError(f"G {name}: an edit was never adopted")
                        time.sleep(0.0005)
                        swapped = eng.trigger_reloads()
                    eng.render_frame_blocking(0.5)
                    cache[phase].append((eng.program.from_cache, eng.program.nodes_checked))
            eng.close()
            for phase, seen in cache.items():
                print(f"reload {name} {phase}: program cache hits {sum(h for h, _ in seen)} of "
                      f"{len(seen)}; nodes shape-checked per edit {[n for _, n in seen]}",
                      flush=True)
            # Every warm edit revisits a text of the cold round.
            if not all(hit for hit, _ in cache["warm"]):
                raise AssertionError(f"G {name}: a warm edit missed the program cache")


def check_build_alone(u8: np.ndarray, tmp: str, smi: str) -> None:
    """Path G's last check, run after every other path (a
    profiler session can change what later ones see): an async_compile
    build with no frame shows no device event under torch.profiler, and
    a frame after it does."""
    from torch.profiler import ProfilerActivity, profile

    from reforge_tpu_torch.benchmarks import FLAGSHIP_CONFIG
    from reforge_tpu_torch.engine import Engine, RenderInfo

    path = os.path.join(tmp, "g", "build_alone.rf")
    with open(path, "w") as f:
        f.write(FLAGSHIP_CONFIG)
    eng = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", config_path=path,
                            shader_path=os.path.join(tmp, "g", "shaders"), has_input_image=True,
                            async_compile=True))
    eng.load_input(u8)
    eng.render_frame_blocking(0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _bump(path, FLAGSHIP_CONFIG.replace("sigma: 4.0", "sigma: 3.0"))
        eng.trigger_reloads()
        for th in list(eng._build_threads):
            th.join()
        torch.cuda.synchronize()
    device_events = [e.key for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    if device_events:
        raise AssertionError(f"G: the build thread put work on the card: {device_events}")
    if not eng.trigger_reloads():
        raise AssertionError("G: the async build was not adopted")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the control: a frame
        eng.render_frame_blocking(0.5)
    frame_events = [e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
    if not frame_events:
        raise AssertionError("G: the profiler saw no device work in a frame either")
    eng.close()
    print(f"check G async build alone: no device event (a frame after it: "
          f"{len(frame_events)} kinds of device event) [{smi}]")


def _cli(argv: list, stdout=None) -> str:
    """``cli.main(argv)`` with its standard error captured (and its
    standard output sent to ``stdout`` when given): its stderr.
    Fails on a non-zero return."""
    import contextlib
    import io as _io

    from reforge_tpu_torch import cli

    err = _io.StringIO()
    out = stdout if stdout is not None else _io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"H: cli.main({argv}) returned {rc}:\n{err.getvalue()[-2000:]}")
    return err.getvalue()


def _read_png(path: str) -> np.ndarray:
    from reforge_tpu_torch.io.png import decode_png

    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def path_h(tmp: str, smi: str) -> dict:
    """Path H: the command line on the card, through ``cli.main`` with no
    ``--backend`` (the CLI picks the card) and an empty shader path (the
    builtins, as paths A-D).  (1) A seeded 3840x2160 RGBA PNG written by
    the port's encoder, rendered headless with the flagship in rgba32f and
    rgba16f (one-shot per node: the conv bundle through
    sep_conv_fused_multi, sep_conv_fused_mxu in rgba16f), the file equal
    bit for bit to ``render_one_shot`` of the same pixels.  (2) A
    1920x1080 input with ``--width 3840``:
    a 3840x2160 output through the Lanczos resize.  (3) At 512x288 the
    card's file within one code of ``--backend cpu``'s, flagship and demo.
    (4) The live loop on the demo at 4K, 120 frames with no preview
    (graph_strip_mc once a frame), then 10 with the kitty preview (its
    payload from read_output_scaled).  (5) Batch over a directory of four
    1920x1080 PNGs (the strip tier: graph_strip), each output equal to
    ``read_output(program(x, 0))`` and within one code of the one-shot
    CLI.  (6) With the libav extension, an animated export and a
    transcode of it.  (7) ``python -m reforge_tpu_torch --profile`` in a
    child process writes a Chrome trace holding device events.  Returns
    the launch counts of (1)-(6)."""
    import contextlib

    from reforge_tpu_torch.benchmarks import DEMO_CONFIG, FLAGSHIP_CONFIG
    from reforge_tpu_torch.engine import Engine, RenderInfo
    from reforge_tpu_torch.io import (
        ImageFileDecoder, VideoFrames, encode, native_backend_available, native_backend_reason,
    )
    from reforge_tpu_torch.io.png import HEADER_BYTES, read_header
    from reforge_tpu_torch.kernels import cuda_ops

    hdir = os.path.join(tmp, "h")
    empty = os.path.join(hdir, "empty")
    os.makedirs(empty)
    configs = {}
    for name, text in (("flagship", FLAGSHIP_CONFIG), ("demo", DEMO_CONFIG)):
        configs[name] = os.path.join(hdir, f"{name}.rf")
        with open(configs[name], "w") as f:
            f.write(text)
    rng = np.random.default_rng(SEED + 11)

    def write_png(name, h, w):
        u8 = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
        path = os.path.join(hdir, name)
        encode(path, u8)
        return path, u8

    def args(graph, inp, *rest):
        return ["-i", inp, "--config", configs[graph], "--shader-path", empty, *rest]

    total = {k: 0 for k in cuda_ops.LAUNCHES}

    def take(what, launched_at_least=(), exactly=None):
        """Read and reset the launch counts of a step; fail unless each
        kernel of ``launched_at_least`` launched and each of ``exactly``
        launched that many times."""
        counts = dict(cuda_ops.LAUNCHES)
        cuda_ops.reset_launches()
        for k, v in counts.items():
            total[k] += v
        launched = {k: v for k, v in counts.items() if v}
        bad = [k for k in launched_at_least if counts[k] == 0]
        bad += [k for k, n in (exactly or {}).items() if counts[k] != n]
        if bad:
            raise AssertionError(f"H {what}: launches {launched}; expected "
                                 f"{list(launched_at_least)} launched, {exactly or {}} exactly")
        print(f"H {what} launches: {json.dumps(launched)}")

    # (1) headless flagship at 4K.
    in4k, u8_4k = write_png("in_4k.png", HEIGHT, WIDTH)
    if not np.array_equal(ImageFileDecoder(in4k).decode(WIDTH, HEIGHT), u8_4k):
        raise AssertionError("H: the 4K PNG does not decode to its pixels")
    cuda_ops.reset_launches()
    for fmt, entry in (("rgba32f", "sep_conv_fused_multi"), ("rgba16f", "sep_conv_fused_mxu")):
        out = os.path.join(hdir, f"out_4k_{fmt}.png")
        _cli(args("flagship", in4k, "-o", out, "--shader-format", fmt))
        take(f"(1) one-shot flagship {fmt} 4K", [entry])
        got = _read_png(out)
        engine = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", config_path=configs["flagship"],
                                   shader_path=empty, fmt=fmt, has_input_image=True,
                                   one_shot=True))
        want = engine.render_one_shot(u8_4k, 0.0)
        engine.close()
        cuda_ops.reset_launches()
        if not np.array_equal(got, want):
            raise AssertionError(f"H (1) flagship {fmt}: the CLI's file differs from "
                                 f"render_one_shot ({int((got != want).sum())} values)")

    # (2) resize: 1920x1080 in, --width 3840.
    in1080, _ = write_png("in_1080.png", 1080, 1920)
    out = os.path.join(hdir, "out_resized.png")
    _cli(args("flagship", in1080, "-o", out, "--width", "3840"))
    take("(2) one-shot flagship with --width 3840", ["sep_conv_fused_multi"])
    with open(out, "rb") as f:
        head = read_header(f.read(HEADER_BYTES), out)
    if (head.width, head.height) != (WIDTH, HEIGHT):
        raise AssertionError(f"H (2): output {head.width}x{head.height}, expected 3840x2160")

    # (3) card against CPU at 512x288, rgba32f.
    in_small, _ = write_png("in_512.png", 288, 512)
    for graph in ("flagship", "demo"):
        card, cpu = (os.path.join(hdir, f"{graph}_{d}.png") for d in ("card", "cpu"))
        _cli(args(graph, in_small, "-o", card))
        _cli(args(graph, in_small, "-o", cpu, "--backend", "cpu"))
        d = np.abs(_read_png(card).astype(np.int16) - _read_png(cpu).astype(np.int16))
        _check(f"H (3) {graph} rgba32f 512x288 CLI card vs --backend cpu (u8 codes)",
               float(d.max()), 1.0)
    take("(3) 512x288 on the card")

    # (4) the live loop on the demo at 4K.
    frames = 120
    err = _cli(args("demo", in4k, "--preview", "none", "--frames", str(frames)))
    take(f"(4) live loop demo 4K, {frames} frames", exactly={"graph_strip_mc": frames})
    frame_ms = [float(v) for v in re.findall(r"Frame:\s*([0-9.]+)ms", err)]
    if len(frame_ms) != frames:
        raise AssertionError(f"H (4): {len(frame_ms)} status lines for {frames} frames")
    kitty = os.path.join(hdir, "kitty.out")
    with open(kitty, "w") as f:
        _cli(args("demo", in4k, "--preview", "kitty", "--frames", "10"), stdout=f)
    take("(4) live loop demo 4K, kitty preview, 10 frames", exactly={"graph_strip_mc": 10})
    payload = Path(kitty).read_text()
    shown = re.findall(r"\x1b_Ga=T,f=32,s=(\d+),v=(\d+),o=z", payload)
    if len(shown) != 10 or set(shown) != {("960", "540")}:
        raise AssertionError(f"H (4) kitty: {len(shown)} images of sizes {set(shown)}")

    # (5) batch over a directory of four 1920x1080 PNGs.
    bdir, bout = os.path.join(hdir, "batch"), os.path.join(hdir, "batch_out")
    os.makedirs(bdir)
    batch = []
    for i in range(4):
        batch.append(write_png(f"batch/f{i}.png", 1080, 1920)[1])
    _cli(args("flagship", bdir, "-o", bout))
    take("(5) batch flagship 4 x 1920x1080", exactly={"graph_strip": 4})
    engine = Engine(RenderInfo(1920, 1080, "cuda", config_path=configs["flagship"],
                               shader_path=empty, has_input_image=True))
    for i, u8 in enumerate(batch):
        want = engine.read_output(engine.program(engine.decode_to_planar(u8), 0.0))
        got = _read_png(os.path.join(bout, f"f{i}.png"))
        if not np.array_equal(got, want):
            raise AssertionError(f"H (5) batch f{i}: differs from read_output(program(x, 0))")
    engine.close()
    single = os.path.join(hdir, "single_f2.png")
    _cli(args("flagship", os.path.join(bdir, "f2.png"), "-o", single))
    d = np.abs(_read_png(single).astype(np.int16)
               - _read_png(os.path.join(bout, "f2.png")).astype(np.int16))
    _check("H (5) batch f2 (strip tier) vs the one-shot CLI (per node), u8 codes",
           float(d.max()), 1.0)
    cuda_ops.reset_launches()  # the checks' own launches

    # (6) video, where the libav extension builds.
    if native_backend_available():
        anim, trans = os.path.join(hdir, "anim.mp4"), os.path.join(hdir, "trans.mp4")
        _cli(args("flagship", in1080, "-o", anim, "--duration", "1", "--fps", "24"))
        take("(6) animated export flagship 1920x1080, 24 frames", exactly={"graph_strip": 24})
        n = sum(1 for _ in VideoFrames(ImageFileDecoder(anim), 1920, 1080))
        if n != 24:
            raise AssertionError(f"H (6): the animated export holds {n} frames, not 24")
        _cli(args("flagship", anim, "-o", trans))
        take("(6) transcode of it", exactly={"graph_strip": 24})
        n = sum(1 for _ in VideoFrames(ImageFileDecoder(trans), 1920, 1080))
        if n != 24:
            raise AssertionError(f"H (6): the transcode holds {n} frames, not 24")
    else:
        print(f"H (6) video: not run, the libav extension is not built on this machine: "
              f"{native_backend_reason()}")

    # (7) --profile, from `python -m reforge_tpu_torch` in a child process:
    # a profiler session in this one changes what later sessions see.
    trace_dir = os.path.join(hdir, "trace")
    out = os.path.join(hdir, "profiled.png")
    subprocess.run([sys.executable, "-m", "reforge_tpu_torch",
                    *args("flagship", in_small, "-o", out, "--profile", trace_dir)],
                   check=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)),
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    traces = sorted(Path(trace_dir).glob("*.json"))
    if len(traces) != 1:
        raise AssertionError(f"H (7): {len(traces)} trace files in {trace_dir}")
    events = json.loads(traces[0].read_text()).get("traceEvents", [])
    kernels = sorted({e.get("name", "")[:40] for e in events if e.get("cat") == "kernel"})
    if not kernels:
        raise AssertionError("H (7): the trace holds no device (kernel) events")
    print(f"H (7) python -m reforge_tpu_torch --profile: {traces[0].name}, {len(events)} events, "
          f"{len(kernels)} device kernels, e.g. {kernels[:3]} [{smi}]")
    return total


# ---- path I ----------------------------------------------------------------------

# Path I's .py kernel, at the head of PY_GRAPH: the user's torch code, on
# the card through the per-node tier.
PY_KERNEL = """import torch

from reforge_tpu_torch.kernels import kernel


@kernel("dbl", register=False)
def dbl(ctx, input_image, *, gain=0.8):
    return input_image * gain + 0.05
"""
PY_GRAPH = ("input -> dbl -> gs -> edge -> tone -> output\n"
            "gs: gaussian { sigma: 2 }\nedge: sobel {}\ntone: tonemap {}\n")
PY_STEPS = [("node", ["dbl"]), ("seg mc", ["gs", "edge", "tone"])]


def path_i(u8: np.ndarray, tmp: str, smi: str) -> dict:
    """Path I: the segments tier and a .py kernel at 4K.  Prints the plan of
    every shipped example and benchmark graph at 4K and takes each that
    plans segments, plus PY_GRAPH (dbl.py written to a directory of its
    own, with the builtins beside it); drives each through Engine in
    rgba32f and rgba16f: a frame and a sequence of 4 on segments against
    per node (the same program's ``_forward_layers``), the launches of a
    frame by kernel (one strip kernel for each segment); a .py kernel in
    single-shader mode through ``cli.main`` against ``--backend cpu``.
    Returns the launch counts."""
    from reforge_tpu_torch.benchmarks import (
        CHAIN3_CONFIG, DEMO_CONFIG, EDGES_CONFIG, FLAGSHIP_CONFIG, GLSL_GRAPHS, LIBRARY_GRAPHS,
        SHADER_DIR, STYLIZED_GRAPHS, build_program, example_config, plan_steps,
    )
    from reforge_tpu_torch.engine import Engine, RenderInfo
    from reforge_tpu_torch.io import encode
    from reforge_tpu_torch.kernels import cuda_ops

    idir = os.path.join(tmp, "i")
    empty, pydir = os.path.join(idir, "empty"), os.path.join(idir, "py")
    os.makedirs(empty)
    os.makedirs(pydir)
    with open(os.path.join(pydir, "dbl.py"), "w") as f:
        f.write(PY_KERNEL)
    # Builtin graphs with no shader path (as paths A-D run them), the GLSL
    # graphs and every example with the shipped shaders.
    candidates = {name: (text, empty) for name, text in (
        ("flagship", FLAGSHIP_CONFIG), ("demo", DEMO_CONFIG), ("edges", EDGES_CONFIG),
        ("chain3", CHAIN3_CONFIG), *STYLIZED_GRAPHS.items(), *LIBRARY_GRAPHS.items())}
    candidates.update({name: (text, SHADER_DIR) for name, text in GLSL_GRAPHS.items()})
    for rf in sorted(Path("examples").glob("*.rf")):
        candidates[f"examples/{rf.name}"] = (example_config(rf.stem), SHADER_DIR)
    graphs = {}
    for name, (text, shader_path) in candidates.items():
        for fmt in ("rgba32f", "rgba16f"):
            prog = build_program(text, WIDTH, HEIGHT, fmt, device="cuda", shader_path=shader_path)
            print(f"I plan {name} {fmt} 4K: {plan_steps(prog)}")
            if prog._strip_plan is not None and prog._strip_plan[0] == "segments":
                graphs[name] = (text, shader_path)
    graphs["py_graph"] = (PY_GRAPH, pydir)
    print(f"I segment graphs (from the planner) and the .py graph: {sorted(graphs)}")

    cuda_ops.reset_launches()
    for name, (text, shader_path) in graphs.items():
        for fmt in ("rgba32f", "rgba16f"):
            cfg = os.path.join(idir, f"{name.replace('/', '_')}_{fmt}.rf")
            with open(cfg, "w") as f:
                f.write(text)
            engine = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", config_path=cfg,
                                       shader_path=shader_path, fmt=fmt, has_input_image=True))
            engine.load_input(u8)
            prog, x = engine.program, engine._file_input()
            steps = plan_steps(prog)
            if prog._strip_plan is None or prog._strip_plan[0] != "segments":
                raise AssertionError(f"I {name} {fmt}: plan {steps}, not segments")
            if name == "py_graph" and steps != PY_STEPS:
                raise AssertionError(f"I {name} {fmt}: plan {steps}, expected {PY_STEPS}")
            before = dict(cuda_ops.LAUNCHES)
            frame = engine.render_frame_blocking(0.5)
            per_frame = {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items() if v != before[k]}
            want = {}
            for step in prog._strip_plan[1]:
                if step[0] == "seg":
                    k = "graph_strip_mc" if step[1]._strip_plan[0] == "mc" else "graph_strip"
                    want[k] = want.get(k, 0) + 1
            if any(per_frame.get(k, 0) != n for k, n in want.items()):
                raise AssertionError(f"I {name} {fmt}: launches {per_frame}, expected {want} "
                                     "strip kernels (one a segment)")
            seq = prog.render_sequence(x, 0.5, 0.016, 4, stack=True)
            per_node = prog._forward_nostrip(x, 0.5)
            for what, v in (("frame", frame), ("per node", per_node)):
                if tuple(v.shape) != (4, HEIGHT, WIDTH) or not bool(torch.isfinite(v).all()):
                    raise AssertionError(f"I {name} {fmt} {what}: bad shape or non-finite values")
            _check(f"I {name} {fmt} render_sequence frame 0 vs render_frame",
                   _max_err(seq[0], frame), 0.0)
            _check(f"I {name} {fmt} segments vs per node 4K", _max_err(frame, per_node),
                   1e-5 if fmt == "rgba32f" else 2e-2)
            print(f"I {name} {fmt} 4K: steps {steps}; launches a frame {json.dumps(per_frame)} "
                  f"[{smi}]")
            engine.close()
            del frame, seq, per_node
    counts = dict(cuda_ops.LAUNCHES)

    # Single-shader mode with the .py file through the command line, on the
    # card against --backend cpu (512x288, one code).
    png = os.path.join(idir, "in.png")
    outs = [os.path.join(idir, f"dbl_{b}.png") for b in ("card", "cpu")]
    small = np.random.default_rng(SEED + 9).integers(0, 256, size=(288, 512, 4), dtype=np.uint8)
    small[..., 3] = 255
    encode(png, small)
    dbl = os.path.join(pydir, "dbl.py")
    _cli([dbl, "-i", png, "-o", outs[0]])
    _cli([dbl, "-i", png, "-o", outs[1], "--backend", "cpu"])
    card, cpu = (_read_png(path).astype(np.int16) for path in outs)
    codes = int(np.abs(card - cpu).max())
    _check("I dbl.py single-shader mode, cli.main on the card vs --backend cpu 512x288 (u8 codes)",
           codes, 1.0)
    return counts


# ---- path J ---------------------------------------------------------------------

# Every kind of op of the GLSL point stage's op list (glsl/lower.py): the
# frame time, uint arithmetic that wraps, int division and remainder,
# casts, a per-pixel branch, a counted loop, transcendentals, comparisons
# and selects (tests/test_torch_glsl_mc.py holds it bit-equal to the
# interpreter on the CPU).  Before a builtin gaussian, so that the graph
# plans the mc tier and the probe reads the input itself.
OP_PROBE = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
layout (binding = 2) uniform UBO { float gain; int levels; float _rf_time; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 c = imageLoad(input_image, pos);
    uint h = uint(pos.x) * 2654435761u + uint(pos.y) * 40503u;
    float noise = float(h % 1024u) / 1023.0;
    int q = pos.x / 3 - pos.y % 5 - 7;
    float t = fract(_rf_time * 0.37 + float(q) * 0.01);
    vec3 v = c.rgb * gain;
    if (c.r > 0.5) {
        v = sqrt(v) + vec3(sin(t), cos(t), exp2(-t));
    } else {
        v = pow(v, vec3(2.2)) * abs(sign(c.g - 0.5)) + atan(c.b, 0.5 - t);
    }
    for (int i = 0; i < 3; i++) {
        v += 0.01 * float(i) * v;
    }
    float m = mod(float(pos.x) + _rf_time, 7.0);
    v = clamp(mix(v, vec3(noise), 0.1), 0.0, 1.0) + step(3.5, m) * 0.05;
    float lv = floor(v.r * float(levels)) / float(levels);
    bool edge = pos.x == 0 || pos.y == size.y - 1;
    int iq = int(lv * 255.0) / -2;
    imageStore(output_image, pos,
               vec4(edge ? 1.0 : lv, log(1.0 + v.g) + float(iq) * 1e-3,
                    max(v.b, min(t, 0.5)), c.a * inversesqrt(1.0 + c.a)));
}
"""
OP_PROBE_GRAPH = ("input -> probe -> gs -> output\nprobe: probe { gain: 1.3, levels: 7 }\n"
                  "gs: gaussian { sigma: 2.0 }\n")
# The four bit casts on a raw image of special values (NaN payloads, both
# infinities, denormals, -0.0), a point stage after a blur (the blur its
# first input): each output channel a function of the raw bits alone, so
# that the kernel's output is bit for bit its plain version's.
BITCAST_PROBE = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform readonly image2D raw_image;
layout (binding = 2, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 r = imageLoad(raw_image, pos);
    int bi = floatBitsToInt(r.r);
    uint bu = floatBitsToUint(r.g);
    imageStore(output_image, pos,
               vec4(intBitsToFloat(bi), uintBitsToFloat(bu ^ 0x80000000u),
                    float(bi >> 20) / 2048.0 + float(bu & 255u), bi < 0 ? 1.0 : 0.0));
}
"""
BITCAST_GRAPH = ("input -> gs -> bitcast -> output\ninput -> bitcast:raw_image\n"
                 "gs: gaussian { sigma: 2.0 }\n")
BITCAST_SPECIALS = (0x7FC01234, 0xFFC00001, 0x7F800001, 0x7F800000, 0xFF800000, 0x00000001,
                    0x807FFFFF, 0x80000000, 0x3F800000, 0xBF000000)


def _bitcast_input(seed: int) -> torch.Tensor:
    """A 4K f32 frame with BITCAST_SPECIALS planted in its red and green
    channels (one pixel in three of every seventh row, one in two of every
    fifth)."""
    x = np.random.default_rng(seed).random((4, HEIGHT, WIDTH), dtype=np.float32)
    specials = np.array(BITCAST_SPECIALS, np.uint32).view(np.float32)
    x[0, ::7, ::3] = np.resize(specials, x[0, ::7, ::3].shape)
    x[1, ::5, ::2] = np.resize(specials[::-1], x[1, ::5, ::2].shape)
    return torch.from_numpy(x)


def _shader_first(config: str) -> str:
    """``input -> blur -> shader -> output`` as ``input -> shader -> blur
    -> output``: the loop graphs' shader reading the input, before the
    blur, so that a kernel check holds its op list on the input itself."""
    lines = config.splitlines()
    blur, shader = lines[0].split(" -> ")[1:3]
    return "\n".join([f"input -> {shader} -> {blur} -> output"] + lines[1:]) + "\n"


def _unruled_mc(prog):
    """The mc plan of ``prog``'s graph with the tier rule's bound on halo
    work lifted (the plan the rule refuses), planned apart from the
    program caches; None where the mc tier has no plan."""
    from reforge_tpu_torch.graph import program as program_module

    saved = program_module.MC_MAX_HALO_WORK
    program_module.MC_MAX_HALO_WORK = float("inf")
    try:
        return prog._plan_strip_mc()
    finally:
        program_module.MC_MAX_HALO_WORK = saved


def _mc_plan_text(prog, cuda_ops) -> str:
    """The mc plan's mode, tile and stages (kind, opcode; a GLSL stage's
    op, register and constant counts), or a segment child's, or the plan
    the tier rule refused."""
    plan = prog._strip_plan
    if plan is None:
        mc = _unruled_mc(prog)
        if mc is None:
            return "no strip plan"
        return f"per node; the mc plan the tier rule refuses: {_mc_text(mc, cuda_ops)}"
    if plan[0] == "segments":
        return "; ".join(_mc_plan_text(step[1], cuda_ops) for step in plan[1] if step[0] == "seg")
    if plan[0] != "mc":
        return plan[0]
    return _mc_text(plan[1], cuda_ops)


def _mc_text(mc, cuda_ops) -> str:
    from reforge_tpu_torch.glsl import lower

    names = {cuda_ops.MC_CONV: "conv", cuda_ops.MC_STENCIL: "stencil", cuda_ops.MC_POINT: "point"}
    stages = []
    for st in mc.stages:
        text = f"{names[st.kind]} {st.op.code}"
        if st.op.code == cuda_ops.MC_GLSL:
            words = st.taps[0]
            text += (f" (GLSL: {int(words[0])} ops, {int(words[1])} float and {int(words[2])} "
                     f"integer registers, {int(words[3]) + int(words[4])} constants, "
                     f"{lower.packed_work(words)} ops a pixel at the loops' trip bounds, "
                     f"{len(st.ins)} inputs, {'wide' if lower.is_wide(words) else 'narrow'} "
                     f"op word)")
        stages.append(text)
    work, halo = mc.halo_work()
    th, tw = mc.tile()[:2]
    files = ""
    if any(st.op.code == cuda_ops.MC_GLSL for st in mc.stages):
        files = (f"{int(mc.geometry(th, tw)[8])} pixels a thread, files in "
                 f"{'device' if mc._wide else 'shared'} memory, ")
    return (f"mode {mc.mode}, tile {(th, tw)}, {files}estimated work a pixel {work:.1f}, halo "
            f"{halo:.1f} ({halo / len(mc.stages):.1f} a stage), stages [{', '.join(stages)}]")


def _mc_of(prog):
    """The mc plan of a program, or of its first segment child, or the one
    the tier rule refused."""
    plan = prog._strip_plan
    if plan is None:
        return _unruled_mc(prog)
    if plan[0] == "segments":
        plan = next(step[1] for step in plan[1] if step[0] == "seg")._strip_plan
    return plan[1]


def path_j(u8: np.ndarray, tmp: str, smi: str) -> dict:
    """Path J: GLSL point shaders (op-list stages, MC_GLSL) and zero-border
    GLSL convs on the mc tier at 4K, the loop and shift graphs among them
    (benchmarks.LOOP_GRAPHS: op lists with loop regions and shift ops).
    Kernel checks first (not counted): the plan of each graph of
    point_graphs(), of OP_PROBE_GRAPH and of iterate.comp and bits.comp
    before their blur (``_shader_first``) in rgba32f,
    rgba16f and rgba8, and graph_strip_mc against its plain version on
    the card.  Then, counted, each graph of point_graphs() through
    Engine in the three formats: one frame on its tier against the same
    program per node, a sequence of 4, the launches of a frame.  Returns
    the launch counts (the op-count sweep's kernels are checked first,
    with the others)."""
    from reforge_tpu_torch.benchmarks import (
        DEMO_CONFIG, LIBRARY_GRAPHS, build_program, plan_steps, point_graphs,
    )
    from reforge_tpu_torch.engine import Engine, RenderInfo
    from reforge_tpu_torch.kernels import cuda_ops

    jdir = os.path.join(tmp, "j")
    probe_dir = os.path.join(jdir, "probe")
    os.makedirs(probe_dir)
    with open(os.path.join(probe_dir, "probe.comp"), "w") as f:
        f.write(OP_PROBE)
    big = (4, HEIGHT, WIDTH)
    x = torch.from_numpy(np.random.default_rng(SEED + 13).random(big, dtype=np.float32)).cuda()
    # rgba8 codes a flip may move: sharpen.comp at 0.7 amplifies one by up to
    # 1 + 8 * 0.7; ACES tonemap's slope reaches 1.3.
    steps8 = {"glsl_sharpen": 7, "tonemap_sharpen": 7, "blur_sharpen_blend": 7, "bloom_glow": 4,
              "glsl_chain": 4}
    # tonemap.comp's output, stored on the rgba8 grid, feeds sharpen.comp
    # at 0.7: 255 * (c + 0.7 * (4c - n - s - w - e)) is then a multiple of
    # 0.1 codes, on a bucket's midpoint wherever the Laplacian is 5 codes
    # mod 10, and there per node (the interpreter's order) and the mc
    # stencil (a tap-sum) round apart by one code.
    flips8 = {"tonemap_sharpen": 1e-2}
    # iterate.comp's trip counts and bits.comp's codes jump where their
    # blurred input crosses a threshold: the share of values a rounding of
    # the conv may move.
    shares = {"iterate_after_blur": 1e-3, "bits_after_blur": 1e-3}
    first = {}  # mandelbrot.comp ignores its input: its checks hold bit for bit after the blur
    for name in ("iterate_after_blur", "bits_after_blur"):
        config, shader_dir = point_graphs()[name]
        first[f"{name}_first"] = (_shader_first(config), shader_dir)
    graphs = dict(point_graphs(), op_probe=(OP_PROBE_GRAPH, probe_dir), **first)
    # bloom_glow, the op probe and the loop and shift shaders before a
    # gaussian run per node: the tier rule against halo recompute refuses
    # their mc plans, which the kernel checks still run (the op list reads
    # the input, so its checks hold bit for bit where the conv follows it).
    tiers = {"mixed_border": "segments", "bloom_glow": None, "op_probe": None,
             **{name: None for name in first}}
    for name, (config, shader_dir) in graphs.items():
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            prog = build_program(config, WIDTH, HEIGHT, fmt, device="cuda", shader_path=shader_dir)
            tier = prog._strip_plan[0] if prog._strip_plan else None
            if tier != tiers.get(name, "mc"):
                raise AssertionError(f"J {name} {fmt}: tier {tier}")
            mc = _mc_of(prog)
            if (mc.mode == "zero") != (name in ("zero_border", "mixed_border")):
                raise AssertionError(f"J {name} {fmt}: mode {mc.mode}")
            print(f"J plan {name} {fmt} 4K: {plan_steps(prog)}; {_mc_plan_text(prog, cuda_ops)}")
            xin = x.to(prog.storage_dtype)
            got = cuda_ops.graph_strip_mc(xin, 0.5, mc)
            want = cuda_ops.graph_strip_mc_plain(xin, 0.5, mc)
            torch.cuda.synchronize()
            err = _check_fmt(f"J graph_strip_mc {name} {fmt} 4K ({mc.mode}) vs its plain version",
                             fmt, got, want, rgba8_steps=steps8.get(name, 2),
                             share=shares.get(name, 0.0))
            del got, want

    # The four bit casts on special values: the kernel bit for bit its
    # plain version (NaN payloads, infinities, denormals, -0.0).
    bdir = os.path.join(jdir, "bitcast")
    os.makedirs(bdir)
    with open(os.path.join(bdir, "bitcast.comp"), "w") as f:
        f.write(BITCAST_PROBE)
    prog = build_program(BITCAST_GRAPH, WIDTH, HEIGHT, "rgba32f", device="cuda", shader_path=bdir)
    if plan_steps(prog) != [("mc", ["gs", "bitcast"])]:
        raise AssertionError(f"J bitcast probe: plan {plan_steps(prog)}")
    mc = prog._strip_plan[1]
    xb = _bitcast_input(SEED + 19).cuda()
    got = cuda_ops.graph_strip_mc(xb, 0.5, mc)
    want = cuda_ops.graph_strip_mc_plain(xb, 0.5, mc)
    torch.cuda.synchronize()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    nan_payloads = int((got[0].view(torch.int32) == 0x7FC01234).sum())
    if differ or not nan_payloads:
        raise AssertionError(f"J bitcast probe: {differ} words differ from the plain version, "
                             f"{nan_payloads} NaN payloads kept")
    print(f"check J graph_strip_mc bitcast probe 4K rgba32f vs its plain version: every word "
          f"bit-equal ({nan_payloads} NaN payloads 0x7fc01234 kept); {_mc_plan_text(prog, cuda_ops)}")
    del got, want, xb

    # The halo recompute of mc plans that beat per node (the demo, neon
    # edges) and of one that loses to it (bloom_glow, builtin tonemap).
    with tempfile.TemporaryDirectory(prefix="rf_chip_smoke_empty_") as empty:
        for name, config in (("demo", DEMO_CONFIG), ("neon_edges", LIBRARY_GRAPHS["neon_edges"]),
                             ("bloom_glow builtin", point_graphs()["bloom_glow"][0])):
            prog = build_program(config, WIDTH, HEIGHT, device="cuda", shader_path=empty)
            print(f"J plan {name} rgba32f 4K: {_mc_plan_text(prog, cuda_ops)}")

    # The op-count sweep: a point stage after a conv adds no halo
    # recompute, so each list keeps the mc plan.
    xs = torch.from_numpy(np.random.default_rng(SEED + 17).random(big, dtype=np.float32)).cuda()
    for reps in OP_SWEEP_REPS:
        sdir = os.path.join(jdir, f"sweep_{reps}")
        os.makedirs(sdir)
        with open(os.path.join(sdir, "sweep.comp"), "w") as f:
            f.write(_op_sweep_shader(reps))
        prog = build_program(OP_SWEEP_GRAPH, WIDTH, HEIGHT, "rgba32f", device="cuda",
                             shader_path=sdir)
        if plan_steps(prog) != [("mc", ["gs", "sweep"])]:
            raise AssertionError(f"J op sweep {reps}: plan {plan_steps(prog)}")
        mc = prog._strip_plan[1]
        n_ops = int(next(st.taps[0][0] for st in mc.stages if st.op.code == cuda_ops.MC_GLSL))
        got = cuda_ops.graph_strip_mc(xs, 0.5, mc)
        want = cuda_ops.graph_strip_mc_plain(xs, 0.5, mc)
        torch.cuda.synchronize()
        _check_fmt(f"J graph_strip_mc op sweep, {n_ops} ops, 4K rgba32f vs its plain version",
                   "rgba32f", got, want)
        del got, want
    del xs

    cuda_ops.reset_launches()
    glsl_form = 0  # graph_strip_mc's launches on its glsl form (an op list, or zero mode)
    for name, (config, shader_dir) in point_graphs().items():
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            before_mc = cuda_ops.LAUNCHES["graph_strip_mc"]
            cfg = os.path.join(jdir, f"{name}_{fmt}.rf")
            with open(cfg, "w") as f:
                f.write(config)
            engine = Engine(RenderInfo(WIDTH, HEIGHT, "cuda", config_path=cfg,
                                       shader_path=shader_dir, fmt=fmt, has_input_image=True))
            engine.load_input(u8)
            prog, xf = engine.program, engine._file_input()
            before = dict(cuda_ops.LAUNCHES)
            frame = engine.render_frame_blocking(0.5)
            per_frame = {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items() if v != before[k]}
            if per_frame.get("graph_strip_mc", 0) != (1 if tiers.get(name, "mc") else 0):
                raise AssertionError(f"J {name} {fmt}: launches a frame {per_frame}")
            seq = prog.render_sequence(xf, 0.5, 0.016, 4, stack=True)
            per_node = prog._forward_nostrip(xf, 0.5)
            for what, v in (("frame", frame), ("per node", per_node)):
                if tuple(v.shape) != big or not bool(torch.isfinite(v.float()).all()):
                    raise AssertionError(f"J {name} {fmt} {what}: bad shape or non-finite values")
            _check(f"J {name} {fmt} render_sequence frame 0 vs render_frame",
                   _max_err(seq[0], frame), 0.0)
            _check_fmt(f"J {name} {fmt} {_tier(prog)} vs per node 4K", fmt, frame, per_node,
                       rgba8_steps=steps8.get(name, 2), rgba8_flips=flips8.get(name, 1e-3),
                       share=shares.get(name, 0.0))
            print(f"J {name} {fmt} 4K: launches a frame {json.dumps(per_frame)} [{smi}]")
            mc = _mc_of(prog)
            if mc.mode == "zero" or cuda_ops.MC_GLSL in [st.op.code for st in mc.stages]:
                glsl_form += cuda_ops.LAUNCHES["graph_strip_mc"] - before_mc
            engine.close()
            del frame, seq, per_node
    print(f"J graph_strip_mc launches on its glsl form: {glsl_form} of "
          f"{cuda_ops.LAUNCHES['graph_strip_mc']}")
    return dict(cuda_ops.LAUNCHES)


# Path J's op-count sweep: a point shader of 4 + 6 reps ops (four loads,
# then a multiply and an add a colour channel a step) after a gaussian.
OP_SWEEP_REPS = (1, 6, 13, 26)  # 10, 40, 82 and 160 ops
OP_SWEEP_GRAPH = "input -> gs -> sweep -> output\ngs: gaussian { sigma: 2.0 }\nsweep: sweep {}\n"


def _op_sweep_shader(reps: int) -> str:
    steps = "".join(f"    v = v * {1.0 + (k + 1) / 1024.0} + {(k + 1) / 4096.0};\n"
                    for k in range(reps))
    return ("#version 450\nlayout (local_size_x = 16, local_size_y = 16) in;\n"
            "layout (binding = 0, rgba32f) uniform readonly image2D input_image;\n"
            "layout (binding = 1, rgba32f) uniform writeonly image2D output_image;\n"
            "void main() {\n    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);\n"
            "    vec4 c = imageLoad(input_image, pos);\n    vec3 v = c.rgb;\n" + steps
            + "    imageStore(output_image, pos, vec4(v, c.a));\n}\n")


# ---- path K: parallel/ --------------------------------------------------------------

# A GLSL point shader reading gl_GlobalInvocationID.y and imageSize: on the
# mc tier an op list whose K_COORD_Y must read the image's row on a slab.
K_YSHADE = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly  image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 c = imageLoad(input_image, pos);
    float f = float(pos.y) / float(size.y) + 0.25 * float(pos.y % 3);
    imageStore(output_image, pos, vec4(c.rgb * f, c.a));
}
"""
K_FORMATS = ("rgba32f", "rgba16f", "rgba8")


def _k_graphs(kdir: str, empty: str) -> dict:
    """Path K's graphs: name -> (config, shader path, slabs)."""
    from reforge_tpu_torch.benchmarks import (
        CHAIN3_CONFIG, DEMO_CONFIG, FLAGSHIP_CONFIG, SHADER_DIR, example_config,
    )

    return {
        "flagship": (FLAGSHIP_CONFIG, empty, 4),  # single tier, vignette's plane a slab
        "demo": (DEMO_CONFIG, empty, 4),  # mc tier
        "chain3": (CHAIN3_CONFIG, empty, 4),  # mc, edge hazard: top / mid / bottom slabs
        "yshade": ("input -> gs -> ys -> output\ngs: gaussian { sigma: 1.5 }\n", kdir, 4),
        "equalize": (example_config("equalize"), SHADER_DIR, 4),  # buffers: a gather
        "pixelate": ("input -> px -> output\npx: pixelate { size: 8 }\n", empty, 4),  # gather
        # per node, a radius past the 270-row slab: two hops of neighbour rows
        "box_blur_r300": ("input -> bb -> output\nbb: box_blur { radius: 300 }\n", empty, 8),
    }


def _k_sharded(graphs: dict, x: torch.Tensor, devices_for, label: str, smi: str) -> dict:
    """Each graph of ``graphs`` in three formats through HaloShardedProgram on
    ``devices_for(slabs)``, against the unsharded program on cuda:0:
    bit-equal, or within the format's bound (rgba8 one code).  Returns the
    rgba32f programs of the flagship and the demo."""
    from reforge_tpu_torch.benchmarks import build_program
    from reforge_tpu_torch.kernels import cuda_ops
    from reforge_tpu_torch.parallel import HaloShardedProgram, make_row_mesh

    kept = {}
    for name, (config, shader_dir, n) in graphs.items():
        for fmt in K_FORMATS:
            prog = build_program(config, WIDTH, HEIGHT, fmt, device="cuda", shader_path=shader_dir)
            devices = devices_for(n)
            sharded = HaloShardedProgram(prog, make_row_mesh(len(devices), devices))
            before = dict(cuda_ops.LAUNCHES)
            got = sharded(sharded.shard_input(x), 0.5)
            per_frame = {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items() if v != before[k]}
            want = prog._forward(x, 0.5)
            torch.cuda.synchronize()
            if tuple(got.shape) != (4, HEIGHT, WIDTH) or not torch.isfinite(got.float()).all():
                raise AssertionError(f"K {name} {fmt}: bad shape or non-finite values")
            err = _max_err(got, want)
            what = f"K {name} {fmt} 4K on {len(devices)} slabs of {label} vs unsharded"
            if err == 0.0:
                print(f"check {what}: bit-equal")
            else:
                print(f"K {name} {fmt}: NOT bit-equal to the unsharded program")
                _check_fmt(what, fmt, got, want, rgba8_steps=1)
            print(f"K {name} {fmt} plan per slab ({label}): {sharded.slab_plans}; launches a "
                  f"frame {json.dumps(per_frame)} [{smi}]", flush=True)
            if fmt == "rgba32f" and name in ("flagship", "demo"):
                kept[name] = (prog, sharded)
            del got, want
    return kept


def path_k(tmp: str, smi: str) -> dict:
    """Path K: parallel/ on the card.  Kernel checks first (not counted):
    graph_strip (the flagship, its hoisted plane built for the slab) and
    graph_strip_mc (the demo; a GLSL point shader, the glsl form) on slab 1
    of 4 extended by the plan's input halo, row0 != 0, against their plain
    versions.  Then, counted: (1) HaloShardedProgram on 4 slabs of cuda:0
    (8 for box_blur r300, radius past a slab) in three formats, each
    against the unsharded program; (2) PipelineStagedProgram over cuda:0
    twice, render_stream of 8 frames of the flagship and the demo against
    the program per node; (3) BatchProgram over 8 frames on 4 shares of
    cuda:0; (4) ``python -m reforge_tpu_torch --shard 1`` and ``--shard
    4``; then, where there are two cards or more, (1)-(3) on distinct
    cards.  Returns the launch counts."""
    from reforge_tpu_torch.benchmarks import FLAGSHIP_CONFIG, build_program
    from reforge_tpu_torch.io import encode
    from reforge_tpu_torch.kernels import cuda_ops
    from reforge_tpu_torch.parallel import (
        BatchProgram, HaloShardedProgram, PipelineStagedProgram, make_batch_mesh, make_row_mesh,
    )

    kdir = os.path.join(tmp, "k")
    empty = os.path.join(tmp, "k_empty")
    os.makedirs(kdir)
    os.makedirs(empty)
    with open(os.path.join(kdir, "ys.comp"), "w") as f:
        f.write(K_YSHADE)
    graphs = _k_graphs(kdir, empty)
    x = torch.from_numpy(np.random.default_rng(SEED + 17).random(
        (4, HEIGHT, WIDTH), dtype=np.float32)).cuda()
    one_card = lambda n: ["cuda:0"] * n  # noqa: E731

    for name in ("flagship", "demo", "yshade"):
        config, shader_dir, n = graphs[name]
        prog = build_program(config, WIDTH, HEIGHT, device="cuda", shader_path=shader_dir)
        sharded = HaloShardedProgram(prog, make_row_mesh(n, one_card(n)))
        _route, rh, _mode = sharded._slab_route(1)
        h = sharded.h_local
        slab = x[:, h - rh:2 * h + rh].contiguous()
        plan = prog._strip_plan
        if plan[0] == "mc":
            got = cuda_ops.graph_strip_mc(slab, 0.5, plan[1], h - rh)
            want = cuda_ops.graph_strip_mc_plain(slab, 0.5, plan[1], h - rh)
        else:
            strip = prog._strip_program_for(slab.device, h - rh, h + 2 * rh)
            got = cuda_ops.graph_strip(slab, 0.5, strip, h - rh, HEIGHT)
            want = cuda_ops.graph_strip_plain(slab, 0.5, strip, h - rh, HEIGHT)
        frame = prog._forward(x, 0.5)
        torch.cuda.synchronize()
        _check(f"K {plan[0]} kernel on {name}'s slab 1 of 4 (rows {h - rh}..{2 * h + rh}, row0 "
               f"{h - rh}) vs its plain version", _max_err(got, want), 1e-5)
        _check(f"K {name} slab 1 of 4 cropped vs the kernel's frame rows",
               _max_err(got[:, rh:rh + h], frame[:, h:2 * h]), 0.0)
        del got, want, frame

    cuda_ops.reset_launches()
    kept = _k_sharded(graphs, x, one_card, "cuda:0", smi)
    frames = [x * (1.0 - 0.05 * i) for i in range(8)]
    times = [i / 60.0 for i in range(8)]

    def pipeline_and_batch(stage_devices, batch_devices, label):
        for name in ("flagship", "demo"):
            prog = kept[name][0]
            staged = PipelineStagedProgram(prog, devices=stage_devices)
            outs = list(staged.render_stream(frames, times))
            err = max(_max_err(o, prog.run_unfused(f, t)) for o, f, t in zip(outs, frames, times))
            _check(f"K {name} rgba32f pipeline {len(staged.devices)} stages on {label}, "
                   f"render_stream of 8 frames vs per node", err, 0.0)
            print(f"K {name} pipeline stages ({label}): "
                  f"{[[n.name for layer in g for n in layer] for g in staged.stage_layers]}")
            del outs
        prog = kept["flagship"][0]
        bp = BatchProgram(prog, make_batch_mesh(len(batch_devices), batch_devices))
        batch, n = bp.pad_batch(torch.stack(frames))
        out = bp(bp.shard_input(batch), torch.tensor(times))[:n]
        err = max(_max_err(out[i], prog._forward(frames[i], times[i])) for i in range(n))
        _check(f"K flagship rgba32f batch of {n} frames on {bp.mesh.size} shares of {label} vs "
               f"frame by frame", err, 0.0)
        del out, batch

    pipeline_and_batch(one_card(2), one_card(4), "cuda:0")

    # (4) the command line, in child processes from the checkout's root
    root = os.path.dirname(os.path.abspath(__file__))
    png, cfg = os.path.join(kdir, "in.png"), os.path.join(kdir, "flagship.rf")
    encode(png, np.random.default_rng(SEED + 18).integers(0, 256, (288, 512, 4), np.uint8))
    with open(cfg, "w") as f:
        f.write(FLAGSHIP_CONFIG)
    for shard in (1, 4):
        outp = os.path.join(kdir, f"shard{shard}.png")
        proc = subprocess.run([sys.executable, "-m", "reforge_tpu_torch", "-i", png, "-o", outp,
                               "--config", cfg, "--shader-path", empty, "--shard", str(shard)],
                              capture_output=True, text=True, cwd=root, timeout=300)
        cards = torch.cuda.device_count()
        if shard <= cards:
            if proc.returncode != 0 or not os.path.exists(outp):
                raise AssertionError(f"K --shard {shard}: rc {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            print(f"K python -m reforge_tpu_torch --shard {shard}: rendered ({cards} card(s))")
        elif proc.returncode != 1 or f"requested {shard} devices, have {cards}" not in proc.stderr \
                or os.path.exists(outp):
            raise AssertionError(f"K --shard {shard} on {cards} card(s): rc {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        else:
            print(f"K python -m reforge_tpu_torch --shard {shard}: exit 1 on {cards} card(s): "
                  f"{proc.stderr.strip().splitlines()[-1]}")

    cards = torch.cuda.device_count()
    if cards >= 2:
        devs = [f"cuda:{i}" for i in range(min(4, cards))]
        print(f"K cross-card branch: ran on {devs}; peer access 0 -> 1: "
              f"{torch.cuda.can_device_access_peer(0, 1)}")
        _k_sharded(graphs, x, lambda n: devs, ",".join(devs), smi)
        pipeline_and_batch(devs[:2], devs, ",".join(devs))
    else:
        print(f"K cross-card branch: did not run ({cards} card)")
    return dict(cuda_ops.LAUNCHES)


def path_k_alone() -> int:
    """``python3 chip_smoke.py --path-k``: path K alone
    (the cross-card branch runs where there are two cards or more)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from reforge_tpu_torch.kernels import cuda_ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    count = torch.cuda.device_count()
    peers = [(i, j) for i in range(count) for j in range(count)
             if i != j and torch.cuda.can_device_access_peer(i, j)]
    print(f"cards: {' | '.join(smi)}; peer access: {peers}")
    cuda_ops.load_library()
    with tempfile.TemporaryDirectory(prefix="rf_chip_smoke_k_") as tmp:
        print(f"main path K launches: {json.dumps(path_k(tmp, smi[0]))}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from reforge_tpu_torch.benchmarks import (
        CHAIN3_CONFIG, CW_CHECK_CONFIG, DEMO_CONFIG, EDGES_CONFIG, FLAGSHIP_CONFIG, GLSL_EXAMPLES,
        GLSL_GRAPHS, LIBRARY_GRAPHS, MC_CHECK_CONFIG, MC_TEST_GRAPHS, MIX_SECOND_FIRST_CONFIG,
        PLAN_LIMIT_CONFIG, SHADER_DIR, STYLIZED_GRAPHS, build_flagship, build_program,
        example_config,
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    # The GLSL conv-synthesis cache of this run (removed when the script
    # ends), so the affine probe runs.
    synth_cache = tempfile.TemporaryDirectory(prefix="rf_chip_smoke_synth_")

    # ---- 2. build -----------------------------------------------------------
    cuda_ops.load_library()
    log = cuda_ops.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "stack frame" in line:
                print(f"ptxas: {line.strip()}")
        _check_no_stack(log.read_text())

    # ---- 3. each kernel against its plain version ----------------------------
    cuda_ops.reset_launches()
    w4, w2 = gaussian_weights(4.0), gaussian_weights(2.0)  # soften, crisp
    w1, w96 = np.array([0.25, 0.5, 0.25], np.float32), gaussian_weights(32.0)
    w8, w66 = gaussian_weights(8.0), gaussian_weights(22.0)  # radii 24 (the demo), 66
    big = (4, HEIGHT, WIDTH)
    x4k = torch.from_numpy(rng.random(big, dtype=np.float32)).to(dev)
    x4k_bf = x4k.to(torch.bfloat16)
    ragged = torch.from_numpy(rng.random((4, 37, 71), dtype=np.float32)).to(dev)
    # A frame whose rows are 16-byte aligned and whose tiles are ragged both
    # ways: the conv kernels' interior (16-byte loads, cp.async in f32) and
    # border (clamped) blocks in one launch (its own generator: the draws
    # after it stay).
    mid_conv = torch.from_numpy(
        np.random.default_rng(SEED + 1).random((4, 333, 520), dtype=np.float32)).to(dev)
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
    # Each entry at 4K and on the mid frame, whose blocks are of both kinds.
    conv_kinds = [("sep_conv_fused", [(w4, w4)], torch.float32),
                  ("sep_conv_fused_multi", [(w2, w2), (w4, w4)], torch.float32),
                  ("sep_conv_fused_mxu", [(w4, w4)], torch.bfloat16),
                  ("sep_conv_fused_mxu_x3", [(w8, w8)], torch.float32)]
    for name, plans, dt in conv_kinds:
        rh, rw = max((len(a) - 1) // 2 for a, _ in plans), max((len(b) - 1) // 2 for _, b in plans)
        n_taps = sum(len(a) + len(b) for a, b in plans)
        for x in (x4k, mid_conv):
            th, tw, inner, border = cuda_ops.conv_tile_kinds(x.shape[1], x.shape[2], rh, rw, n_taps)
            if inner == 0 or border == 0:
                raise AssertionError(f"{name} {tuple(x.shape)}: blocks of one kind only")
            print(f"{name} {'x'.join(map(str, x.shape))} tile {th}x{tw}: {inner} interior "
                  f"(16-byte loads) and {border} border (clamped) blocks a plane")
        for mode in ("edge", "zero"):
            conv_case(name, entries[name], mid_conv.to(dt), plans, mode, False)
    # Radius 108, the largest a fused tile holds: only its packed window
    # layout fits shared memory (every block through the clamped reads).
    w108 = box_weights(108)
    th, tw, smem = cuda_ops.pick_tile(108, 108, 2 * len(w108))
    if cuda_ops.conv_layout(th, tw, 108, 108, 2 * len(w108))[0] != 1:
        raise AssertionError("radius 108 should take the packed window layout")
    for mode in ("edge", "zero"):
        conv_case("sep_conv_fused_mxu_x3", entries["sep_conv_fused_mxu_x3"], mid_conv,
                  [(w108, w108)], mode, False)
        conv_case("sep_conv_fused_mxu", entries["sep_conv_fused_mxu"], mid_conv.to(torch.bfloat16),
                  [(w108, w108)], mode, False)

    # stencil_apply: the tables of the main path (sharpen and emboss on four
    # channels, sobel on the luma plane) and the median, edge and zero, on
    # the 4K frame, the ragged one (element loads) and the mid one (16-byte
    # rows, ragged tiles): the radius-1 form; and a 5x5 table (radius 2,
    # the general form) on the ragged and mid frames.  Every product and
    # sum rounds as in the plain version: expected 0.
    luma4k = luma(x4k)[None].contiguous()
    stencils = [("sharpen", 1, cuda_ops.wsum(library.SHARPEN_TAPS), False),
                ("sobel_x", 1, cuda_ops.wsum(library.SOBEL_X_TAPS), True),
                ("emboss", 1, cuda_ops.wsum(library.EMBOSS_TAPS), False),
                ("median9", 1, cuda_ops.MEDIAN9, False),
                ("5x5", 2, cuda_ops.wsum(np.arange(25, dtype=np.float32).reshape(5, 5) / 8 - 1),
                 False)]
    for x in (x4k, ragged, mid_conv):
        for mode in ("edge", "zero"):
            for sname, r, op, one_channel in stencils:
                if r > 1 and x is x4k:
                    continue
                xin = (luma4k if x is x4k else luma(x)[None].contiguous()) if one_channel else x
                got = cuda_ops.stencil_apply(xin, r, r, op, mode)
                want = cuda_ops.stencil_apply_plain(xin, r, r, op, mode)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                _check(f"stencil_apply {sname} {'x'.join(map(str, xin.shape))} {mode} "
                       f"({cuda_ops.choose_stencil_form(r, r, op)} form)", err, 0.0)
                if x is x4k and mode == "edge" and sname == "sharpen":
                    errs["stencil_apply"] = err

    # stencil_reduce_mc: bilateral's reduction at newsprint's radius 4 and
    # watercolor's radius 3 (the run form) at 4K and on the ragged and mid
    # frames, radius 9 (no compiled run form: the shared form) and radius
    # 60 (no shared-memory tile fits it: every tap through global memory)
    # on the ragged frame, in both border modes.  Kernel and plain version
    # call the same expf and round every product and sum alike; 1e-6 allows
    # a few f32 ulps of [0, 1] values.
    def stack(x):
        return torch.cat([x[:3], luma(x)[None]]).contiguous()

    stack4k = stack(x4k)
    reduce_ops = {f"r{r}": library.bilateral_op(r, 8.0 if r == 60 else 2.5, 0.12)
                  for r in (4, 3, 9, 60)}
    forms = {rname: cuda_ops.choose_reduce_form(r, r, op.taps)[0]
             for rname, (r, op) in reduce_ops.items()}
    if forms != {"r4": "run", "r3": "run", "r9": "shared", "r60": "global"}:
        raise AssertionError(f"stencil_reduce_mc forms {forms}")
    frames_c = {"r4": (x4k, ragged, mid_conv), "r3": (x4k, ragged), "r9": (ragged,),
                "r60": (ragged,)}
    for rname, (r, op) in reduce_ops.items():
        for x in frames_c[rname]:
            xs = stack4k if x is x4k else stack(x)
            for mode in ("edge", "zero"):
                got = cuda_ops.stencil_reduce_mc(xs, r, r, op, mode)
                want = cuda_ops.stencil_reduce_mc_plain(xs, r, r, op, mode)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                _check(f"stencil_reduce_mc bilateral {'x'.join(map(str, xs.shape))} r={r} "
                       f"({len(op.taps)} taps) {mode} ({forms[rname]} form)", err, 1e-6)
                if rname == "r4" and x is x4k and mode == "edge":
                    errs["stencil_reduce_mc"] = err

    # conv1d_h / conv1d_w: frost's radius 160 and radius 400 (where the
    # reference itself takes its 1-D kernels at 4K) on the 4K frame; on an
    # odd 6-channel frame (kuwahara's stack) a radius past every
    # shared-memory window (3000: the global-memory path), kuwahara's
    # quadrant vector at radius 130 (zero taps) and radius 160; a sparse
    # vector (gaps between its taps: the register window reloads) on the
    # ragged frame (border tiles only), and it and a box of radius 40 on
    # the mid frame (interior H tiles, cp.async; every W tile there crosses
    # the edge) and on a 64x1024 frame (interior W tiles at columns 256 and
    # 512, 16-byte loads; every H tile crosses the edge); edge and zero
    # borders.  Both sides add the nonzero taps in ascending order and
    # round every product and sum alike: expected bit-equal (0).
    odd6 = torch.from_numpy(rng.random((6, 33, 47), dtype=np.float32)).to(dev)
    wide = torch.from_numpy(
        np.random.default_rng(SEED + 2).random((4, 64, 1024), dtype=np.float32)).to(dev)
    quadrant = np.zeros(261, np.float32)
    quadrant[130:] = 1.0 / 131
    sparse = np.zeros(61, np.float32)
    sparse[[0, 3, 4, 5, 17, 30, 31, 44, 60]] = np.linspace(0.05, 0.2, 9, dtype=np.float32)
    conv1d_cases = [(x4k, box_weights(160), True), (x4k, box_weights(400), False),
                    (odd6, box_weights(3000), False), (odd6, quadrant, False),
                    (odd6, box_weights(160), False), (ragged, sparse, False),
                    (mid_conv, sparse, False), (mid_conv, box_weights(40), False),
                    (wide, sparse, False), (wide, box_weights(40), False)]
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

    # stencil_apply_mc: every form (cuda_ops.choose_stencil_mc_form) at 4K,
    # on the ragged frame and on the 333x520 frame, f32 and bf16, edge and
    # zero.  The run form: a dense table (C_in 4 -> C_out 4, radius 2: 400
    # terms), C_out 3 at radii (2, 3), C_out 4 at radius 1; the masked run
    # form: the r2 table with half its terms zero, and C_out 3 at radius 3
    # with a third of its terms and one output channel empty; the general
    # form: six input channels; the global form: radius 24 on the ragged
    # frame, where no shared-memory tile holds the window and the terms.
    # Both sides add each output's products in the table's order, each
    # rounded alone: expected bit-equal (0).
    # The dense tables draw from rng as before; the sparse and six-channel
    # ones from a generator of their own (the draws after them stay).
    dense = {name: rng.standard_normal(shape).astype(np.float32)
             for name, shape in (("4->4 r2", (4, 4, 5, 5)), ("4->3 r2,3", (3, 4, 5, 7)),
                                 ("4->4 r1", (4, 4, 3, 3)), ("4->3 r24", (3, 4, 49, 49)))}
    lrng = np.random.default_rng(SEED + 3)

    def lin_table(shape, density=1.0, empty=()):
        w = lrng.standard_normal(shape).astype(np.float32)
        w[lrng.random(shape) >= density] = 0.0
        w[list(empty)] = 0.0
        return w

    lin_ops = {name: cuda_ops.LinearStencilOp(w) for name, w in (
        ("4->4 r2", dense["4->4 r2"]), ("4->3 r2,3", dense["4->3 r2,3"]),
        ("4->4 r1", dense["4->4 r1"]), ("4->4 r2 half", lin_table((4, 4, 5, 5), 0.5)),
        ("4->3 r3 third, one empty", lin_table((3, 4, 7, 7), 1 / 3, empty=(1,))),
        ("6->3 r2", lin_table((3, 6, 5, 5))), ("4->3 r24", dense["4->3 r24"]))}
    lin_forms = {name: cuda_ops.choose_stencil_mc_form(op)[0] for name, op in lin_ops.items()}
    if list(lin_forms.values()) != ["run", "run", "run", "run_masked", "run_masked", "shared",
                                    "global"]:
        raise AssertionError(f"stencil_apply_mc forms {lin_forms}")
    for tname, op in lin_ops.items():
        form = lin_forms[tname]
        for x in ((ragged,) if form == "global" else (x4k, ragged, mid_conv)):
            if op.c_in == 6:
                x = torch.cat([x, x[:2]]).contiguous()
            for dt in (torch.float32, torch.bfloat16):
                for mode in ("edge", "zero"):
                    xin = x.to(dt)
                    got = cuda_ops.stencil_apply_mc(xin, op, mode)
                    want = cuda_ops.stencil_apply_mc_plain(xin, op, mode)
                    torch.cuda.synchronize()
                    err = _max_err(got, want)
                    _check(f"stencil_apply_mc {tname} ({op.n_terms} terms) "
                           f"{'x'.join(map(str, x.shape))} {dt} {mode} ({form} form)", err, 0.0)
                    if x is x4k and tname == "4->4 r2" and dt == torch.float32 and mode == "edge":
                        errs["stencil_apply_mc"] = err
    del got, want

    # Device forms: every channel-local builtin's cw_op on graph_strip and
    # every new mc point op on graph_strip_mc (the two check graphs),
    # against per node on the card, at 4K and on a ragged frame.
    frames = {HEIGHT: x4k, 37: ragged, 333: mid_conv}
    for cname, config, kname in (("cw_check", CW_CHECK_CONFIG, "graph_strip"),
                                 ("plan_limit", PLAN_LIMIT_CONFIG, "graph_strip"),
                                 ("mc_check", MC_CHECK_CONFIG, "graph_strip_mc")):
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            for h, w in ((HEIGHT, WIDTH), (37, 71), (333, 520)):
                prog = build_program(config, w, h, fmt, device=dev)
                if prog._strip_plan[0] != ("single" if kname == "graph_strip" else "mc"):
                    raise AssertionError(f"{cname} {fmt}: tier {prog._strip_plan[0]}")
                if cname == "plan_limit":
                    prog._strip_program = prog._build_strip_program()
                    n_plans = len(prog._strip_program.plans)
                    if n_plans != cuda_ops.MAX_PLANS:
                        raise AssertionError(f"plan_limit: {n_plans} plans")
                    _check_fmt(f"graph_strip plan_limit ({n_plans} plans) {fmt} {h}x{w} vs its "
                               "plain version", fmt, cuda_ops.graph_strip(
                                   frames[h].to(prog.storage_dtype), 0.5, prog._strip_program),
                               cuda_ops.graph_strip_plain(frames[h].to(prog.storage_dtype), 0.5,
                                                          prog._strip_program))
                xin = frames[h].to(prog.storage_dtype)
                before = cuda_ops.LAUNCHES[kname]
                got = prog._forward(xin, 0.5)
                per_node = prog._forward_nostrip(xin, 0.5)
                torch.cuda.synchronize()
                if cuda_ops.LAUNCHES[kname] != before + 1:
                    raise AssertionError(f"{cname} {fmt}: {kname} not launched once")
                _check_fmt(f"{kname} {cname} {fmt} {h}x{w} vs per node on the card", fmt, got,
                           per_node)

    for fmt in ("rgba32f", "rgba16f", "rgba8"):
        for h, w in ((HEIGHT, WIDTH), (37, 71), (333, 520)):
            prog = build_flagship(w, h, fmt, device=dev)
            prog._strip_program = prog._build_strip_program()
            strip = prog._strip_program
            # The op list reuses slots: liveness numbering (5 ops, 3 slots).
            written, reused = set(range(1 + len(strip.plans))), 0
            for op in strip.ops:
                reused += op.out in written
                written.add(op.out)
            slots = [(op.ins, op.out) for op in strip.ops]
            if reused == 0 or max(op.out for op in strip.ops) >= cuda_ops.MAX_SLOTS:
                raise AssertionError(f"flagship {fmt}: op slots {slots}")
            x = frames[h].to(prog.storage_dtype)
            got = cuda_ops.graph_strip(x, 0.5, strip)
            want = cuda_ops.graph_strip_plain(x, 0.5, strip)
            torch.cuda.synchronize()
            err = _check_fmt(f"graph_strip {fmt} {h}x{w} (op slots in, out: {slots}, "
                             f"{reused} reused)", fmt, got, want)
            if h == HEIGHT:
                if fmt == "rgba32f":
                    errs["graph_strip"] = err

    graphs = {"demo": DEMO_CONFIG, "edges": EDGES_CONFIG, "chain3": CHAIN3_CONFIG}

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
    for name in ("glsl_blur", "glsl_blur_sharpen"):
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            for h, w, x in ((HEIGHT, WIDTH, x4k), (37, 71, ragged)):
                prog, xin, _err = mc_case(name, GLSL_GRAPHS[name], fmt, h, w, x, SHADER_DIR)
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
    # Frames with interior and border blocks at once (333x520: ragged both
    # ways): the demo (its blur reads per-channel windows of the input) and
    # convs that read a pool slot near the edge, whose border blocks fill
    # the slot's outside cells with the clamped values (conv_of_conv: a
    # blur of a blur; emboss_unsharp_chain: unsharp of an emboss stencil;
    # chain3: a sobel of a blur) and neon edges, against the plain version;
    # neon edges also against the per-node tier on the card, whose convs
    # round once a tap as the kernel's do (at 4K, path D, its threshold
    # turns a one-rounding difference of the plain version's multiply-adds
    # into a whole bloom disc: 795 values off by up to 0.97 against plain,
    # the kernel equal to per node; at 333x520 all three agree).
    mid_cases = {"demo": DEMO_CONFIG, "conv_of_conv": MC_TEST_GRAPHS["conv_of_conv"],
                 "emboss_unsharp_chain": MC_TEST_GRAPHS["emboss_unsharp_chain"],
                 "chain3": CHAIN3_CONFIG, "neon_edges": LIBRARY_GRAPHS["neon_edges"]}
    for fmt in ("rgba32f", "rgba16f", "rgba8"):
        for name, config in mid_cases.items():
            prog, xin, _ = mc_case(f"{name} mid", config, fmt, 333, 520, mid_conv)
            if name == "neon_edges":
                _check_fmt(f"graph_strip_mc neon_edges {fmt} 333x520 tile "
                           f"{prog._strip_plan[1].tile()[:2]} vs per node on the card", fmt,
                           cuda_ops.graph_strip_mc(xin, 0.5, prog._strip_plan[1]),
                           prog._forward_nostrip(xin, 0.5))
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
    # convs (sep_conv_fused; in rgba16f the soft node's takes the bf16
    # entry, bloom's masked image stays f32) and sobel's two stencil
    # passes.
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
            shot_want = ({"sep_conv_fused": 2} if fmt == "rgba32f" else
                         {"sep_conv_fused": 1, "sep_conv_fused_mxu": 1})
            shot_want["stencil_apply"] = 2
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
    # E4 the reference's glsl_chain and glsl_sharpen on the mc tier as well
    # (tonemap.comp an op-list point stage, one graph_strip_mc a frame); E5
    # the image-only examples in rgba32f, one frame each on the tier the
    # planner picks.
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
    for name in GLSL_EXAMPLES:
        engine = Engine(info(name, "rgba32f", False, SHADER_DIR))
        engine.load_input(u8)
        before = dict(cuda_ops.LAUNCHES)
        frame = engine.render_frame_blocking(0.5)
        launched = {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items() if v != before[k]}
        engine.close()
        if tuple(frame.shape) != big or not bool(torch.isfinite(frame.float()).all()):
            raise AssertionError(f"E5 {name}: bad shape or non-finite values")
        print(f"E5 {name} rgba32f 4K: {_tier(engine.program)}, launches {json.dumps(launched)}")
    counts_e = dict(cuda_ops.LAUNCHES)
    print(f"main path E (GLSL: default config, glsl_blur, glsl_blur_sharpen, glsl_chain, "
          f"glsl_sharpen, {len(GLSL_EXAMPLES)} examples) launches: {json.dumps(counts_e)}")
    if counts_e["graph_strip_mc"] == 0:
        raise AssertionError("main path E never launched graph_strip_mc")
    tiers_e = {"glsl_blur": "mc", "glsl_blur_sharpen": "mc", "glsl_chain": "mc",
               "glsl_sharpen": "mc"}
    for (graph, fmt), out in outputs.items():
        prog = out[4].program
        tier = prog._strip_plan[0] if prog._strip_plan else None
        if tier != tiers_e[graph]:
            raise AssertionError(f"{graph} {fmt}: tier {tier}")
        for what, counts, want1 in (("one-shot", out[5], {}),
                                    ("frame path", out[6], {"graph_strip_mc": 6})):
            want = {k: want1.get(k, 0) for k in counts}
            if counts != want:
                raise AssertionError(f"{graph} {fmt} {what}: launches {counts}, expected {want}")
        # rgba16f: the mc tier's bf16 roundings differ from per node's by up
        # to 2e-2, which sRGB's slope turns into more than one u8 code.
        check_outputs(graph, fmt, *out[:5], tier=_tier(prog), shot_vs_per_node=fmt == "rgba16f")
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
            what = f"{graph} {fmt} {_tier(gpu)} 512x288 card vs CPU"
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
        what = f"{graph} {fmt} {_tier(gpu)} 512x288 card vs CPU"
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

    # Path F: storage buffers, atomics and lut1d; path G: live reload.
    counts_f = path_f(dev, u8, tmp, smi)
    print(f"main path F (equalize, auto_expose, waveform_scope, lut1d; plain PyTorch) "
          f"launches: {json.dumps(counts_f)}")
    counts_g = path_g(dev, u8, tmp, smi)
    print(f"main path G (live reload: flagship, glsl-blur, auto_expose) launches: "
          f"{json.dumps(counts_g)}")
    if counts_g["graph_strip"] == 0 or counts_g["graph_strip_mc"] == 0:
        raise AssertionError("main path G never launched graph_strip or graph_strip_mc")
    counts_h = path_h(tmp, smi)
    print(f"main path H (the CLI: one-shot flagship, resize, card vs CPU, live loop, batch, "
          f"video) launches: {json.dumps(counts_h)}")
    counts_i = path_i(u8, tmp, smi)
    print(f"main path I (segments and a .py kernel) launches: {json.dumps(counts_i)}")
    if counts_i["graph_strip_mc"] == 0:
        raise AssertionError("main path I never launched graph_strip_mc")
    counts_j = path_j(u8, tmp, smi)
    print(f"main path J (GLSL point shaders and zero-border convs on the mc tier) launches: "
          f"{json.dumps(counts_j)}")
    if counts_j["graph_strip_mc"] == 0:
        raise AssertionError("main path J never launched graph_strip_mc")
    counts_k = path_k(tmp, smi)
    print(f"main path K (parallel/: row slabs, pipeline stages, batch shares, --shard) launches: "
          f"{json.dumps(counts_k)}")
    if counts_k["graph_strip"] == 0 or counts_k["graph_strip_mc"] == 0:
        raise AssertionError("main path K never launched graph_strip or graph_strip_mc")

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
    # Each kernel's launches come from the main path it belongs to, plus
    # paths I's, J's and K's; stencil_apply_mc's from path E, where nothing
    # calls it (0).
    path_of = {"sep_conv_fused": counts_a, "sep_conv_fused_multi": counts_a,
               "sep_conv_fused_mxu": counts_a, "graph_strip": counts_a,
               "stencil_reduce_mc": counts_c, "conv1d_h": counts_d, "conv1d_w": counts_d,
               "stencil_apply_mc": counts_e}
    launches = {name: path_of.get(name, counts_b)[name] + counts_i[name] + counts_j[name]
                + counts_k[name] for name in replaces}
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": sources.get(name, "reforge_tpu_torch/csrc/sep_conv.cu"),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name],
        }
        for name in replaces
    ]
    check_build_alone(u8, tmp, smi)
    tmp_dir.cleanup()
    synth_cache.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--path-k"]:  # path K alone, e.g. on four cards
        sys.exit(path_k_alone())
    sys.exit(main())
