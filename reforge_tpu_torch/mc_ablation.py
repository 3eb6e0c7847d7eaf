"""Split a conv kernel's time at 3840x2160 by cutting parts out, and A/B
the kernels against another checkout.

    python3 -m reforge_tpu_torch.mc_ablation [--kernel mc|strip|sep|conv1d|reduce|stencil|stencil_mc]
                                             [--tiles 16x64,32x32]
                                             [--package DIR/reforge_tpu_torch] [--variants a,b]
    python3 -m reforge_tpu_torch.mc_ablation --parent DIR/reforge_tpu_torch
    python3 -m reforge_tpu_torch.mc_ablation --sass stencil_reduce_run

Each variant is a copy of a package (this one, or ``--package``'s) under
``build/mc_ablation/`` whose kernel source carries one set of source
edits.  A cut variant's output is wrong by design; only its time means
anything.  A variant whose anchors a source lacks is skipped.
``--kernel`` picks the source and its variants:

  mc     csrc/graph_strip_mc.cu (demo rgba32f and rgba16f, chain3, edges,
         neon edges, glsl-blur, glsl-blur-sharpen and glsl-chain rgba32f
         and rgba16f; glsl-sharpen, tonemap.comp before sharpen.comp,
         blur_sharpen_blend, zero_border and the loop and shift graphs
         (benchmarks.LOOP_GRAPHS) rgba32f):
         load_only (return once the input block is in shared memory),
         no_conv, no_stencil (skip those stages), no_glsl (a GLSL point
         stage's op list not evaluated: the stage passes its input on, its
         loads and stores stay; tonemap.comp, blend.comp), conv_one_tap (each conv
         pass cut to one tap: its loads, phases and stores stay),
         no_border (border blocks skip their own work: the fill of a
         slot's outside cells, or, in the parent's source, the clamped
         conv path; wrong at the image's edges, but timed),
         one_window (a design choice: the conv's per-channel windows of
         the input in one buffer on every graph, at the tile the chooser
         picks; edits kernels/cuda_ops.py); and the glsl form's design
         choices: one_pixel, two_pixels and four_pixels (the op list for
         one, two or four cells a thread at once on every plan, not four
         where their files fit beside the tile two leave, else two; edits
         kernels/cuda_ops.py, whose layout sizes the register files),
         const_files (the
         program's constants copied into each thread's register files
         once a stage, as the form before its redesign did, and read
         there, not from the program's own table), thread_loops (a loop's
         back-edge taken by each thread for its own pixels, not by the
         warp together: threads that leave a loop early run the rest of
         the list apart from the others);
  strip  csrc/graph_strip.cuh (the flagship, rgba32f and rgba16f):
         load_only, h_only (the H passes, no W pass, no epilogue, no
         store), no_w (the W passes cut to one tap: their loads and
         stores stay), no_epilogue (the first conv's result stored as it
         is), and two design choices: threads_512 (blocks of 512, one
         W-pass run a thread) and channel_slowest (the channel the grid's
         slowest dimension);
  sep    csrc/sep_conv.cu (sep_conv_fused r12, sep_conv_fused_multi
         r6+12, sep_conv_fused_mxu r12 bf16, sep_conv_fused_mxu_x3 r24):
         load_only, h_only (no W pass, no store), no_w (the W pass cut
         to one tap);
  conv1d csrc/conv1d.cu (conv1d_h and conv1d_w, box radius 160 and 400,
         gaussian radius 160, four channels): load_only (return once the
         window is in shared memory), one_tap (the tap list cut to its
         first tap: the window's load and the stores stay);
  reduce csrc/stencil_reduce.cu (stencil_reduce_mc, bilateral radius 4
         (81 taps), 3 (49) and 60 (the global-memory form), luma the
         fourth plane): load_only (return once the window is in shared
         memory), one_tap (the tap list cut to its first tap), no_exp
         (the exponential replaced by its argument), and design choices
         of the run form: run_4 (four outputs a thread, a 32x32 tile),
         no_load (the window's copies skipped: what they cost the full
         kernel) and dy_unroll (the row loop unrolled three times);
  stencil csrc/stencil.cu (stencil_apply: sharpen and median9 on four
         channels, sobel_x on the luma plane): load_only (the radius-1
         form: the rows load, nothing is computed or stored; the general
         form: return once the window is in shared memory), centre_only
         (every output the centre value: loads and stores stay; the
         radius-1 form's halo columns then go unread), and design choices
         of the radius-1 form: channel_fastest (the channel the grid's
         fastest dimension), channels_in_block (a block makes every
         channel of its tile), rows_16 and rows_32 (rows a warp; 8 by
         default), y_unrolled (the row loop left to the compiler),
         bounds_4 and bounds_1 (a floor of four blocks an SM, or none, on
         the registers; three by default);
  stencil_mc csrc/stencil_mc.cuh, or csrc/stencil_mc.cu in a source from
         before the run forms (stencil_apply_mc: f32 4->4 radius 2, its
         bf16 input, the same table with half its terms zero, 4->3 at
         radii (2, 3), 4->4 radius 1, all on the run forms; 6->3 radius 2
         on the general form; 4->3 radius 24 on a 960x540 crop, the global
         form): load_only (the run forms: no rows of terms and no stores,
         the window copies stay; the general form: return once the window
         is in shared memory), one_term (each output's list cut to its
         first term; loads and stores stay), no_offset (the general form
         reads each tap at the pixel itself, with no offset load), and
         design choices of the run forms: no_load and no_store (the f32
         window's copies skipped, or the outputs' staging and stores: what
         they cost the full kernel), sync_copy (f32 copied through
         registers, not by cp.async), outputs_4 and outputs_16 (outputs a
         thread, 8 by default), dy_unroll (the row loop unrolled twice)
         and global_rows (no window in shared memory: each thread reads
         its window rows from global memory, lanes on column runs).

Each copy builds its own kernels and, in a process of its own, times its
rows with CUDA events (20 launches after 3).  ``full`` runs first and
last, so drift within the call shows.  ``--tiles`` (mc only) also times
the full kernel with each tile forced on every graph.  An edit names its
anchor in the source of this commit and, where that differs, in the
source of the commit before the conv stage's redesign, so that the same
cuts run on both (``--package`` an unpacked parent).

``--sass NAME`` prints the SASS of this package's kernels whose names
contain NAME, counted by opcode, and the opcodes of each one's hottest
loop (cuobjdump of the built library).

``--parent`` is an A/B run instead: the package of another checkout (an
unpacked parent commit, say) against this one, parent, this, this,
parent, each a copy with this file in it, over every row above, the
whole frames of the mc graphs (demo, chain3, edges: ``frame`` rows), and
graph_strip_mc on every plan of ``benchmarks.point_graphs()`` and
chip_smoke.py's op probe (the plans the tier rule refuses included) in
rgba32f, rgba16f and rgba8, and on chip_smoke.py's point shader that
reads its row, on a slab of 600 rows at image row 528 (``J`` and ``K``
rows), and whole frames of the loop and shift graphs
(``benchmarks.LOOP_GRAPHS``, ``frame J`` rows: the mc tier here, a
segment and the shader per node where the other side lacks loop
regions).  It prints the max abs difference between the two sides'
outputs of every row.  Needs a CUDA card and nvcc.
"""

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
from typing import Optional

PACKAGE = pathlib.Path(__file__).resolve().parent
OUT = PACKAGE.parent / "build" / "mc_ablation"

_MC_LOOP = "  for (int s = 0; s < args.n_stages; ++s) {\n"
_MC_CONV = "    if (st.kind == MC_CONV) {\n"
# The border blocks' fill of a slot's outside cells (this source's), the
# parent's interior test of a conv stage and its global store.
_MC_FILL = "    if (st.out_off >= 0 && (by < 0 || bx < 0 || by + rows > H || bx + cols > W)) {\n"
_MC_INTERIOR = "      if (tx >= 0 && tx + tcols <= W && by - st.rh >= 0 && by + rows + st.rh <= H) {\n"
_MC_PUT = "  if (st.out_off < 0) {\n"
_MC_PUT_GUARD = "    if (gy < 0 || gy >= g.H || gx < 0 || gx >= g.W) return;\n"
# conv1d.cu: the end of the window's load (this source's, then the
# parent's), and the kernel's first line.
_C1_TAPS = "  cp_async_wait_all();\n  __syncthreads();\n"
_C1_PRE = "  if constexpr (kPre) {\n"
_C1_LOADED = "    w = w_s;\n    off = off_s;\n    __syncthreads();\n  }\n"
_C1_FIRST = "  extern __shared__ float smem[];\n"
# stencil_reduce.cu: the end of the window's load, the kernel's first
# line and the exponential; stencil.cu: the end of the window's load.
_RD_LOADED = ("    for (int c = 0; c < 4; ++c) load_window(x + c * plane, t, zero != 0, "
              "win + c * cs);\n    __syncthreads();\n  }\n")
_RD_FIRST = "  extern __shared__ float smem[];\n"
_RD_EXP = "expf(__fmul_rn(-__fmul_rn(d, d), inv2sr))"
_ST_LOADED = "  load_window(x + c * plane, t, zero != 0, win);\n  __syncthreads();\n"
# The redesigned sources' run form of stencil_reduce.cu (its call of a
# tile's work, its row loop, its tap test, its window copies; the general
# form's first line) and radius-1 form of stencil.cu (its outputs, their
# evaluation, its grid).
_RD_RUN_TILE = "    reduce_run_tile<R, kDense>(win, w_s, rows_s, out, H, W, ty * kReduceTH,\n"
_RD_RUN_DY = "  for (int dy = 0; dy < D; ++dy) {\n"
_RD_RUN_DX = "      if (kDense || (row >> dx & 1)) {\n"
_RD_RUN_COPY = "      for (int ch = 0; ch < 4; ++ch) cp_async4("
_RD_TILE = "  Tile t{H, W, RH, RW, TH, TW, (int)blockIdx.y * TH, (int)blockIdx.x * TW};\n"
_ST_R1_OUT = "      float o[kRun3];\n"
_ST_R1_EVAL = "o[j] = r1_eval<kKind>(r0, r1, r2, j, mask, taps);"
_ST_R1_Y = "    for (int y = ys; y < ye; ++y) {\n"
_ST_R1_GRID = "  dim3 grid((W + rf::kR1TW - 1) / rf::kR1TW, (H + rf::kR1TH - 1) / rf::kR1TH, C);"
# stencil_mc.cu before its redesign: the end of the window's load, an
# output's term range and a tap's shared-memory read.
_SM_LOADED = "    w_t = w_s;\n    start_t = start_s;\n  }\n  __syncthreads();\n"
_SM_RANGE = "const int k0 = start_t[o], k1 = start_t[o + 1];"
_SM_TAP = "if (in_shared) return base[off_s[k]];"
# stencil_mc.cuh, the run forms: a tile's work, the rolled (c, dy) loops,
# the dx loop, the window's per-channel copy and its f32 cp.async.
_MC_RUN_DY = "    for (int dy = 0; dy < KH; ++dy) {\n"
_MC_RUN_DX = "      for (int dx = 0; dx < KW; ++dx) {\n"
_MC_RUN_STORE = "    store_mc_runs<T, CO>(acc, stage, out, H, W, ty * kMcTH,\n"
_MC_RUN_NO_STORE = [(_MC_RUN_STORE, "    if (nonempty < 0)\n" + _MC_RUN_STORE)]
_MC_RUN_COPY = "    for (int ch = 0; ch < kMcMaxC; ++ch) {\n      if (ch < C_in) {\n"
_MC_RUN_ASYNC = "        if constexpr (std::is_same_v<T, float>)\n          cp_async4("
# global_rows: the run form with no window in shared memory; each thread
# reads its window rows from global memory (through L1), lanes on column
# runs (row warp 4 + lane / 8 of the tile, columns (lane % 8) 8), as
# stencil_r1_kernel does.  Its buffers are still allocated (the form is
# held at two blocks an SM by its registers anyway).
_MC_GLOBAL_TERMS = """template <typename T, int RW, int CO, bool kMasked>
__device__ __forceinline__ void mc_run_terms_global(
    const T* __restrict__ x, int H, int W, int RH, bool zero, int y0, int x0,
    const float* __restrict__ w_s, const int* __restrict__ mask_s, int C_in, int nonempty,
    float (&acc)[CO][kMcRun]) {
  using G = McRun<RW, CO>;
  constexpr int KW = G::kKW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gy = y0 + warp * 4 + (lane >> 3), gx0 = x0 + (lane & 7) * kMcRun - RW;
  const int KH = 2 * RH + 1;
  const size_t hw = (size_t)H * W;
  const bool inner = gx0 >= 0 && gx0 + kMcRun + 2 * RW <= W;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
#pragma unroll
    for (int j = 0; j < kMcRun; ++j) acc[o][j] = (nonempty >> o & 1) ? -0.f : 0.f;
  }
#pragma unroll 1
  for (int c = 0; c < C_in; ++c) {
#pragma unroll 1
    for (int dy = 0; dy < KH; ++dy) {
      const int row = c * KH + dy, sy = gy + dy - RH;
      const T* src = x + c * hw + (size_t)min(max(sy, 0), H - 1) * W;
      const bool row_out = zero && (sy < 0 || sy >= H);
      float v[kMcRun + 2 * RW], w[G::kRowW];
#pragma unroll
      for (int k = 0; k < kMcRun + 2 * RW; ++k) {
        const int sx = gx0 + k;
        if (inner)
          v[k] = row_out ? 0.f : to_f32(__ldg(src + sx));
        else
          v[k] = (row_out || (zero && (sx < 0 || sx >= W))) ? 0.f
                                                            : to_f32(__ldg(src + min(max(sx, 0), W - 1)));
      }
#pragma unroll
      for (int q = 0; q < G::kRowW / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(w_s + row * G::kRowW)[q];
        w[4 * q] = f.x;
        w[4 * q + 1] = f.y;
        w[4 * q + 2] = f.z;
        w[4 * q + 3] = f.w;
      }
      const int m = kMasked ? mask_s[row] : 0;
#pragma unroll
      for (int dx = 0; dx < KW; ++dx) {
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          if (!kMasked || (m >> (o * KW + dx) & 1)) {
#pragma unroll
            for (int j = 0; j < kMcRun; ++j)
              acc[o][j] = __fadd_rn(acc[o][j], __fmul_rn(v[j + dx], w[o * KW + dx]));
          }
        }
      }
    }
  }
}

"""
_MC_GLOBAL_ROWS = [
    ("// Persistent blocks: block b makes tiles", _MC_GLOBAL_TERMS
     + "// Persistent blocks: block b makes tiles"),
    ("    mc_run_terms<RW, CO, kMasked>(win0 + (i & 1) * window, w_s, mask_s, C_in, RH, plane,\n"
     "                                  nonempty, acc);\n",
     "    const int ty0 = tile / tiles_x, lane = threadIdx.x & 31;\n"
     "    mc_run_terms_global<T, RW, CO, kMasked>(x, H, W, RH, zero != 0, ty0 * kMcTH,\n"
     "        (tile - ty0 * tiles_x) * kMcTW, w_s, mask_s, C_in, nonempty, acc);\n"
     "    {  // lanes on consecutive runs of a row: the stores coalesce as they are\n"
     "      const int gy = ty0 * kMcTH + (threadIdx.x >> 5) * 4 + (lane >> 3);\n"
     "      const int gx = (tile - ty0 * tiles_x) * kMcTW + (lane & 7) * kMcRun;\n"
     "      for (int o = 0; o < CO; ++o)\n"
     "        for (int j = 0; j < kMcRun; ++j)\n"
     "          if (gy < H && gx + j < W) out[o * (size_t)H * W + (size_t)gy * W + gx + j] =\n"
     "              from_f32<T>(acc[o][j]);\n"
     "    }\n"),
    ("    if (tile >= n_tiles) return;\n", "    if (tile >= 0) return;\n"),
    *_MC_RUN_NO_STORE,
]
_MC_GENERAL = "csrc/stencil_mc.cu"
# graph_strip_mc.cu's glsl form: the op list's call and each output's
# value (no_glsl; then the source before its redesign); the pixels a
# thread; the constants' operands, the files' layout and their sizes on
# the host (const_files).
_MC_GLSL_CALL = "    glsl_ops<P, kTrig, kExt>(prog, R, in0, in1, at0, at1, gy, gx, time);\n"
_MC_GLSL_CALL_WIDE = ("    glsl_ops<P, kTrig, kExt, kWide>(prog, R, in0, in1, at0, at1, gy, gx, time, sm, more, cr,\n"
                      "                                    cc);\n")
_MC_GLSL_CALL_GATHER = ("    glsl_ops<P, kTrig, kExt, kWide, kGather>(prog, R, in0, in1, at0, at1, gy, gx, time, sm,\n"
                        "                                             more, cr, cc, gsrc);\n")
_MC_GLSL_PUT = "if (ok[k]) put(ch, cr[k], cc[k], S[k]);"
_MC_PIX = "MC_GLSL_PIXELS = (2, 4)\n"
_MC_PIX_FORM = ("    return launch<T, true, 2>(", "    return launch<T, true, 2, true>(",
                "    return launch<T, true, 2, false, true>(",
                "    return launch<T, true, 2, true, true>(")
_MC_PIX_GATHER_FORM = ("      return launch<T, true, 2, true, true, false, true>(",
                       "    return launch<T, true, 2, false, false, false, true>(")
_MC_CONST_FILES = [
    ("  const long long* ci;  // the integer constants\n",
     "  const long long* ci;  // the integer constants\n  int nf, ni;\n"),
    ("    return a & kGlslConst ? GlslSrc<float>{cf + (a & (kGlslConst - 1)), 0}\n"
     "                          : GlslSrc<float>{f + a * kLanes, kThreads};\n",
     "    return GlslSrc<float>{f + (a & kGlslConst ? nf + (a & (kGlslConst - 1)) : a) * kLanes,"
     " kThreads};\n"),
    ("    return a & kGlslConst ? GlslSrc<long long>{ci + (a & (kGlslConst - 1)), 0}\n"
     "                          : GlslSrc<long long>{i + a * kLanes, kThreads};\n",
     "    return GlslSrc<long long>{i + (a & kGlslConst ? ni + (a & (kGlslConst - 1)) : a) * "
     "kLanes, kThreads};\n"),
    ("  R.f = files + 2 * prog[2] * R.kLanes + threadIdx.x;\n",
     "  R.f = files + 2 * (prog[2] + prog[4]) * R.kLanes + threadIdx.x;\n"),
    ("  const int dr = blockDim.x / cols, dc = blockDim.x - dr * cols;\n  int r = threadIdx.x / cols, "
     "c = threadIdx.x - r * cols;\n  for (int i = threadIdx.x; i < n; i += P * blockDim.x) {",
     "  R.nf = prog[1];\n  R.ni = prog[2];\n"
     "  for (int q = 0; q < k_f; ++q)\n    for (int k = 0; k < P; ++k)\n"
     "      R.f[(R.nf + q) * R.kLanes + k * kThreads] = R.cf[q];\n"
     "  for (int q = 0; q < prog[4]; ++q)\n    for (int k = 0; k < P; ++k)\n"
     "      R.i[(R.ni + q) * R.kLanes + k * kThreads] = R.ci[q];\n"
     "  const int dr = blockDim.x / cols, dc = blockDim.x - dr * cols;\n  int r = threadIdx.x / cols, "
     "c = threadIdx.x - r * cols;\n  for (int i = threadIdx.x; i < n; i += P * blockDim.x) {"),
    ("    return (int(words[1]) + 2 * int(words[2])) * 256 * pixels\n",
     "    return (int(words[1]) + int(words[3]) + 2 * (int(words[2]) + int(words[4]))) * 256 * "
     "pixels\n", "kernels/cuda_ops.py"),
]
# Anchors in the sources before the redesign (PR 5's graph_strip.cu and
# sep_conv.cu).
_OLD_STRIP_LOOP = "  for (int k = 0; k < n_plans; ++k) {\n    const int rw = meta[4 * k + 1];\n"
_OLD_STRIP_W = "    const float* ww = tap_s + meta[4 * k + 3];\n    for (int i"
_OLD_STRIP_EPI = ("  for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {\n"
                  "    const int y = i / TW, xx")
_OLD_SEP_LOOP = "  for (int k = 0; k < n_plans; ++k) {\n    const int rh = meta[4 * k], rw"
_OLD_SEP_W = "    const float* ww = tap_s + meta[4 * k + 3];\n    TOut* dst"
# Anchors in the redesigned sources, each once in either kernel.
_PASSES = "  // the conv passes\n"
_W_RUN = "run_conv(tmp + "
_W_TAPS = ", 1, 2 * rw + 1, ww, "
_EPI = "  // the epilogue\n"

# kernel -> (its source: the first of these files a package has, {variant:
# [alternative edit lists]}); an edit list is [(anchor, replacement)] of
# the source, or [(anchor, replacement, file)] of another file of the
# package, each anchor found once; the first alternative whose anchors all
# occur once applies.
KERNELS = {
    "mc": (("csrc/graph_strip_mc.cu",), {
        "full": [[]],
        "load_only": [[(_MC_LOOP, "  if (args.n_stages > 0) return;\n" + _MC_LOOP)]],
        "no_conv": [[(_MC_CONV, _MC_CONV + "      continue;\n")]],
        "no_stencil": [[(_MC_CONV, "    if (st.kind == MC_STENCIL) continue;\n" + _MC_CONV)]],
        "no_glsl": [[(_MC_GLSL_CALL_GATHER, ""),
                     (_MC_GLSL_PUT, "if (ok[k]) put(ch, cr[k], cc[k], in0.p[ch * in0.plane + at0[k]]);")],
                    [(_MC_GLSL_CALL_WIDE, ""),
                     (_MC_GLSL_PUT, "if (ok[k]) put(ch, cr[k], cc[k], in0.p[ch * in0.plane + at0[k]]);")],
                    [(_MC_GLSL_CALL, ""),
                     (_MC_GLSL_PUT, "if (ok[k]) put(ch, cr[k], cc[k], in0.p[ch * in0.plane + at0[k]]);")],
                    [(_MC_GLSL_CALL.replace(", kExt", ""), ""),
                     (_MC_GLSL_PUT, "if (ok[k]) put(ch, cr[k], cc[k], in0.p[ch * in0.plane + at0[k]]);")],
                    [("glsl_point(idx + st.t0, file, a, b, yy, gx, time, o);",
                      "for (int c = 0; c < 4; ++c) o[c] = a[c];")],
                    [("glsl_point(idx + st.t0, file, a, b, gy, gx, time, o);",
                      "for (int c = 0; c < 4; ++c) o[c] = a[c];")]],
        "conv_one_tap": [
            [("nh = 2 * rh + 1, nw = 2 * rw + 1;", "nh = 1, nw = 1;")],
            [("nh = 2 * st.rh + 1, nw = 2 * st.rw + 1;", "nh = 1, nw = 1;")],
        ],
        "no_border": [[(_MC_FILL, "    if (false) {\n")],
                      [(_MC_INTERIOR, "      if (true) {\n"), (_MC_PUT, _MC_PUT + _MC_PUT_GUARD)]],
        "one_window": [[("MC_WINDOW_BUFFERS = (2, 1)", "MC_WINDOW_BUFFERS = (1,)",
                         "kernels/cuda_ops.py")]],
        "one_pixel": [[*((f, f.replace("true, 2", "true, 1"))
                         for f in _MC_PIX_FORM + _MC_PIX_GATHER_FORM),
                       (_MC_PIX, "MC_GLSL_PIXELS = (1,)\n", "kernels/cuda_ops.py")],
                      [*((f, f.replace("true, 2", "true, 1")) for f in _MC_PIX_FORM),
                       (_MC_PIX, "MC_GLSL_PIXELS = (1,)\n", "kernels/cuda_ops.py")],
                      [*((f, f.replace("true, 2", "true, 1")) for f in _MC_PIX_FORM[:2]),
                       (_MC_PIX, "MC_GLSL_PIXELS = (1,)\n", "kernels/cuda_ops.py")]],
        "two_pixels": [[(_MC_PIX, "MC_GLSL_PIXELS = (2,)\n", "kernels/cuda_ops.py")]],
        "four_pixels": [[(_MC_PIX, "MC_GLSL_PIXELS = (4,)\n", "kernels/cuda_ops.py")]],
        "const_files": [_MC_CONST_FILES],
        "thread_loops": [[("            any = __any_sync(__activemask(), any);\n", "")]],
    }),
    "strip": (("csrc/graph_strip.cuh", "csrc/graph_strip.cu"), {
        "full": [[]],
        "load_only": [
            [(_PASSES, "  if (out_slot >= 0) return;\n" + _PASSES)],
            [(_OLD_STRIP_LOOP, "  if (n_plans > 0) return;\n" + _OLD_STRIP_LOOP)],
        ],
        "h_only": [
            [(_W_RUN, "if (out_slot < 0) run_conv(tmp + "),
             (_EPI, "  if (out_slot >= 0) return;\n" + _EPI)],
            [(_OLD_STRIP_W, "    continue;\n" + _OLD_STRIP_W),
             (_OLD_STRIP_EPI, "  if (n_plans > 0) return;\n" + _OLD_STRIP_EPI)],
        ],
        "no_w": [
            [(_W_TAPS, ", 1, 1, ww, ")],
            [("blur[k * TH * TW + i] = w_at(tmp, ww, rw, t, y, i - y * TW);",
              "blur[k * TH * TW + i] = tmp[y * t.wcols() + i - y * TW];")],
        ],
        "no_epilogue": [
            [(_EPI, "  out_slot = 1;\n" + _EPI),
             ("    for (int n = 0; n < ops.n; ++n) {", "    for (int n = 0; n < 0; ++n) {")],
            [("    for (int j = 0; j < n_ops; ++j) {",
              "    out_slot = 1;\n    for (int j = 0; j < 0; ++j) {")],
        ],
        # Design choices, redesigned source only: one W-pass run a thread in
        # blocks of 512, and the grid's channel slowest (the fade plane
        # read once for each colour channel from device memory).
        "threads_512": [[("constexpr int kStripThreads = kThreads;",
                          "constexpr int kStripThreads = 2 * kThreads;")]],
        "channel_slowest": [[
            ("  dim3 grid(C, (W + TW - 1) / TW, (H + TH - 1) / TH);",
             "  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);"),
            ("(int)blockIdx.z * TH, (int)blockIdx.y * TW)",
             "(int)blockIdx.y * TH, (int)blockIdx.x * TW)"),
            ("  const int c = blockIdx.x;", "  const int c = blockIdx.z;"),
        ]],
    }),
    "sep": (("csrc/sep_conv.cu",), {
        "full": [[]],
        "load_only": [
            [(_PASSES, "  if (n_plans > 0) return;\n" + _PASSES)],
            [(_OLD_SEP_LOOP, "  if (n_plans > 0) return;\n" + _OLD_SEP_LOOP)],
        ],
        "h_only": [
            [(_W_RUN, "if (n_plans < 0) run_conv(tmp + "),
             ("    store_tile(", "    if (n_plans < 0) store_tile(")],
            [(_OLD_SEP_W, "    continue;\n" + _OLD_SEP_W)],
        ],
        "no_w": [
            [(_W_TAPS, ", 1, 1, ww, ")],
            [("from_f32<TOut>(w_at(tmp, ww, rw, t, y, xx))",
              "from_f32<TOut>(tmp[y * t.wcols() + xx])")],
        ],
    }),
    "conv1d": (("csrc/conv1d.cu",), {
        "full": [[]],
        "load_only": [[(_C1_TAPS + _C1_PRE, _C1_TAPS + "  if (n >= 0) return;\n" + _C1_PRE)],
                      [(_C1_LOADED, _C1_LOADED + "  if (n >= 0) return;\n")]],
        "one_tap": [[(_C1_FIRST, _C1_FIRST + "  n = min(n, 1);\n")]],
    }),
    "reduce": (("csrc/stencil_reduce.cu",), {
        "full": [[]],
        "load_only": [[(_RD_RUN_TILE, "    if (n_tiles < 0)\n" + _RD_RUN_TILE),
                       (_RD_LOADED, _RD_LOADED + "  if (n > 0) return;\n")],
                      [(_RD_LOADED, _RD_LOADED + "  if (n > 0) return;\n")]],
        "one_tap": [[(_RD_RUN_DY, _RD_RUN_DY.replace("dy < D", "dy < 1")),
                     (_RD_RUN_DX, "      if (dx == 0) {\n"),
                     (_RD_TILE, "  n = min(n, 1);\n" + _RD_TILE)],
                    [(_RD_FIRST, _RD_FIRST + "  n = min(n, 1);\n")]],
        "no_exp": [[(_RD_EXP, "__fmul_rn(-__fmul_rn(d, d), inv2sr)")]],
        # Design choices of the run form: four outputs a thread (tile 32x32);
        # the window's copies skipped (what they cost the full kernel); the
        # row loop unrolled three times.
        "run_4": [[("constexpr int kReduceRun = 8;", "constexpr int kReduceRun = 4;"),
                   ("REDUCE_RUN = 8\n", "REDUCE_RUN = 4\n", "kernels/cuda_ops.py")]],
        "no_load": [[(_RD_RUN_COPY, _RD_RUN_COPY.replace("ch < 4", "ch < 0"))]],
        "dy_unroll": [[("#pragma unroll 1\n" + _RD_RUN_DY, "#pragma unroll 3\n" + _RD_RUN_DY)]],
    }),
    "stencil": (("csrc/stencil.cu",), {
        "full": [[]],
        "load_only": [[(_ST_R1_OUT, "      float sum = 0.f;\n#pragma unroll\n"
                        "      for (int k = 0; k < kRun3 + 2; ++k) sum += r2[k];\n"
                        "      if (sum != -1.f) continue;\n" + _ST_R1_OUT)],
                      [(_ST_LOADED, _ST_LOADED + "  if (n >= 0) return;\n")]],
        "centre_only": [[(_ST_R1_EVAL, "o[j] = r1[j + 1];")],
                        [("    if (kind == ST_WSUM) {",
                          "    v = base[RH * cols + RW];\n    if (kind < 0) {"),
                         ("    } else {\n      float m[9];",
                          "    } else if (kind < 0) {\n      float m[9];")]],
        # Design choices of the radius-1 form: the channel the grid's fastest
        # dimension; all channels in one block; 16 or 32 rows a warp; the row
        # loop left to the compiler; a floor of four blocks an SM, or none.
        "channel_fastest": [[
            (_ST_R1_GRID, "  dim3 grid(C, (W + rf::kR1TW - 1) / rf::kR1TW, "
                          "(H + rf::kR1TH - 1) / rf::kR1TH);"),
            ("(int)blockIdx.x * kR1TW + lane", "(int)blockIdx.y * kR1TW + lane"),
            ("(int)blockIdx.y * kR1TH + warp", "(int)blockIdx.z * kR1TH + warp"),
            ("for (int c = blockIdx.z; c < C; c += gridDim.z)",
             "for (int c = blockIdx.x; c < C; c += gridDim.x)"),
        ]],
        "channels_in_block": [[(_ST_R1_GRID, _ST_R1_GRID.replace(", C);", ", 1);"))]],
        "rows_16": [[("constexpr int kR1Rows = 8;", "constexpr int kR1Rows = 16;")]],
        "rows_32": [[("constexpr int kR1Rows = 8;", "constexpr int kR1Rows = 32;")]],
        "y_unrolled": [[("#pragma unroll 1\n" + _ST_R1_Y, _ST_R1_Y)]],
        "bounds_4": [[("__launch_bounds__(kThreads, 3)\nstencil_r1_kernel",
                       "__launch_bounds__(kThreads, 4)\nstencil_r1_kernel")]],
        "bounds_1": [[("__launch_bounds__(kThreads, 3)\nstencil_r1_kernel",
                       "__launch_bounds__(kThreads)\nstencil_r1_kernel")]],
    }),
    "stencil_mc": (("csrc/stencil_mc.cuh", "csrc/stencil_mc.cu"), {
        "full": [[]],
        # the run forms: no rows of terms and no stores; the window copies
        # (bf16's beside the rows of each channel) stay
        "load_only": [[(_MC_RUN_DY, _MC_RUN_DY.replace("dy < KH", "dy < 0")), *_MC_RUN_NO_STORE,
                       (_SM_LOADED, _SM_LOADED + "  if (n > 0) return;\n", _MC_GENERAL)],
                      [(_SM_LOADED, _SM_LOADED + "  if (n > 0) return;\n")]],
        # the run forms: one row of channel 0, its first dx
        "one_term": [[(_MC_RUN_DY, _MC_RUN_DY.replace("dy < KH", "dy < (c == 0)")),
                      (_MC_RUN_DX, _MC_RUN_DX.replace("dx < KW", "dx < 1")),
                      (_SM_RANGE, _SM_RANGE.replace("start_t[o + 1]", "min(start_t[o + 1], k0 + 1)"),
                       _MC_GENERAL)],
                     [(_SM_RANGE, _SM_RANGE.replace("start_t[o + 1]", "min(start_t[o + 1], k0 + 1)"))]],
        # the general form's source only: a per-term read that no compiler
        # can hoist, at the pixel itself
        "no_offset": [[(_SM_TAP, "if (in_shared) return base[k & 0x40000000];")]],
        # Design choices of the run forms: the f32 window's copies skipped,
        # or the outputs' staging and stores (what they cost the full
        # kernel, whose terms still run); f32 copied through registers, as
        # bf16 is, not by cp.async; four or sixteen outputs a thread (tiles
        # of 32 x 32 and 32 x 128); the row loop unrolled twice; the window
        # rows read from global memory (_MC_GLOBAL_ROWS).
        "no_load": [[(_MC_RUN_COPY, _MC_RUN_COPY.replace("ch < kMcMaxC", "ch < 0"))]],
        "no_store": [_MC_RUN_NO_STORE],
        "sync_copy": [[(_MC_RUN_ASYNC, _MC_RUN_ASYNC.replace("std::is_same_v<T, float>", "false"))]],
        "outputs_4": [[("constexpr int kMcRun = 8;", "constexpr int kMcRun = 4;"),
                       ("STENCIL_MC_RUN = 8\n", "STENCIL_MC_RUN = 4\n", "kernels/cuda_ops.py")]],
        "outputs_16": [[("constexpr int kMcRun = 8;", "constexpr int kMcRun = 16;"),
                        ("STENCIL_MC_RUN = 8\n", "STENCIL_MC_RUN = 16\n", "kernels/cuda_ops.py")]],
        "dy_unroll": [[("#pragma unroll 1\n" + _MC_RUN_DY, "#pragma unroll 2\n" + _MC_RUN_DY)]],
        "global_rows": [_MC_GLOBAL_ROWS],
    }),
}
MC_GRAPHS = (("demo", "DEMO_CONFIG", "rgba32f"), ("demo", "DEMO_CONFIG", "rgba16f"),
             ("chain3", "CHAIN3_CONFIG", "rgba32f"), ("edges", "EDGES_CONFIG", "rgba32f"))
# Rows whose outputs the A/B compares between its two sides.
COMPARED = ("graph_strip", "sep_conv", "conv1d", "stencil_apply", "stencil_reduce_mc", "frame")


def _stencil_mc_rows(x):
    """[(label, input, LinearStencilOp)] of stencil_apply_mc's rows: tables
    from a seed, four input channels of the 4K frame ``x`` (f32, bf16),
    dense at radius 2, half the terms of it zero, C_out 3 at radii (2, 3),
    radius 1; six channels (more than any compiled run form takes), and
    radius 24 on a 960x540 crop, where no shared-memory tile holds the
    window (the global-memory form)."""
    import numpy as np
    import torch

    from .kernels import cuda_ops

    rng = np.random.default_rng(1)

    def table(c_out, c_in, rh, rw, density=1.0):
        w = rng.standard_normal((c_out, c_in, 2 * rh + 1, 2 * rw + 1)).astype(np.float32)
        w[rng.random(w.shape) >= density] = 0.0
        return cuda_ops.LinearStencilOp(w)

    dense = table(4, 4, 2, 2)
    six = torch.cat([x, x[:2]]).contiguous()
    crop = x[:, :540, :960].contiguous()
    return [("4->4 r2 f32", x, dense), ("4->4 r2 bf16", x.to(torch.bfloat16), dense),
            ("4->4 r2 f32 half the terms", x, table(4, 4, 2, 2, 0.5)),
            ("4->3 r2,3 f32", x, table(3, 4, 2, 3)), ("4->4 r1 f32", x, table(4, 4, 1, 1)),
            ("6->3 r2 f32", six, table(3, 6, 2, 2)),
            ("4->3 r24 f32 960x540", crop, table(3, 4, 24, 24))]


def _point_rows(x):
    """[(label, fn)] of graph_strip_mc on the mc plans of path J's graphs
    (``benchmarks.point_graphs()`` and chip_smoke.py's op probe; the plan
    the tier rule refuses, or a segment child's, where the graph has no
    whole mc plan) in three formats, and on path K's point shader reading
    its row after a gaussian, on a slab of 600 rows at image row 528."""
    import os
    import tempfile

    import chip_smoke
    from . import benchmarks
    from .kernels import cuda_ops

    tmp = tempfile.mkdtemp(prefix="rf_ablation_")
    for name, text in (("probe", chip_smoke.OP_PROBE), ("ys", chip_smoke.K_YSHADE)):
        os.makedirs(os.path.join(tmp, name))
        with open(os.path.join(tmp, name, f"{name}.comp"), "w") as f:
            f.write(text)
    graphs = dict(benchmarks.point_graphs(),
                  op_probe=(chip_smoke.OP_PROBE_GRAPH, os.path.join(tmp, "probe")))
    rows = []
    for name, (config, shaders) in graphs.items():
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            prog = benchmarks.build_program(config, 3840, 2160, fmt, shader_path=shaders)
            rows.append((f"graph_strip_mc J {name} {fmt}",
                         lambda m=chip_smoke._mc_of(prog), v=x.to(prog.storage_dtype):
                         cuda_ops.graph_strip_mc(v, 0.5, m)))
    # The loop graphs' whole frames, on each side's own plan (a parent
    # without loop regions runs the shader per node, after a segment):
    # their configs and shaders as this checkout wrote them into the copy.
    loops = json.loads(pathlib.Path("loop_graphs.json").read_text())
    for name, (config, shaders) in loops.items():
        for fmt in ("rgba32f", "rgba16f", "rgba8"):
            prog = benchmarks.build_program(config, 3840, 2160, fmt, shader_path=shaders)
            rows.append((f"frame J {name} {fmt}",
                         lambda p=prog, v=x.to(prog.storage_dtype): p._forward(v, 0.5)))
    config = "input -> gs -> ys -> output\ngs: gaussian { sigma: 1.5 }\n"
    for fmt in ("rgba32f", "rgba16f", "rgba8"):
        prog = benchmarks.build_program(config, 3840, 2160, fmt,
                                        shader_path=os.path.join(tmp, "ys"))
        slab = x[:, 528:1128].to(prog.storage_dtype).contiguous()
        rows.append((f"graph_strip_mc K yshade slab row0 528 {fmt}",
                     lambda m=prog._strip_plan[1], v=slab: cuda_ops.graph_strip_mc(v, 0.5, m, 528)))
    return rows


def _apply(package: pathlib.Path, source: pathlib.Path, alternatives: list) -> bool:
    """Apply the first alternative whose anchors all occur once in their
    files (``source``, or a file of ``package``); False where none does."""
    for edits in alternatives:
        paths = [package / e[2] if len(e) > 2 else source for e in edits]
        texts = {path: path.read_text() for path in paths}
        if all(texts[path].count(e[0]) == 1 for path, e in zip(paths, edits)):
            for path, e in zip(paths, edits):
                texts[path] = texts[path].replace(e[0], e[1])
            for path, text in texts.items():
                path.write_text(text)
            return True
    return False


def _copy(label: str, package: pathlib.Path, kernel: str = "",
          variant: str = "full") -> Optional[pathlib.Path]:
    """A copy of ``package`` with ``variant``'s edits, or None where none
    of its alternatives applies to that package's source."""
    root = OUT / label
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(package, root / PACKAGE.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(__file__, root / PACKAGE.name / "mc_ablation.py")
    # the shipped shaders, where the copy's benchmarks.SHADER_DIR looks (glsl-blur),
    # the examples (point_graphs' blur_sharpen_blend) and chip_smoke.py's
    # shaders (the J and K rows)
    shutil.copytree(PACKAGE.parent / "shaders", root / "shaders")
    shutil.copytree(PACKAGE.parent / "examples", root / "examples")
    shutil.copy(PACKAGE.parent / "chip_smoke.py", root / "chip_smoke.py")
    # this checkout's loop graphs and the port's shaders they read, for a
    # package that lacks them (the J frame rows)
    from . import benchmarks

    shutil.copytree(PACKAGE / "shaders", root / "port_shaders")
    loops = {name: (benchmarks.point_graphs()[name][0],
                    "shaders" if benchmarks.point_graphs()[name][1] == benchmarks.SHADER_DIR
                    else "port_shaders") for name in benchmarks.LOOP_GRAPHS}
    (root / "loop_graphs.json").write_text(json.dumps(loops))
    if kernel and variant != "full":
        sources, variants = KERNELS[kernel]
        path = next(p for p in (root / PACKAGE.name / s for s in sources) if p.exists())
        if not _apply(root / PACKAGE.name, path, variants[variant]):
            shutil.rmtree(root)
            return None
    return root


def _rows(which: str, tiles: dict):
    """[(name, fn)] of the rows to time: ``fn()`` launches one kernel and
    returns its output(s).  ``tiles`` gets each mc row's tile and window buffers; a graph
    that plans no mc tier (a forced tile no layout fits) has no row."""
    import numpy as np
    import torch

    from . import benchmarks
    from .kernels import cuda_ops, library
    from .kernels.ops import box_weights, gaussian_weights, luma

    x = torch.from_numpy(np.random.default_rng(0).random((4, 2160, 3840), dtype=np.float32)).cuda()
    xb = x.to(torch.bfloat16)
    rows = []
    if which in ("strip", "ab"):
        for fmt in ("rgba32f", "rgba16f"):
            prog = benchmarks.build_flagship(3840, 2160, fmt)
            strip = prog._build_strip_program()
            xin = x.to(prog.storage_dtype)
            rows.append((f"graph_strip flagship {fmt}",
                         lambda s=strip, v=xin: cuda_ops.graph_strip(v, 0.5, s)))
    if which in ("sep", "ab"):
        w2, w4, w8 = gaussian_weights(2.0), gaussian_weights(4.0), gaussian_weights(8.0)
        rows += [
            ("sep_conv_fused r12", lambda: cuda_ops.sep_conv_fused(x, w4, w4)),
            ("sep_conv_fused_multi r6+12",
             lambda: cuda_ops.sep_conv_fused_multi(x, [(w2, w2), (w4, w4)])),
            ("sep_conv_fused_mxu r12 bf16", lambda: cuda_ops.sep_conv_fused_mxu(xb, w4, w4)),
            ("sep_conv_fused_mxu_x3 r24", lambda: cuda_ops.sep_conv_fused_mxu_x3(x, w8, w8)),
        ]
    if which in ("mc", "ab"):
        graphs = [(n, getattr(benchmarks, c), f, None) for n, c, f in MC_GRAPHS]
        graphs.append(("neon_edges", benchmarks.LIBRARY_GRAPHS["neon_edges"], "rgba32f", None))
        graphs += [(name, benchmarks.GLSL_GRAPHS[name], fmt, benchmarks.SHADER_DIR)
                   for name in ("glsl_blur", "glsl_blur_sharpen", "glsl_chain")
                   for fmt in ("rgba32f", "rgba16f")]
        if which == "mc":
            # the loop graphs: a thread's pixels run a loop as many rounds
            # as the slowest of them (one_pixel, two_pixels, four_pixels)
            graphs += [(name, *benchmarks.point_graphs()[name][:1], "rgba32f",
                        benchmarks.point_graphs()[name][1])
                       for name in ("glsl_sharpen", "tonemap_sharpen", "blur_sharpen_blend",
                                    "zero_border", *getattr(benchmarks, "LOOP_GRAPHS", ()))]
        for name, config, fmt, shaders in graphs:
            prog = benchmarks.build_program(config, 3840, 2160, fmt, shader_path=shaders)
            if prog._strip_plan is None or prog._strip_plan[0] != "mc":
                continue
            mc = prog._strip_plan[1]
            xin = x.to(prog.storage_dtype)
            # the tile, and its window buffers where the source has them
            geometry = getattr(mc, "geometry", None)
            tiles[f"graph_strip_mc {name} {fmt}"] = [*mc.tile()[:2]] + (
                [int(v) for v in geometry(*mc.tile()[:2])[7:9]] if geometry else [])
            rows.append((f"graph_strip_mc {name} {fmt}",
                         lambda m=mc, v=xin: cuda_ops.graph_strip_mc(v, 0.5, m)))
    if which == "ab":
        # Whole frames of the builtins' mc graphs (the program's dispatch
        # and its one kernel), as chip_smoke.py times their frames.
        for name, config, fmt in MC_GRAPHS:
            prog = benchmarks.build_program(getattr(benchmarks, config), 3840, 2160, fmt)
            rows.append((f"frame {name} {fmt}",
                         lambda p=prog, v=x.to(prog.storage_dtype): p._forward(v, 0.5)))
        rows += _point_rows(x)
    if which in ("stencil", "ab"):
        y = luma(x)[None].contiguous()
        stencils = (("sharpen", x, cuda_ops.wsum(library.SHARPEN_TAPS)),
                    ("median9", x, cuda_ops.MEDIAN9),
                    ("sobel_x 1ch", y, cuda_ops.wsum(library.SOBEL_X_TAPS)))
        rows += [(f"stencil_apply {label}", lambda v=v, op=op: cuda_ops.stencil_apply(v, 1, 1, op))
                 for label, v, op in stencils]
    if which in ("reduce", "ab"):
        stack = torch.cat([x[:3], luma(x)[None]]).contiguous()
        for r, sigma_space in ((4, 2.5), (3, 2.5), (60, 8.0)):
            rr, op = library.bilateral_op(r, sigma_space, 0.12)
            rows.append((f"stencil_reduce_mc bilateral r{r}",
                         lambda rr=rr, op=op: cuda_ops.stencil_reduce_mc(stack, rr, rr, op)))
    if which in ("stencil_mc", "ab"):
        rows += [(f"stencil_apply_mc {label}", lambda v=v, op=op: cuda_ops.stencil_apply_mc(v, op))
                 for label, v, op in _stencil_mc_rows(x)]
    if which in ("conv1d", "ab"):
        vectors = {"r160": box_weights(160), "r400": box_weights(400),
                   "gaussian r160": gaussian_weights(160 / 3.0, 160)}
        for label, w in vectors.items():
            rows += [(f"conv1d_h {label}", lambda w=w: cuda_ops.conv1d_h(x, w)),
                     (f"conv1d_w {label}", lambda w=w: cuda_ops.conv1d_w(x, w))]
    return rows


def _time(label: str, which: str, tile: str, save: str) -> None:
    """Time each row with the package in the working directory; with
    ``save``, write the compared rows' outputs there."""
    import torch

    from .kernels import cuda_ops

    if tile:
        cuda_ops.MC_TILES = (tuple(int(v) for v in tile.split("x")),)
        cuda_ops.MC_SMEM_SOFT = cuda_ops.MC_SMEM_LIMIT
    row, outs, tiles = {}, {}, {}
    for name, fn in _rows(which, tiles):
        for _ in range(3):
            out = fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        row[name] = start.elapsed_time(end) / 20
        if save and name.startswith(COMPARED):
            outs[name] = (torch.stack(out) if isinstance(out, list) else out).cpu()
        del out
    if save:
        torch.save(outs, save)
    # ptxas's registers and stack of each kernel form
    log = (cuda_ops.BUILD_DIR / "build.log").read_text().splitlines()
    ptxas = {}
    for i, line in enumerate(log):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            props = [v.split(":", 1)[-1].strip() for v in log[i + 1:i + 4]
                     if "registers" in v or "stack frame" in v]
            ptxas[name] = "; ".join(props)
    print(json.dumps({"variant": label, "kernel_ms": row, "tiles": tiles, "ptxas": ptxas}))


def _run(root: pathlib.Path, label: str, which: str, tile: str = "", save: str = "") -> dict:
    proc = subprocess.run([sys.executable, "-m", f"{PACKAGE.name}.mc_ablation", "--time", label,
                           which, tile, save], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(proc.returncode)
    line = proc.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    shown = {k: v for k, v in result.items() if k != "ptxas"}
    shown["ptxas"] = {k: v for k, v in result["ptxas"].items()
                      if any(s in k for s in ("graph_strip_kernel", "sep_conv_multi_kernel",
                                              "graph_strip_mc_kernel", "conv1d_kernel",
                                              "stencil_kernel", "stencil_r1", "stencil_reduce",
                                              "stencil_mc"))}
    print(json.dumps(shown))
    return result


def _ab(parent: pathlib.Path) -> None:
    import torch

    roots = {"parent": _copy("parent", parent), "this": _copy("this", PACKAGE)}
    saved = {side: str(OUT / f"{side}.pt") for side in roots}
    for i, side in enumerate(("parent", "this", "this", "parent")):
        _run(roots[side], f"{side} ({i + 1} of 4)", "ab", save=saved[side] if i < 2 else "")
    a, b = (torch.load(saved[side]) for side in ("parent", "this"))
    diffs = {name: float((a[name].float() - b[name].float()).abs().max()) for name in a if name in b}
    print(json.dumps({"max_abs_diff_parent_vs_this": diffs}))


def _sass(pattern: str) -> None:
    """Build this package's kernels and print, for each kernel whose
    mangled name contains ``pattern``, its SASS instructions (cuobjdump
    -sass of the built library, NOPs not counted), its MUFU.EX2 count, its
    opcodes by count, and those of its hottest loop: the span from a
    backward branch's target to the branch that holds the most FMULs
    (the shortest of those)."""
    import re
    from collections import Counter

    from .kernels import cuda_ops

    lib = cuda_ops.build_library()
    cuobjdump = str(pathlib.Path(cuda_ops._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    code: dict[str, list] = {}  # kernel -> [(address, opcode, text)]
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            fn = fn if pattern in fn else None
            if fn:
                code[fn] = []
        elif fn and line.strip().startswith("/*") and "*/" in line:
            addr, text = line.strip()[2:].split("*/", 1)
            text = text.strip().lstrip("{").strip()
            if text and not text.startswith("/*"):
                op = text.split()[1 if text.startswith("@") else 0].rstrip(";")
                if op != "NOP":
                    code[fn].append((int(addr, 16), op, text))
    for name, ins in code.items():
        counts = Counter(op for _, op, _ in ins)
        loops = []
        for addr, op, text in ins:
            m = re.search(r"BRA\s+(0x[0-9a-f]+)", text) if op == "BRA" else None
            if m and int(m.group(1), 16) < addr:
                body = Counter(o for a, o, _ in ins if int(m.group(1), 16) <= a <= addr)
                loops.append((-body.get("FMUL", 0), sum(body.values()), body))
        loop = min(loops, key=lambda t: t[:2])[2] if loops else Counter()
        print(json.dumps({"kernel": name, "instructions": sum(counts.values()),
                          "MUFU.EX2": counts.get("MUFU.EX2", 0),
                          "opcodes": dict(counts.most_common()),
                          "loop_instructions": sum(loop.values()),
                          "loop_opcodes": dict(loop.most_common())}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="mc", choices=sorted(KERNELS))
    ap.add_argument("--tiles", default="", help="mc: comma-separated tiles to force, e.g. 16x64")
    ap.add_argument("--package", default="", help="ablate another checkout's package")
    ap.add_argument("--variants", default="", help="comma-separated variants to run (default: all)")
    ap.add_argument("--parent", default="", help="the package directory of another checkout: A/B")
    ap.add_argument("--sass", default="", metavar="NAME",
                    help="print the SASS opcode counts of the kernels whose name contains NAME")
    ap.add_argument("--time", nargs=4, metavar=("LABEL", "ROWS", "TILE", "SAVE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        _time(*args.time)
        return 0
    if args.sass:
        _sass(args.sass)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    if args.parent:
        _ab(pathlib.Path(args.parent).resolve())
        return 0
    package = pathlib.Path(args.package).resolve() if args.package else PACKAGE
    variants = [v for v in KERNELS[args.kernel][1]
                if not args.variants or v == "full" or v in args.variants.split(",")]
    roots = {v: _copy(f"{args.kernel}_{v}", package, args.kernel, v) for v in variants}
    for v in [v for v, root in roots.items() if root is None]:
        print(f"{args.kernel} {v}: skipped, its anchors are not in this source")
        del roots[v]
    runs = [(v, "") for v in roots]
    if args.kernel == "mc":
        runs += [("full", t) for t in args.tiles.split(",") if t]
    runs.append(("full", ""))
    for variant, tile in runs:
        _run(roots[variant], f"{args.kernel} {variant}" + (f" tile {tile}" if tile else ""),
             args.kernel, tile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
