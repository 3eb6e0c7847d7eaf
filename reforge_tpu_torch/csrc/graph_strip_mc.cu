// graph_strip_mc: a whole multi-stage graph (the mc tier) in one pass.
//
// Replaces pallas_ops.graph_strip_fused_mc / _graph_strip_kernel_mc.  The
// TPU kernel streamed channel-full whole-width strips through VMEM with a
// DMA double buffer, carried conv rows from strip to strip and ran heavy
// convs as MXU band matmuls.  None of that carries over: here a block owns
// one (TH x TW) output tile with all four channels.
//
//   * The input tile plus the plan's input extent (rh_in rows, ew_in
//     columns each side) loads once into shared memory with clamped reads
//     (cp.async for f32).
//   * Stages run in topological order.  Each computes its output over the
//     tile plus its own extent (eh, ew) -- what its consumers read around
//     the tile -- into a shared-memory pool slot, or, for the final node,
//     straight to device memory:
//       conv:    H pass into a shared scratch buffer, then the W pass,
//                then an epilogue (identity, unsharp, bloom add) that may
//                read the stage's x source.  In blocks whose taps all lie
//                in the image a thread computes kRun outputs along the
//                pass from a sliding register window, and the H pass of
//                one channel runs beside the W pass of the one before (two
//                scratch halves).
//       stencil: sharpen, sobel (luma of each tap), emboss, median9;
//                unclamped reads in blocks whose taps all lie in the image.
//       point:   channel-full ops of one or two inputs at a pixel (a 3x3
//                colour matrix, or a fifth param, comes as tap list 0), and
//                a GLSL shader's affine mix s_c v_c + p_c x_c + b_c of the
//                conv or stencil stage before it (v, f32) and that stage's
//                input (x); its twelve floats come as tap list 0.
//   * Border semantics.  Per-node execution edge-pads every intermediate.
//     Every read here goes through the clamped global coordinate, and a
//     stage computes only the pixels of its block that lie in the image:
//     the clamped position of any pixel a consumer reads lies in the
//     producer's block, so no stage computes a value outside the image
//     and vignette's coordinates are always those of a real pixel.
//   * Storage rounding.  Each node's output rounds to storage (bf16 RNE
//     or the rgba8 grid, pixel_ops.cuh store_round) as per-node
//     execution stores it; a bloom pre-map (store == 0) stays f32.
//
// The stage list arrives by value (a __grid_constant__ parameter) and is
// copied to shared memory.  Point and stencil arithmetic rounds each
// operation (__fmul_rn/__fadd_rn) as the plain PyTorch version does; the
// conv tap loops use FMAs.  fminf/fmaxf drop a NaN where torch.minimum
// propagates it; images are finite.
//
// Grid: (ceil(W / TW), ceil(H / TH)).

#include <cuda_pipeline.h>

#include <type_traits>

#include "conv_tile.cuh"
#include "pixel_ops.cuh"

namespace rf {

constexpr int kMcMaxStages = 24;
constexpr int kMcStageInts = 22;

enum McKind : int { MC_POINT = 0, MC_STENCIL = 1, MC_CONV = 2 };

enum McOp : int {
  MC_COPY = 0,         // in0
  MC_MIX = 1,          // in0 + (in1 - in0) * p0, all channels
  MC_ACES = 2,         // rgb: ACES filmic of in0 * p0
  MC_REINHARD = 3,     // rgb: Reinhard of in0 * p0
  MC_VIGNETTE = 4,     // rgb: in0 * radial fade (p0 strength, p1 radius, p2 1.42 - radius)
  MC_GRAYSCALE = 5,    // rgb: luma(in0)
  MC_SATURATION = 6,   // rgb: y + (in0 - y) * p0
  MC_THRESHOLD = 7,    // rgb: luma(in0) > p0
  MC_BLOOM_PRE = 8,    // rgb: in0 * smoothstep(p0, p0 + p1, luma)
  MC_CH0 = 9,          // MC_CH0 + k: rgb: channel op k (pixel_ops.cuh); levels' p4 in list 0
  MC_SEPIA = MC_CH0 + CH_COUNT,  // rgb: in0 + (clip01(sepia . in0) - in0) * p0
  MC_HUE_SAT = MC_SEPIA + 1,     // rgb: hue matrix (list 0, 3x3), saturation p0, lightness p1
  MC_AFFINE = MC_HUE_SAT + 1,    // all channels: s_c in0 + p_c in1 + b_c (list 0, rows c)
  MC_CONV_IDENTITY = 32,
  MC_CONV_UNSHARP = 33,  // rgb: x + p0 * (x - blur)
  MC_CONV_BLOOM = 34,    // rgb: x + p0 * blur
  MC_SHARPEN = 48,     // rgb: x + p0 * wsum(list 0)
  MC_SOBEL = 49,       // rgb: sqrt(gx^2 + gy^2) * p0 over luma
  MC_EMBOSS = 50,      // rgb: wsum(list 0)
  MC_MEDIAN3 = 51,     // rgb: median9
};

// A buffer in shared memory: float offset of channel 0 (-1: none) and the
// extent it covers around the tile.  Its layout is (4, TH + 2eh, pitch),
// the pitch TW + 2ew rounded up to odd so that threads on consecutive
// rows of one column hit distinct banks (cuda_ops.McProgram._layout).
struct McBuf {
  int off, eh, ew;
};

__device__ __forceinline__ int pitch(int cols) { return cols | 1; }

// Outputs a thread computes along the pass in interior conv blocks.
constexpr int kRun = 8;

// One stage; the int fields in the order of cuda_ops.McProgram.packed.
struct McStage {
  int kind, code, n_in;
  McBuf in0, in1, xs;
  int out_off;  // -1: the kernel output
  int eh, ew;   // output extent
  int rh, rw;   // conv radii, or the stencil radius twice
  int t0, n0, t1, n1;  // tap lists: offsets into the taps and their lengths
  int store;    // round to storage
  float p[4];
};

struct McArgs {
  int n_stages, scratch_off, taps_off, n_taps;
  McStage st[kMcMaxStages];
};

struct McGeo {
  int H, W, TH, TW, y0, x0;
};

// Channel c of buffer b at image pixel (gy, gx), clamped to the image
// (kClamp false: the caller knows the pixel lies in the image).
template <bool kClamp = true>
__device__ __forceinline__ float rd(const float* sm, const McBuf& b, const McGeo& g, int c, int gy,
                                    int gx) {
  const int cols = pitch(g.TW + 2 * b.ew);
  const int rows = g.TH + 2 * b.eh;
  if (kClamp) {
    gy = min(max(gy, 0), g.H - 1);
    gx = min(max(gx, 0), g.W - 1);
  }
  return sm[b.off + (c * rows + gy - (g.y0 - b.eh)) * cols + gx - (g.x0 - b.ew)];
}

// A 3x3 table of list 0 (its nonzero terms at dy * 64 + dx) as a dense
// row-major matrix.
__device__ __forceinline__ void dense3x3(const McStage& st, const float* taps, const int* idx,
                                         float* m) {
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = 0.f;
  for (int k = 0; k < st.n0; ++k) m[(idx[st.t0 + k] >> 6) * 3 + (idx[st.t0 + k] & 63)] = taps[st.t0 + k];
}

// rows of m (row-major 3x3) applied to a[0..2], each r m0 + g m1 + b m2.
__device__ __forceinline__ void matrix_rgb(const float* m, const float* a, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = __fadd_rn(__fadd_rn(__fmul_rn(a[0], m[3 * i]), __fmul_rn(a[1], m[3 * i + 1])),
                       __fmul_rn(a[2], m[3 * i + 2]));
}

// The point ops of the channel-local and colour-matrix builtins (opcodes
// from MC_CH0): colour channels of the output from in0 (a) and in1 (b).  A
// call, with its inputs by value: inlined into point_op they moved nvcc's
// allocation of the whole kernel and cost the demo's mc kernel 1.5% on the
// card (PERF.md).
__device__ __noinline__ float3 point_op_colour(const McStage& st, float4 a4, float4 b4,
                                               const float* taps, const int* idx, int gy, int gx) {
  const float a[3] = {a4.x, a4.y, a4.z}, b[3] = {b4.x, b4.y, b4.z};
  const float* p = st.p;
  float o[3];
  if (st.code < MC_CH0 + CH_COUNT) {
    // levels' fifth param is the one term of list 0 (none: zero)
    const float q[5] = {p[0], p[1], p[2], p[3], st.n0 > 0 ? taps[st.t0] : 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = channel_op(st.code - MC_CH0, c, a[c], b[c], q, gy, gx);
  } else if (st.code == MC_SEPIA) {
    // cuda_ops.SEPIA_MATRIX
    const float m[9] = {0.393f, 0.769f, 0.189f, 0.349f, 0.686f, 0.168f, 0.272f, 0.534f, 0.131f};
    float t[3];
    matrix_rgb(m, a, t);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = __fadd_rn(a[c], __fmul_rn(__fsub_rn(clip01(t[c]), a[c]), p[0]));
  } else if (st.code == MC_HUE_SAT) {
    float m[9], t[3];
    dense3x3(st, taps, idx, m);
    matrix_rgb(m, a, t);
    const float y = luma(t[0], t[1], t[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c] = __fadd_rn(__fadd_rn(y, __fmul_rn(__fsub_rn(t[c], y), p[0])), p[1]);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = __int_as_float(0x7fc00000);  // unknown opcode: NaN
  }
  return make_float3(o[0], o[1], o[2]);
}

// A synthesized GLSL stage's mix, channel by channel: s v, plus p x where
// p != 0, plus b where b != 0 (cuda_ops.affine_mix_plain); (s, p, b) of
// channel c are row c of list 0.  A call, compiled only into the kernel's
// kAffine form: built into the builtins' form as well (a branch in
// point_op), it cost the demo's mc kernel 3% on the card at the same
// register count (PERF.md).
__device__ __noinline__ float4 point_op_affine(const McStage& st, float4 v4, float4 x4,
                                               const float* taps, const int* idx) {
  float a[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) a[k] = 0.f;
  for (int k = 0; k < st.n0; ++k) a[(idx[st.t0 + k] >> 6) * 3 + (idx[st.t0 + k] & 63)] = taps[st.t0 + k];
  const float v[4] = {v4.x, v4.y, v4.z, v4.w}, x[4] = {x4.x, x4.y, x4.z, x4.w};
  float o[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    o[c] = __fmul_rn(v[c], a[3 * c]);
    if (a[3 * c + 1] != 0.f) o[c] = __fadd_rn(o[c], __fmul_rn(x[c], a[3 * c + 1]));
    if (a[3 * c + 2] != 0.f) o[c] = __fadd_rn(o[c], a[3 * c + 2]);
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

template <bool kAffine>
__device__ void point_op(const McStage& st, const float* a, const float* b, const float* taps,
                         const int* idx, const McGeo& g, int gy, int gx, float* o) {
  const float* p = st.p;
  o[3] = a[3];
  if (st.code >= MC_CH0) {
    if constexpr (kAffine) {
      if (st.code == MC_AFFINE) {
        const float4 v = point_op_affine(st, make_float4(a[0], a[1], a[2], a[3]),
                                         make_float4(b[0], b[1], b[2], b[3]), taps, idx);
        o[0] = v.x;
        o[1] = v.y;
        o[2] = v.z;
        o[3] = v.w;
        return;
      }
    }
    const float3 v = point_op_colour(st, make_float4(a[0], a[1], a[2], a[3]),
                                     make_float4(b[0], b[1], b[2], b[3]), taps, idx, gy, gx);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    return;
  }
  switch (st.code) {
    case MC_COPY:
      for (int c = 0; c < 3; ++c) o[c] = a[c];
      return;
    case MC_MIX:
      for (int c = 0; c < 4; ++c) o[c] = __fadd_rn(a[c], __fmul_rn(__fsub_rn(b[c], a[c]), p[0]));
      return;
    case MC_ACES:
      for (int c = 0; c < 3; ++c) {
        const float v = __fmul_rn(a[c], p[0]);
        const float num = __fmul_rn(v, __fadd_rn(__fmul_rn(2.51f, v), 0.03f));
        const float den = __fadd_rn(__fmul_rn(v, __fadd_rn(__fmul_rn(2.43f, v), 0.59f)), 0.14f);
        o[c] = clip01(__fdiv_rn(num, den));
      }
      return;
    case MC_REINHARD:
      for (int c = 0; c < 3; ++c) {
        const float v = __fmul_rn(a[c], p[0]);
        o[c] = __fdiv_rn(v, __fadd_rn(1.f, v));
      }
      return;
    case MC_VIGNETTE: {
      const float ny = __fsub_rn(__fmul_rn(__fdiv_rn((float)gy, (float)max(g.H - 1, 1)), 2.f), 1.f);
      const float nx = __fsub_rn(__fmul_rn(__fdiv_rn((float)gx, (float)max(g.W - 1, 1)), 2.f), 1.f);
      const float d = __fsqrt_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)));
      const float fade = __fsub_rn(1.f, __fmul_rn(p[0], smoothstep(p[1], p[2], d)));
      for (int c = 0; c < 3; ++c) o[c] = __fmul_rn(a[c], fade);
      return;
    }
    case MC_GRAYSCALE: {
      const float y = luma(a[0], a[1], a[2]);
      for (int c = 0; c < 3; ++c) o[c] = y;
      return;
    }
    case MC_SATURATION: {
      const float y = luma(a[0], a[1], a[2]);
      for (int c = 0; c < 3; ++c) o[c] = __fadd_rn(y, __fmul_rn(__fsub_rn(a[c], y), p[0]));
      return;
    }
    case MC_THRESHOLD: {
      const float m = luma(a[0], a[1], a[2]) > p[0] ? 1.f : 0.f;
      for (int c = 0; c < 3; ++c) o[c] = m;
      return;
    }
    case MC_BLOOM_PRE: {
      const float m = smoothstep(p[0], p[1], luma(a[0], a[1], a[2]));
      for (int c = 0; c < 3; ++c) o[c] = __fmul_rn(a[c], m);
      return;
    }
  }
  for (int c = 0; c < 4; ++c) o[c] = __int_as_float(0x7fc00000);  // unknown opcode: NaN
}

__device__ __forceinline__ float conv_epilogue(int code, int c, float blur, float x, const float* p) {
  switch (code) {
    case MC_CONV_IDENTITY: return blur;
    case MC_CONV_UNSHARP: return c < 3 ? __fadd_rn(x, __fmul_rn(p[0], __fsub_rn(x, blur))) : x;
    case MC_CONV_BLOOM: return c < 3 ? __fadd_rn(x, __fmul_rn(p[0], blur)) : x;
  }
  return __int_as_float(0x7fc00000);
}

// kClamp false: every tap of this pixel lies in the image.
template <bool kClamp>
__device__ void stencil_op(const McStage& st, const float* sm, const float* taps, const int* idx,
                           const McGeo& g, int gy, int gx, float* o) {
  const int r = st.rh;
  const McBuf in = st.in0;
  // Channel c of term position pos (dy * 64 + dx) around (gy, gx).
  auto at = [&](int c, int pos) {
    return rd<kClamp>(sm, in, g, c, gy + (pos >> 6) - r, gx + (pos & 63) - r);
  };
  o[3] = rd<false>(sm, in, g, 3, gy, gx);
  switch (st.code) {
    case MC_SHARPEN:
    case MC_EMBOSS:
      for (int c = 0; c < 3; ++c) {
        const float centre = rd<false>(sm, in, g, c, gy, gx);
        const float s = wsum_ordered(
            [&](int k) { return k < 0 ? centre : at(c, idx[st.t0 + k]); }, taps + st.t0, st.n0);
        o[c] = st.code == MC_EMBOSS ? s : __fadd_rn(centre, __fmul_rn(st.p[0], s));
      }
      return;
    case MC_SOBEL: {
      auto y = [&](int pos) { return luma(at(0, pos), at(1, pos), at(2, pos)); };
      const int ctr = r * 64 + r;
      const float gxs = wsum_ordered([&](int k) { return y(k < 0 ? ctr : idx[st.t0 + k]); },
                                     taps + st.t0, st.n0);
      const float gys = wsum_ordered([&](int k) { return y(k < 0 ? ctr : idx[st.t1 + k]); },
                                     taps + st.t1, st.n1);
      const float mag =
          __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(gxs, gxs), __fmul_rn(gys, gys))), st.p[0]);
      for (int c = 0; c < 3; ++c) o[c] = mag;
      return;
    }
    case MC_MEDIAN3:
      for (int c = 0; c < 3; ++c) {
        float m[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) m[k] = rd<kClamp>(sm, in, g, c, gy + k / 3 - 1, gx + k % 3 - 1);
        o[c] = median9(m);
      }
      return;
  }
  for (int c = 0; c < 4; ++c) o[c] = __int_as_float(0x7fc00000);
}

// Outputs j < kRun of a 1-D correlation at stride `step`: acc[j] is the
// sum over k < n of src[(j + k) * step] * w[k], accumulated with FMAs in
// ascending k from 0 (the order of the clamped path, so interior and
// border blocks agree bit for bit).  A register window slides over the
// source: each value loads once, and the kRun values and weights of the
// next chunk of taps load before the FMAs of this one.  Reads stop at
// `avail` values; the zeros past it reach only outputs past the run's
// valid end.
__device__ __forceinline__ void conv_run(const float* __restrict__ src, int step, int avail,
                                         const float* __restrict__ w, int n, float* acc) {
  float v[2 * kRun - 1], wc[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) acc[j] = 0.f;
#pragma unroll
  for (int m = 0; m < 2 * kRun - 1; ++m) v[m] = m < avail ? src[m * step] : 0.f;
#pragma unroll
  for (int m = 0; m < kRun; ++m) wc[m] = m < n ? w[m] : 0.f;
  for (int k0 = 0; k0 < n; k0 += kRun) {
    float next[kRun], wn[kRun];
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      const int k = k0 + 2 * kRun - 1 + m;
      next[m] = k < avail ? src[k * step] : 0.f;
      wn[m] = k0 + kRun + m < n ? w[k0 + kRun + m] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kRun; ++kk) {
      if (k0 + kk < n) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) acc[j] = fmaf(v[j + kk], wc[kk], acc[j]);
      }
    }
#pragma unroll
    for (int m = 0; m < kRun - 1; ++m) v[m] = v[m + kRun];
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      v[kRun - 1 + m] = next[m];
      wc[m] = wn[m];
    }
  }
}

template <typename T>
__device__ __forceinline__ void put(const McStage& st, float* sm, T* __restrict__ out,
                                    const McGeo& g, int store, int c, int r, int cc, int gy, int gx,
                                    float v) {
  if (st.store) v = store_round(v, store);
  if (st.out_off < 0) {
    out[(size_t)c * g.H * g.W + (size_t)gy * g.W + gx] = from_f32<T>(v);
  } else {
    const int rows = g.TH + 2 * st.eh, cols = pitch(g.TW + 2 * st.ew);
    sm[st.out_off + (c * rows + r) * cols + cc] = v;
  }
}

// kAffine: the plan has MC_AFFINE stages (GLSL shaders); the builtins'
// plans run the form without them.
template <typename T, bool kAffine>
__global__ void __launch_bounds__(kThreads)
graph_strip_mc_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int TH, int TW,
                      int rh_in, int ew_in, int store, float time,
                      const float* __restrict__ taps_g, const int* __restrict__ idx_g,
                      const __grid_constant__ McArgs args) {
  extern __shared__ float sm[];
  __shared__ McStage stages[kMcMaxStages];
  const McGeo g{H, W, TH, TW, (int)blockIdx.y * TH, (int)blockIdx.x * TW};
  const size_t plane = (size_t)H * W;
  float* scratch = sm + args.scratch_off;
  float* taps = sm + args.taps_off;
  int* idx = reinterpret_cast<int*>(taps + args.n_taps);
  (void)time;  // no op of the ported builtins reads the frame time yet

  {
    const int* src = reinterpret_cast<const int*>(args.st);
    int* dst = reinterpret_cast<int*>(stages);
    const int words = args.n_stages * (int)(sizeof(McStage) / sizeof(int));
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  copy_to_shared(taps_g, args.n_taps, taps);
  for (int i = threadIdx.x; i < args.n_taps; i += blockDim.x) idx[i] = idx_g[i];
  {
    // A warp per row of one channel, lanes along it.  f32 rows copy with
    // cp.async, so a thread has many loads in flight and no registers
    // wait; bf16 values load kBatch to a thread before any converts.
    constexpr int kBatch = 4;
    const int rows = TH + 2 * rh_in, cols = TW + 2 * ew_in, pc = pitch(cols);
    const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
    for (int c = 0; c < 4; ++c) {
#pragma unroll 2
      for (int r = threadIdx.x >> 5; r < rows; r += n_warps) {
        const T* src = x + c * plane + (size_t)min(max(g.y0 - rh_in + r, 0), H - 1) * W;
        float* dst = sm + (c * rows + r) * pc;
        for (int c0 = lane; c0 < cols; c0 += 32 * kBatch) {
          if constexpr (std::is_same_v<T, float>) {
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              const int cc = c0 + 32 * q;
              if (cc < cols)
                __pipeline_memcpy_async(dst + cc, src + min(max(g.x0 - ew_in + cc, 0), W - 1),
                                        sizeof(float));
            }
          } else {
            T v[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              const int cc = c0 + 32 * q;
              if (cc < cols) v[q] = src[min(max(g.x0 - ew_in + cc, 0), W - 1)];
            }
#pragma unroll
            for (int q = 0; q < kBatch; ++q)
              if (c0 + 32 * q < cols) dst[c0 + 32 * q] = to_f32(v[q]);
          }
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  for (int s = 0; s < args.n_stages; ++s) {
    const McStage& st = stages[s];
    const int rows = TH + 2 * st.eh, cols = TW + 2 * st.ew;
    const int by = g.y0 - st.eh, bx = g.x0 - st.ew;  // image pixel of block (0, 0)
    if (st.kind == MC_CONV) {
      const int tcols = cols + 2 * st.rw, tx = bx - st.rw, sp = pitch(tcols);
      const int nh = 2 * st.rh + 1, nw = 2 * st.rw + 1;
      const float* wh = taps + st.t0;
      const float* ww = taps + st.t1;
      auto emit = [&](int c, int r, int cc, float blur) {
        const int gy = by + r, gx = bx + cc;
        const float xv = st.xs.off >= 0 ? rd(sm, st.xs, g, c, gy, gx) : 0.f;
        put<T>(st, sm, out, g, store, c, r, cc, gy, gx, conv_epilogue(st.code, c, blur, xv, st.p));
      };
      if (tx >= 0 && tx + tcols <= W && by - st.rh >= 0 && by + rows + st.rh <= H) {
        // Interior block: every tap lies in the image, so the passes read
        // shared memory at a fixed stride, kRun outputs a thread.  Phase ph
        // runs the H pass of channel ph into scratch half ph & 1 beside the
        // W pass of channel ph - 1 from the other half.
        const int src_rows = TH + 2 * st.in0.eh, src_pitch = pitch(TW + 2 * st.in0.ew);
        const int n_h = (rows + kRun - 1) / kRun * tcols;
        const int n_w = rows * ((cols + kRun - 1) / kRun);
        for (int ph = 0; ph <= 4; ++ph) {
          const int c_h = ph < 4 ? ph : -1, c_w = ph - 1;
          const int items = (c_h >= 0 ? n_h : 0) + (c_w >= 0 ? n_w : 0);
          for (int i = threadIdx.x; i < items; i += blockDim.x) {
            float acc[kRun];
            if (c_h >= 0 && i < n_h) {
              // kRun rows of one column (lanes on consecutive columns)
              const int cc = i % tcols, r0 = i / tcols * kRun, nv = min(kRun, rows - r0);
              // source pixel (by - rh + r0, tx + cc) in the source block
              const float* src = sm + st.in0.off +
                                 (c_h * src_rows + by - st.rh + r0 - (g.y0 - st.in0.eh)) * src_pitch +
                                 tx + cc - (g.x0 - st.in0.ew);
              conv_run(src, src_pitch, nv + nh - 1, wh, nh, acc);
              float* dst = scratch + (c_h & 1) * rows * sp + r0 * sp + cc;
#pragma unroll
              for (int j = 0; j < kRun; ++j)
                if (j < nv) dst[j * sp] = acc[j];
            } else {
              // kRun columns of one row (lanes on consecutive rows)
              const int k = i - (c_h >= 0 ? n_h : 0);
              const int r = k % rows, c0 = k / rows * kRun, nv = min(kRun, cols - c0);
              conv_run(scratch + (c_w & 1) * rows * sp + r * sp + c0, 1, nv + nw - 1, ww, nw, acc);
#pragma unroll
              for (int j = 0; j < kRun; ++j)
                if (j < nv) emit(c_w, r, c0 + j, acc[j]);
            }
          }
          __syncthreads();
        }
        continue;
      }
      // Border block: every tap read goes through the clamped coordinate.
      for (int c = 0; c < 4; ++c) {
        for (int i = threadIdx.x; i < rows * tcols; i += blockDim.x) {
          const int r = i / tcols, cc = i - r * tcols;
          const int gy = by + r, gx = tx + cc;
          if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
          float acc = 0.f;
          for (int k = 0; k < nh; ++k)
            acc = fmaf(rd(sm, st.in0, g, c, gy + k - st.rh, gx), wh[k], acc);
          scratch[r * sp + cc] = acc;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
          const int r = i / cols, cc = i - r * cols;
          const int gy = by + r, gx = bx + cc;
          if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
          const float* row = scratch + r * sp;
          float acc = 0.f;
          for (int k = 0; k < nw; ++k)
            acc = fmaf(row[min(max(gx + k - st.rw, 0), W - 1) - tx], ww[k], acc);
          emit(c, r, cc, acc);
        }
        __syncthreads();
      }
      continue;
    }
    // A stencil block whose taps all lie in the image reads them unclamped.
    const bool taps_in = by - st.rh >= 0 && by + rows + st.rh <= H && bx - st.rh >= 0 &&
                         bx + cols + st.rh <= W;
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, cc = i - r * cols;
      const int gy = by + r, gx = bx + cc;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
      float o[4];
      if (st.kind == MC_STENCIL) {
        if (taps_in)
          stencil_op<false>(st, sm, taps, idx, g, gy, gx, o);
        else
          stencil_op<true>(st, sm, taps, idx, g, gy, gx, o);
      } else {
        float a[4], b[4];
        for (int c = 0; c < 4; ++c) {
          a[c] = rd<false>(sm, st.in0, g, c, gy, gx);
          b[c] = st.n_in > 1 ? rd<false>(sm, st.in1, g, c, gy, gx) : 0.f;
        }
        point_op<kAffine>(st, a, b, taps, idx, g, gy, gx, o);
      }
      for (int c = 0; c < 4; ++c) put<T>(st, sm, out, g, store, c, r, cc, gy, gx, o[c]);
    }
    __syncthreads();
  }
}

template <typename T, bool kAffine>
static int launch(const void* x, void* out, int H, int W, int TH, int TW, int rh_in, int ew_in,
                  const McArgs& args, const float* taps, const int* idx, int store, float time,
                  int smem, cudaStream_t stream) {
  auto kernel = graph_strip_mc_kernel<T, kAffine>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), H, W,
                                           TH, TW, rh_in, ew_in, store, time, taps, idx, args);
  return (int)cudaGetLastError();
}

}  // namespace rf

// stage_i / stage_f are host arrays (kMcStageInts ints and 4 floats per
// stage); taps / idx lie on the device.  bf16 selects bf16 storage for
// input and output (else f32).  Offsets are in floats of dynamic shared
// memory: the input block at 0, then the pool, scratch_off and taps_off
// (cuda_ops.McProgram._layout).
extern "C" int rf_graph_strip_mc(int bf16, const void* x, void* out, int H, int W, int TH, int TW,
                                 int rh_in, int ew_in, const int* stage_i, const float* stage_f,
                                 int n_stages, int scratch_off, int taps_off, const float* taps,
                                 const int* idx, int n_taps, int store, float time, int smem,
                                 void* stream) {
  if (n_stages < 1 || n_stages > rf::kMcMaxStages) return (int)cudaErrorInvalidValue;
  rf::McArgs args{};
  args.n_stages = n_stages;
  args.scratch_off = scratch_off;
  args.taps_off = taps_off;
  args.n_taps = n_taps;
  for (int s = 0; s < n_stages; ++s) {
    const int* v = stage_i + s * rf::kMcStageInts;
    rf::McStage& st = args.st[s];
    st.kind = v[0];
    st.code = v[1];
    st.n_in = v[2];
    st.in0 = {v[3], v[4], v[5]};
    st.in1 = {v[6], v[7], v[8]};
    st.xs = {v[9], v[10], v[11]};
    st.out_off = v[12];
    st.eh = v[13];
    st.ew = v[14];
    st.rh = v[15];
    st.rw = v[16];
    st.t0 = v[17];
    st.n0 = v[18];
    st.t1 = v[19];
    st.n1 = v[20];
    st.store = v[21];
    for (int k = 0; k < 4; ++k) st.p[k] = stage_f[4 * s + k];
  }
  bool affine = false;
  for (int s = 0; s < n_stages; ++s) affine = affine || args.st[s].code == rf::MC_AFFINE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return affine ? rf::launch<__nv_bfloat16, true>(x, out, H, W, TH, TW, rh_in, ew_in, args, taps,
                                                    idx, store, time, smem, s)
                  : rf::launch<__nv_bfloat16, false>(x, out, H, W, TH, TW, rh_in, ew_in, args,
                                                     taps, idx, store, time, smem, s);
  return affine ? rf::launch<float, true>(x, out, H, W, TH, TW, rh_in, ew_in, args, taps, idx,
                                          store, time, smem, s)
                : rf::launch<float, false>(x, out, H, W, TH, TW, rh_in, ew_in, args, taps, idx,
                                           store, time, smem, s);
}

// 0: stages per plan; 1: ints per stage (cuda_ops.MC_MAX_STAGES,
// MC_STAGE_INTS).
extern "C" int rf_mc_limits(int which) { return which == 0 ? rf::kMcMaxStages : rf::kMcStageInts; }
