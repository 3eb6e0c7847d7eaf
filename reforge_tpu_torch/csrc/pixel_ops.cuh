// Per-pixel helpers shared by the port's Hopper kernels (graph_strip.cu,
// stencil.cu, graph_strip_mc.cu): storage rounding, luma, smoothstep, the
// ordered weighted sum of ops.conv2d and the median-of-9 network.
//
// Where a helper must round as the plain PyTorch version does (luma before
// a threshold, the stencil sums, whose laplacian taps cancel), it uses
// __fmul_rn/__fadd_rn: nvcc never contracts those into an FMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rf {

enum Store : int { STORE_F32 = 0, STORE_BF16 = 1, STORE_RGBA8 = 2 };

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// Inter-node storage rounding: bf16 round-to-nearest-even, or the rgba8
// UNORM grid with an exact division by 255 (kernels.base.quantize_rgba8).
__device__ __forceinline__ float store_round(float v, int store) {
  if (store == STORE_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (store == STORE_RGBA8) return rintf(clip01(v) * 255.f) / 255.f;
  return v;
}

// smoothstep(e0, e0 + span, v); the caller passes span = e1 - e0 as the
// reference computes it (in double precision, on the host).
__device__ __forceinline__ float smoothstep(float e0, float span, float v) {
  const float s = clip01(__fdiv_rn(__fsub_rn(v, e0), span));
  return __fmul_rn(__fmul_rn(s, s), __fsub_rn(3.f, __fmul_rn(2.f, s)));
}

// Rec.709 relative luminance, rounded term by term: (r*lr + g*lg) + b*lb.
__device__ __forceinline__ float luma(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, 0.2126f), __fmul_rn(g, 0.7152f)), __fmul_rn(b, 0.0722f));
}

// sum_i tap(i) * w[i] over n nonzero terms given in ascending (dy, dx)
// order, in the order of reforge_tpu.kernels.ops.conv2d: one serial chain
// up to 16 terms; above that term i goes to stripe i % 8 and the eight
// stripes merge pairwise.  No terms: tap(-1) (the centre) times zero.
template <typename Tap>
__device__ __forceinline__ float wsum_ordered(Tap tap, const float* __restrict__ w, int n) {
  if (n == 0) return __fmul_rn(tap(-1), 0.f);
  if (n <= 16) {
    float acc = __fmul_rn(tap(0), w[0]);
    for (int i = 1; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(tap(i), w[i]));
    return acc;
  }
  float part[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) part[j] = __fmul_rn(tap(j), w[j]);
  for (int base = 8; base < n; base += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (base + j < n) part[j] = __fadd_rn(part[j], __fmul_rn(tap(base + j), w[base + j]));
  }
#pragma unroll
  for (int m = 8; m > 1; m >>= 1) {
#pragma unroll
    for (int j = 0; j < m / 2; ++j) part[j] = __fadd_rn(part[2 * j], part[2 * j + 1]);
  }
  return part[0];
}

// x ** e as PyTorch's pow of a tensor by a scalar computes it: its special
// exponents (0, 1, 2, 3, 0.5) by their exact forms, others by powf.
__device__ __forceinline__ float pow_scalar(float x, float e) {
  if (e == 0.f) return 1.f;
  if (e == 1.f) return x;
  if (e == 2.f) return __fmul_rn(x, x);
  if (e == 3.f) return __fmul_rn(__fmul_rn(x, x), x);
  if (e == 0.5f) return __fsqrt_rn(x);
  return powf(x, e);
}

// The 4x4 Bayer threshold (M + 0.5) / 16 in closed form (cuda_ops.bayer4).
__device__ __forceinline__ float bayer4(int y, int x) {
  auto m2 = [](int a, int b) { return 2 * b + a * (3 - 4 * b); };
  const int m = 4 * m2(y & 1, x & 1) + m2((y >> 1) & 1, (x >> 1) & 1);
  return ((float)m + 0.5f) * 0.0625f;
}

// The channel-local colour builtins, shared by graph_strip (opcode
// OP_CH0 + op) and graph_strip_mc (MC_CH0 + op), in the order of
// cuda_ops.CHANNEL_OPS.
enum ChannelOp : int {
  CH_INVERT = 0,       // 1 - a
  CH_SCALE,            // a * p0
  CH_GAMMA,            // max(a, 0) ** p0
  CH_BRIGHT_CONTRAST,  // (a - 0.5) * p0 + 0.5 + p1
  CH_GAIN,             // a * p[c]
  CH_POSTERIZE,        // round(clip01(a) * p0) / p0
  CH_DITHER,           // floor(clip01(a) * p0 + bayer4(y, x)) / p0
  CH_SCANLINES,        // a * (y % p0 == 0 ? p1 : 1)
  CH_ADD,              // a + p0 * b
  CH_MULTIPLY,         // a * b
  CH_SCREEN,           // 1 - (1 - a) * (1 - b)
  CH_OVERLAY,          // a < 0.5 ? 2 a b : 1 - 2 (1 - a) (1 - b)
  CH_DIFFERENCE,       // |a - b|
  CH_LEVELS,           // p3 + clip01((a - p0) / p1) ** p2 * p4
  CH_COUNT,
};

// Colour channel c of channel op `op` at image pixel (y, x), a from the
// node's input_image and b from its input_image2.  Each operation rounds
// on its own, in the order of the builtin's PyTorch form
// (cuda_ops.channel_op_plain); divisions are IEEE.
__device__ __forceinline__ float channel_op(int op, int c, float a, float b, const float* p, int y,
                                            int x) {
  switch (op) {
    case CH_INVERT: return __fsub_rn(1.f, a);
    case CH_SCALE: return __fmul_rn(a, p[0]);
    case CH_GAMMA: return pow_scalar(fmaxf(a, 0.f), p[0]);
    case CH_BRIGHT_CONTRAST:
      return __fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(a, 0.5f), p[0]), 0.5f), p[1]);
    case CH_GAIN: return __fmul_rn(a, p[c]);
    case CH_POSTERIZE: return __fdiv_rn(rintf(__fmul_rn(clip01(a), p[0])), p[0]);
    case CH_DITHER:
      return __fdiv_rn(floorf(__fadd_rn(__fmul_rn(clip01(a), p[0]), bayer4(y, x))), p[0]);
    case CH_SCANLINES: return y % (int)p[0] == 0 ? __fmul_rn(a, p[1]) : a;
    case CH_ADD: return __fadd_rn(a, __fmul_rn(p[0], b));
    case CH_MULTIPLY: return __fmul_rn(a, b);
    case CH_SCREEN: return __fsub_rn(1.f, __fmul_rn(__fsub_rn(1.f, a), __fsub_rn(1.f, b)));
    case CH_OVERLAY:
      return a < 0.5f ? __fmul_rn(__fmul_rn(2.f, a), b)
                      : __fsub_rn(1.f, __fmul_rn(__fmul_rn(2.f, __fsub_rn(1.f, a)), __fsub_rn(1.f, b)));
    case CH_DIFFERENCE: return fabsf(__fsub_rn(a, b));
    case CH_LEVELS: {
      const float t = clip01(__fdiv_rn(__fsub_rn(a, p[0]), p[1]));
      return __fadd_rn(p[3], __fmul_rn(pow_scalar(t, p[2]), p[4]));
    }
  }
  return __int_as_float(0x7fc00000);  // unknown op: NaN, caught by the checks
}

// Median of v[0..8] by Smith's 19-exchange network, as
// reforge_tpu/kernels/library.py:321-331 writes it (v[i] <- min, v[j] <-
// max per pair).  fminf/fmaxf drop a NaN where jnp.minimum propagates it;
// images are finite, so the two agree.
__device__ __forceinline__ float median9(float* v) {
#define RF_CE(i, j)                       \
  {                                       \
    const float a_ = v[i], b_ = v[j];     \
    v[i] = fminf(a_, b_);                 \
    v[j] = fmaxf(a_, b_);                 \
  }
  RF_CE(1, 2) RF_CE(4, 5) RF_CE(7, 8) RF_CE(0, 1) RF_CE(3, 4) RF_CE(6, 7) RF_CE(1, 2)
  RF_CE(4, 5) RF_CE(7, 8) RF_CE(0, 3) RF_CE(5, 8) RF_CE(4, 7) RF_CE(3, 6) RF_CE(1, 4)
  RF_CE(2, 5) RF_CE(4, 7) RF_CE(4, 2) RF_CE(6, 4) RF_CE(4, 2)
#undef RF_CE
  return v[4];
}

}  // namespace rf
