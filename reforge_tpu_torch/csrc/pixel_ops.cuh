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
