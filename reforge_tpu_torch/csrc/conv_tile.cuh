// Shared conv-tile stage of the port's Hopper kernels (sep_conv.cu,
// graph_strip.cu).
//
// A block owns one (TH x TW) output tile of one channel plane.  It loads
// the tile plus its (RH, RW) halo into shared memory as f32 with clamped
// (edge) or zero-filled (zero) reads, which replaces the TPU kernels'
// in-kernel halo padding (pallas_ops._strip_dma_fn / _strip_fill_halos).
// Every separable conv of the input then runs from that one window: the H
// pass into a (TH x TW+2RW) shared buffer, the W pass from there.  Smaller
// radii index the shared window at an offset, so N convs with different
// radii pay one load.
//
// Taps are f32 and the sums accumulate in f32 whatever the storage type.
// Dynamic shared memory holds, in order: the window, the H-pass buffer,
// the taps, and any per-kernel extras (cuda_ops.choose_tile sizes it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rf {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Geometry of one block's window.  Plans are described by `meta`, four
// ints each: {rh, rw, offset of wh in taps, offset of ww in taps}.
struct Tile {
  int H, W;      // image extent
  int RH, RW;    // largest radii over the plans (the window's halo)
  int TH, TW;    // output tile
  int y0, x0;    // image coordinate of output pixel (0, 0) of the tile
  __device__ int wrows() const { return TH + 2 * RH; }
  __device__ int wcols() const { return TW + 2 * RW; }
};

// Window pixel (sy, sx) holds image pixel (y0 - RH + sy, x0 - RW + sx).
template <typename T>
__device__ void load_window(const T* __restrict__ plane, const Tile& t, bool zero,
                            float* __restrict__ win) {
  const int cols = t.wcols();
  const int n = t.wrows() * cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int sy = i / cols;
    const int sx = i - sy * cols;
    int gy = t.y0 - t.RH + sy;
    int gx = t.x0 - t.RW + sx;
    float v = 0.f;
    if (!zero || (gy >= 0 && gy < t.H && gx >= 0 && gx < t.W)) {
      gy = min(max(gy, 0), t.H - 1);
      gx = min(max(gx, 0), t.W - 1);
      v = to_f32(plane[(size_t)gy * t.W + gx]);
    }
    win[i] = v;
  }
}

__device__ __forceinline__ void copy_to_shared(const float* __restrict__ src, int n,
                                               float* __restrict__ dst) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// H pass of one plan over every window column: tmp[y][x] for y < TH,
// x < TW + 2RW.  A plan of radius rh < RH starts RH - rh rows down.
__device__ inline void h_pass(const float* __restrict__ win, const float* __restrict__ wh,
                              int rh, const Tile& t, float* __restrict__ tmp) {
  const int cols = t.wcols();
  const int n = t.TH * cols;
  const int taps = 2 * rh + 1;
  const int base = t.RH - rh;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = i / cols;
    const int x = i - y * cols;
    const float* col = win + (y + base) * cols + x;
    float acc = 0.f;
    for (int k = 0; k < taps; ++k) acc = fmaf(col[k * cols], wh[k], acc);
    tmp[i] = acc;
  }
}

// W pass of one plan at output pixel (y, x) of the tile.
__device__ __forceinline__ float w_at(const float* __restrict__ tmp, const float* __restrict__ ww,
                                      int rw, const Tile& t, int y, int x) {
  const float* row = tmp + y * t.wcols() + x + (t.RW - rw);
  const int taps = 2 * rw + 1;
  float acc = 0.f;
  for (int k = 0; k < taps; ++k) acc = fmaf(row[k], ww[k], acc);
  return acc;
}

}  // namespace rf
