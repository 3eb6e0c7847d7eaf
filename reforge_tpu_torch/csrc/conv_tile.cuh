// Shared conv-tile stages of the port's Hopper kernels.
//
// Two stages live here, beside the cp.async helpers the kernels share.
// `Tile`, `load_window` and `copy_to_shared` are
// the scalar window load of the stencil kernels (stencil.cu,
// stencil_mc.cu, stencil_reduce.cu) and of graph_strip_mc.cu: a block
// loads its (TH x TW) output tile of one channel plane plus its (RH, RW)
// halo into shared memory as f32 with clamped (edge) or zero-filled (zero)
// reads, which replaces the TPU kernels' in-kernel halo padding
// (pallas_ops._strip_dma_fn / _strip_fill_halos).
//
// The register-blocked separable-conv stage (`RunTile` and below) serves
// sep_conv.cu and graph_strip.cu:
//   * The window is f32.  Its first column is rounded down to a multiple
//     of 8 elements of the image row, so a block whose window lies inside
//     the image copies it 16 bytes a thread, rows by warps: cp.async for
//     f32, 16-byte loads widened to f32 for bf16; a border block reads
//     element by element through the clamped coordinate (or zero-fills).
//     Neither divides an index.
//   * H pass: a thread computes kConvRun outputs down one window column
//     from a sliding register window (`run_conv`), lanes on consecutive
//     columns, into an f32 buffer of odd pitch.  W pass: kConvRun outputs
//     along one row, lanes on consecutive rows, so the odd pitch puts a
//     warp's reads on 32 distinct banks.  Each window value and each tap
//     loads from shared memory once a run, not once an FMA.
//   * Every output is one FMA chain in ascending tap order from 0, the
//     order of the stage this replaced: results are bit-equal to it, and
//     interior and border blocks agree.
//   * The W pass's runs go out through a staging tile in shared memory,
//     so warps store whole rows: full 32-byte sectors, coalesced.
// Tensor cores are not used: at these tap counts the f32 FMAs' own bound
// (operations over the f32 rate, an FMA two: 0.05 ms for
// a radius-12 conv of a 4K frame on an H100) is under the device-memory
// time, and a TF32 or bf16x3 band product would change the rounding the
// port holds the reference to (f32 accumulation, one rounding an FMA).
//
// Dynamic shared memory of the run stage holds, in order: the window,
// the H-pass buffer and the taps, all f32; cuda_ops.conv_footprint sizes
// it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// ---- the register-blocked stage ---------------------------------------------

// Outputs a thread computes along a pass.  TH and TW are multiples of it,
// TH divides kThreads, and a tile has at most kMaxRuns W-pass runs a
// thread of kThreads (cuda_ops.TILES).
constexpr int kConvRun = 8;
constexpr int kMaxRuns = 2;

// Window of a block, f32 whatever the storage type: image pixel
// (y0 - RH + r, xs + c) at window (r, c), where xs = x0 - RW - lo is the
// multiple of `align` at or before x0 - RW (x0 is one: TW is).  `align`
// is kAlign, whose rows copy 16 bytes a thread, or 1 (packed: the
// largest windows, which fit shared memory only so; cuda_ops.conv_layout
// picks it).  The H-pass buffer holds (TH, TW + 2RW) at pitch tp.
constexpr int kAlign = 8;  // elements: 16 bytes of bf16, 32 of f32
struct RunTile {
  int H, W, RH, RW, TH, TW, y0, x0;
  int lo;  // window column of image column x0 - RW
  int wp;  // window pitch in floats: a multiple of align
  int tp;  // H-pass pitch in floats: odd
  __device__ int wrows() const { return TH + 2 * RH; }
  __device__ int cols() const { return TW + 2 * RW; }
  __device__ int xs() const { return x0 - RW - lo; }
  // floats of the window; the H-pass buffer follows it
  __device__ int window_floats() const { return wrows() * wp; }
};

__device__ __forceinline__ RunTile run_tile(int H, int W, int RH, int RW, int TH, int TW, int y0,
                                            int x0, int align) {
  const int lo = (align - RW % align) % align;
  return RunTile{H, W, RH, RW, TH, TW, y0, x0, lo,
                 (lo + TW + 2 * RW + align - 1) / align * align, (TW + 2 * RW) | 1};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// A 4-byte cp.async; zero-fills instead where `fill_zero`.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool fill_zero) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(fill_zero ? 0 : 4)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits for this thread's cp.async copies (none: returns at once).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Starts the window's load.  `vec`: the plane's rows start on 16-byte
// boundaries and the window's layout is kAlign's.  A window inside the
// image copies 16 bytes a thread, rows by
// warps: f32 by cp.async (wait with cp_async_wait_all, then
// __syncthreads), bf16 through registers, widened to f32 (cp.async
// cannot convert); any other window reads element by element through the
// clamped coordinate, or zero-fills.
template <typename T>
__device__ __forceinline__ void load_window_async(const T* __restrict__ plane, const RunTile& t,
                                                  bool zero, bool vec, float* __restrict__ win) {
  constexpr int kVec = 16 / sizeof(T);
  const int rows = t.wrows(), xs = t.xs(), gy0 = t.y0 - t.RH;
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  if (vec && gy0 >= 0 && gy0 + rows <= t.H && xs >= 0 && xs + t.wp <= t.W) {
    const int n = t.wp / kVec;
    for (int r = threadIdx.x >> 5; r < rows; r += n_warps) {
      const T* src = plane + (size_t)(gy0 + r) * t.W + xs;
      float* dst = win + r * t.wp;
      for (int v = lane; v < n; v += 32) {
        if constexpr (std::is_same_v<T, float>) {
          cp_async16(dst + v * kVec, src + v * kVec);
        } else {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + v * kVec));
          float4* d = reinterpret_cast<float4*>(dst + v * kVec);
          d[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                             __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
          d[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                             __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
        }
      }
    }
    return;
  }
  for (int r = threadIdx.x >> 5; r < rows; r += n_warps) {
    const int gy = gy0 + r;
    const bool row_in = gy >= 0 && gy < t.H;
    const T* src = plane + (size_t)min(max(gy, 0), t.H - 1) * t.W;
    float* dst = win + r * t.wp;
    for (int c = lane; c < t.wp; c += 32) {
      const int gx = xs + c;
      const float v = to_f32(src[min(max(gx, 0), t.W - 1)]);
      dst[c] = zero && !(row_in && gx >= 0 && gx < t.W) ? 0.f : v;
    }
  }
}

// acc[j] = sum over k < n of src[(j + k) * step] * w[k], j < kConvRun,
// accumulated with FMAs in ascending k from 0.  A register window slides
// over src: each value and each tap loads once a run.  Reads stop at
// src[(kConvRun + n - 2) * step], the run's last tap.
__device__ __forceinline__ void run_conv(const float* __restrict__ src, int step, int n,
                                         const float* __restrict__ w, float* acc) {
  float v[2 * kConvRun - 1];
#pragma unroll
  for (int j = 0; j < kConvRun; ++j) acc[j] = 0.f;
#pragma unroll
  for (int m = 0; m < kConvRun - 1; ++m) v[m] = src[m * step];
  int k0 = 0;
  for (; k0 + kConvRun <= n; k0 += kConvRun) {
    float wc[kConvRun];
#pragma unroll
    for (int m = 0; m < kConvRun; ++m) {
      v[kConvRun - 1 + m] = src[(k0 + kConvRun - 1 + m) * step];
      wc[m] = w[k0 + m];
    }
#pragma unroll
    for (int kk = 0; kk < kConvRun; ++kk) {
#pragma unroll
      for (int j = 0; j < kConvRun; ++j) acc[j] = fmaf(v[j + kk], wc[kk], acc[j]);
    }
#pragma unroll
    for (int m = 0; m < kConvRun - 1; ++m) v[m] = v[m + kConvRun];
  }
  if (k0 < n) {  // the last n - k0 < kConvRun taps
    const int last = kConvRun + n - 2;
#pragma unroll
    for (int m = 0; m < kConvRun; ++m) {
      const int k = k0 + kConvRun - 1 + m;
      v[kConvRun - 1 + m] = k <= last ? src[k * step] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kConvRun; ++kk) {
      if (k0 + kk < n) {
        const float wk = w[k0 + kk];
#pragma unroll
        for (int j = 0; j < kConvRun; ++j) acc[j] = fmaf(v[j + kk], wk, acc[j]);
      }
    }
  }
}

// H pass of one plan (radius rh, taps wh) over every window column:
// tmp[y * tp + x] for y < TH, x < TW + 2RW.  A plan of radius rh < RH
// starts RH - rh rows down.
__device__ __forceinline__ void h_pass_runs(const float* __restrict__ win,
                                            const float* __restrict__ wh, int rh, const RunTile& t,
                                            float* __restrict__ tmp) {
  const int cols = t.cols(), n = 2 * rh + 1, n_rr = t.TH / kConvRun;
  const float* base = win + (t.RH - rh) * t.wp + t.lo;
  // item (rr, x): rows rr * kConvRun.. of column x; the divisions once
  const int step_rr = blockDim.x / cols, step_x = blockDim.x - step_rr * cols;
  int rr = threadIdx.x / cols, x = threadIdx.x - rr * cols;
  while (rr < n_rr) {
    float acc[kConvRun];
    const int r0 = rr * kConvRun;
    run_conv(base + r0 * t.wp + x, t.wp, n, wh, acc);
#pragma unroll
    for (int j = 0; j < kConvRun; ++j) tmp[(r0 + j) * t.tp + x] = acc[j];
    rr += step_rr;
    x += step_x;
    if (x >= cols) {
      x -= cols;
      ++rr;
    }
  }
}

// The W pass's results leave through the H-pass buffer: each thread puts
// its runs into a (TH, TW) staging tile at pitch tp (lanes on consecutive
// rows: the odd pitch keeps a warp's writes on distinct banks), and after
// a __syncthreads warps store whole rows, 32 consecutive pixels an
// instruction: whole 32-byte sectors, 128-byte lines in f32.
__device__ __forceinline__ void stage_run(float* __restrict__ tmp, const RunTile& t, int r, int c0,
                                          const float* v) {
#pragma unroll
  for (int j = 0; j < kConvRun; ++j) tmp[r * t.tp + c0 + j] = v[j];
}

template <typename T>
__device__ __forceinline__ void store_tile(const float* __restrict__ tmp, const RunTile& t,
                                           T* __restrict__ plane) {
  const int rows = min(t.TH, t.H - t.y0), cols = min(t.TW, t.W - t.x0);
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += n_warps) {
    T* dst = plane + (size_t)(t.y0 + r) * t.W + t.x0;
    const float* src = tmp + r * t.tp;
    for (int c = lane; c < cols; c += 32) dst[c] = from_f32<T>(src[c]);
  }
}

}  // namespace rf
