// conv1d_h / conv1d_w: a 1-D correlation of each channel plane of an f32
// (C, H, W) image along H or along W, with edge (clamp) or zero borders.
//
// Replaces pallas_ops.conv1d_h / conv1d_w (_conv_h_kernel, _conv_w_kernel).
// The TPU kernels padded the image in the wrapper and streamed whole-height
// (H pass) or whole-width (W pass) blocks of one channel through VMEM.  Here
// a block owns one (TH x TW) output tile of one channel plane:
//
//   * The tile plus its 1-D halo loads once into shared memory.  H pass:
//     (TH + 2R) rows of the tile's 32 columns, 16 bytes a thread by
//     cp.async where the window lies in the image.  W pass: TH rows of
//     TW + 2R columns (from the multiple of 4 at or before x0 - R), 16
//     bytes a thread through registers into rows of odd pitch.  A window
//     that crosses the image's edge reads element by element through the
//     clamped (edge) coordinate, or zero-fills (zero): the window then
//     holds what the clamped reads would, and every block runs the same
//     tap loop.
//   * The tap list is the nonzero taps of the vector in ascending order
//     (weight, position).  A thread computes kRun1 consecutive outputs
//     along the pass from a register window (`run_taps`): in the H pass
//     lanes sit on consecutive columns, in the W pass a warp covers 16 rows
//     (odd pitch: distinct banks) and two runs.  A chunk of kRun1 taps
//     whose positions are consecutive loads 2 kRun1 - 1 window values and
//     kRun1 weights for kRun1 x kRun1 products; a tap after a gap loads
//     kRun1 values.  Each output starts from -0 (the additive identity)
//     and adds __fmul_rn(x, w) with __fadd_rn tap by tap in ascending
//     order: the order and rounding of the plain version
//     (cuda_ops.correlate1d), so the two are bit-equal.  No tap list: zeros.
//   * Box taps (the nonzero taps all equal: frost, box_blur, kuwahara's
//     quadrant vector) take a form of their own (kPre): the block
//     multiplies its window by the common weight once, and the tap loop
//     only adds.  An input's rounded product is the same in every output
//     that reads it, so the bits do not change.
//   * W-pass outputs leave through shared memory, so warps store whole rows.
//   * Any radius.  Where no tile's window fits shared memory
//     (cuda_ops.choose_conv1d_tile) a second form reads every tap through
//     the clamped (or zero-filled) global coordinate, from L1/L2: four
//     outputs a thread, 8 rows (H) or 32 columns (W) apart.
//
// Bound on the card: the tap loop's issue slots.  The contract rounds each
// product and each sum, so a tap costs two f32 instructions an output,
// never one FMA; box taps one (the add) and a multiply an input.  At
// frost's radius-160 box on four 4K planes that is 10.7 G instructions,
// 0.32 ms at 128 a clock on each of an H100's 132 SMs at 1980 MHz
// (0.64 ms for a gaussian of that radius), against 0.08 ms for the bytes.
// There (H100 80GB HBM3, 700 W) the box takes 0.534 ms on conv1d_h and
// 0.514 on conv1d_w, the tap loop 0.37 and 0.38 of it (1.15-1.19x its
// bound); the gaussian 0.875 and 0.828, the tap loop 1.07-1.15x its
// bound (parts of the kernel cut out, on the card; PERF.md §6).
//
// Grid: (ceil(W / TW), ceil(H / TH), C).  Blocks: 256 threads, but the H
// pass's shared-memory form runs 2 TH (TH / kRun1 runs of 32 columns).

#include "conv_tile.cuh"

namespace rf {

constexpr int kOut = 4;     // global form: outputs a thread
constexpr int kRun1 = 16;   // shared form: consecutive outputs a thread

// ---- the global-memory form --------------------------------------------------

// acc[q] = sum over k < n of tap(q, k) * w[k], in ascending k.
template <typename Tap>
__device__ __forceinline__ void tap_sum(Tap tap, const float* __restrict__ w, int n, float* acc) {
  if (n == 0) {
#pragma unroll
    for (int q = 0; q < kOut; ++q) acc[q] = 0.f;
    return;
  }
  {
    const float wk = w[0];
#pragma unroll
    for (int q = 0; q < kOut; ++q) acc[q] = __fmul_rn(tap(q, 0), wk);
  }
  for (int k = 1; k < n; ++k) {
    const float wk = w[k];
#pragma unroll
    for (int q = 0; q < kOut; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(tap(q, k), wk));
  }
}

// Every tap through the clamped (or zero-filled) global coordinate: tap k
// of the output at image (gy, gx) is the pixel R - pos[k] before it along
// the pass.  H: TW 32, lanes on columns, rows 8 apart; W: TW 128, lanes on
// columns 32 apart.
template <bool kAlongH>
__device__ __forceinline__ void conv1d_global(const float* __restrict__ src, float* __restrict__ dst,
                                              int H, int W, int R, int zero, int TH, int y0, int x0,
                                              const float* __restrict__ w, const int* __restrict__ pos,
                                              int n) {
  auto global_tap = [&](int gy, int gx, int k) {
    int s = (kAlongH ? gy : gx) + pos[k] - R;
    const int len = kAlongH ? H : W;
    if (zero && (s < 0 || s >= len)) return 0.f;
    s = min(max(s, 0), len - 1);
    return kAlongH ? src[(size_t)s * W + gx] : src[(size_t)gy * W + s];
  };
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;  // 8 groups of 32
  float acc[kOut];
  if (kAlongH) {
    const int gx = x0 + lane, cx = min(gx, W - 1);
    for (int r0 = grp; r0 < TH; r0 += 8 * kOut) {
      tap_sum([&](int q, int k) { return global_tap(min(y0 + r0 + 8 * q, H - 1), cx, k); }, w, n,
              acc);
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const int gy = y0 + r0 + 8 * q;
        if (gy < H && gx < W) dst[(size_t)gy * W + gx] = acc[q];
      }
    }
  } else {
    for (int r = grp; r < TH; r += 8) {
      const int gy = y0 + r, cy = min(gy, H - 1);
      tap_sum([&](int q, int k) { return global_tap(cy, min(x0 + lane + 32 * q, W - 1), k); }, w,
              n, acc);
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const int gx = x0 + lane + 32 * q;
        if (gy < H && gx < W) dst[(size_t)gy * W + gx] = acc[q];
      }
    }
  }
}

// ---- the shared-memory form ----------------------------------------------------

// acc[j], j < kRun1: the sum over the n taps (weight w[k], window offset
// pos[k]) of src[(pos[k] + j) * step] * w[k], from -0 in ascending k, each
// product and sum rounded (__fmul_rn, __fadd_rn).  A chunk of kRun1 taps
// at consecutive positions loads its 2 kRun1 - 1 values into registers
// once; any other tap loads kRun1.  kPre: the taps are all equal and src
// holds each value's rounded product with that weight already, so a tap
// only adds it (the same bits).
template <bool kPre>
__device__ __forceinline__ void run_taps(const float* __restrict__ src, int step,
                                         const float* __restrict__ w, const int* __restrict__ pos,
                                         int n, float* acc) {
#pragma unroll
  for (int j = 0; j < kRun1; ++j) acc[j] = n > 0 ? -0.f : 0.f;
  int k = 0;
  while (k < n) {
    const int p = pos[k];
    const float* s = src + p * step;
    if (k + kRun1 <= n && pos[k + kRun1 - 1] - p == kRun1 - 1) {
      float v[2 * kRun1 - 1];
#pragma unroll
      for (int m = 0; m < 2 * kRun1 - 1; ++m) v[m] = s[m * step];
#pragma unroll
      for (int kk = 0; kk < kRun1; ++kk) {
        const float wk = kPre ? 0.f : w[k + kk];
#pragma unroll
        for (int j = 0; j < kRun1; ++j)
          acc[j] = __fadd_rn(acc[j], kPre ? v[j + kk] : __fmul_rn(v[j + kk], wk));
      }
      k += kRun1;
    } else {
      float v[kRun1];
#pragma unroll
      for (int j = 0; j < kRun1; ++j) v[j] = s[j * step];
      const float wk = kPre ? 0.f : w[k];
#pragma unroll
      for (int j = 0; j < kRun1; ++j) acc[j] = __fadd_rn(acc[j], kPre ? v[j] : __fmul_rn(v[j], wk));
      ++k;
    }
  }
}

// Columns of the W pass's window: lo, its column of image column x0 - R
// (x0 a multiple of 4), and n4 chunks of 4 from image column x0 - R - lo;
// rows have the odd pitch 4 n4 | 1 (cuda_ops.conv1d_footprint).
__device__ __forceinline__ int w_lo(int R) { return (4 - R % 4) % 4; }
__device__ __forceinline__ int w_chunks(int R, int TW) { return (w_lo(R) + TW + 2 * R + 3) >> 2; }

template <bool kAlongH, bool kPre>
__device__ __forceinline__ void conv1d_shared(float* smem, const float* __restrict__ src,
                                              float* __restrict__ dst, int H, int W, int R, int zero,
                                              int TH, int TW, int y0, int x0,
                                              const float* __restrict__ w_g,
                                              const int* __restrict__ pos_g, int n, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int lo = w_lo(R), n4 = w_chunks(R, TW);
  // H: (TH + 2R) rows of pitch 32; W: TH rows of pitch wp.
  const int wp = kAlongH ? 32 : (4 * n4) | 1;
  const int rows = kAlongH ? TH + 2 * R : TH;
  float* win = smem;
  float* w_s = win + rows * wp;
  int* pos_s = reinterpret_cast<int*>(w_s + n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    w_s[i] = w_g[i];
    pos_s[i] = pos_g[i];
  }
  if constexpr (kAlongH) {
    // Window row r: image row y0 - R + r, columns x0 .. x0 + 31.
    const int gy0 = y0 - R;
    if (vec && gy0 >= 0 && gy0 + rows <= H && x0 + 32 <= W) {
      const int q = threadIdx.x & 7;  // 8 threads a row, 16 bytes each
      for (int r = threadIdx.x >> 3; r < rows; r += blockDim.x >> 3)
        cp_async16(win + r * 32 + 4 * q, src + (size_t)(gy0 + r) * W + x0 + 4 * q);
    } else {
      const int gx = min(x0 + lane, W - 1);
      for (int r = warp; r < rows; r += n_warps) {
        const int gy = gy0 + r;
        const float v = src[(size_t)min(max(gy, 0), H - 1) * W + gx];
        win[r * 32 + lane] = zero && (gy < 0 || gy >= H) ? 0.f : v;
      }
    }
  } else {
    // Window column c: image column xs + c.
    const int xs = x0 - R - lo;
    if (vec && xs >= 0 && xs + 4 * n4 <= W && y0 + TH <= H) {
      // A warp takes 4 rows x 8 chunks a step: 4 full lines from device
      // memory, and its stores of each chunk's element on 32 banks.
      const int n8 = (n4 + 7) >> 3, items = (TH >> 2) * n8;
#pragma unroll 4
      for (int it = warp; it < items; it += n_warps) {
        const int rq = it / n8;
        const int c4 = (it - rq * n8) * 8 + (lane & 7), r = rq * 4 + (lane >> 3);
        if (c4 < n4) {
          const float4 v =
              __ldg(reinterpret_cast<const float4*>(src + (size_t)(y0 + r) * W + xs + 4 * c4));
          float* d = win + r * wp + 4 * c4;
          d[0] = v.x;
          d[1] = v.y;
          d[2] = v.z;
          d[3] = v.w;
        }
      }
    } else {
      for (int r = warp; r < TH; r += n_warps) {
        const int gy = min(y0 + r, H - 1);
        const float* row = src + (size_t)gy * W;
        for (int c = lane; c < 4 * n4; c += 32) {
          const int gx = xs + c;
          const float v = row[min(max(gx, 0), W - 1)];
          win[r * wp + c] = zero && (gx < 0 || gx >= W) ? 0.f : v;
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (kPre) {
    // Box taps: each window value times the common weight, once.
    const float w0 = w_s[0];
    for (int i = threadIdx.x; i < rows * wp; i += blockDim.x) win[i] = __fmul_rn(win[i], w0);
    __syncthreads();
  }
  // the tap loop
  float acc[kRun1];
  auto taps = [&](const float* s, int step) { run_taps<kPre>(s, step, w_s, pos_s, n, acc); };
  if constexpr (kAlongH) {
    // lane: column x0 + lane; warp: rows warp * kRun1 ..
    taps(win + warp * kRun1 * 32 + lane, 32);
    const int gx = x0 + lane;
    if (gx < W) {
#pragma unroll
      for (int j = 0; j < kRun1; ++j) {
        const int gy = y0 + warp * kRun1 + j;
        if (gy < H) dst[(size_t)gy * W + gx] = acc[j];
      }
    }
  } else {
    // A warp: 16 rows (lanes 0-15 and 16-31) and two runs side by side.
    const int n_wc = TW >> 5, rb = warp / n_wc;
    const int r = rb * 16 + (lane & 15), c0 = (warp - rb * n_wc) * 32 + (lane >> 4) * kRun1;
    taps(win + r * wp + lo + c0, 1);
    // The window is read: stage the tile at the odd pitch TW + 1, then
    // store whole rows.
    __syncthreads();
    const int tp = TW + 1;
#pragma unroll
    for (int j = 0; j < kRun1; ++j) win[r * tp + c0 + j] = acc[j];
    __syncthreads();
    const int out_rows = min(TH, H - y0), out_cols = min(TW, W - x0);
    for (int rr = warp; rr < out_rows; rr += n_warps) {
      float* d = dst + (size_t)(y0 + rr) * W + x0;
      for (int c = lane; c < out_cols; c += 32) d[c] = win[rr * tp + c];
    }
  }
}

// kAlongH: the H pass (else W).  kShared: the window in shared memory (else
// every tap from global memory).  kPre (shared form): the n > 0 taps are
// all equal, and the window is premultiplied; a form of its own, so that
// the other keeps its registers.  pos holds each tap's index in 0..2R.
template <bool kAlongH, bool kShared, bool kPre>
__global__ void __launch_bounds__(kThreads, 3)
conv1d_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int R, int zero,
              int TH, int TW, const float* __restrict__ w_g, const int* __restrict__ pos_g, int n,
              int vec) {
  extern __shared__ float smem[];
  const int y0 = (int)blockIdx.y * TH, x0 = (int)blockIdx.x * TW;
  const size_t plane = (size_t)H * W;
  const float* src = x + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  if constexpr (kShared)
    conv1d_shared<kAlongH, kPre>(smem, src, dst, H, W, R, zero, TH, TW, y0, x0, w_g, pos_g, n,
                                 vec != 0);
  else
    conv1d_global<kAlongH>(src, dst, H, W, R, zero, TH, y0, x0, w_g, pos_g, n);
}

template <bool kAlongH>
static int launch(const float* x, float* out, int C, int H, int W, int R, int zero, int TH, int TW,
                  const float* w, const int* pos, int n, int smem, int vec, int pre,
                  cudaStream_t s) {
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  if (smem > 0) {
    auto kernel = pre ? conv1d_kernel<kAlongH, true, true> : conv1d_kernel<kAlongH, true, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = kAlongH ? TH / kRun1 * 32 : kThreads;
    kernel<<<grid, threads, smem, s>>>(x, out, H, W, R, zero, TH, TW, w, pos, n, vec);
  } else {
    conv1d_kernel<kAlongH, false, false><<<grid, kThreads, 0, s>>>(x, out, H, W, R, zero, TH, TW,
                                                                   w, pos, n, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace rf

// f32 (C, H, W) in and out.  w / pos are the n nonzero taps and their
// positions in 0..2R, on the device.  smem > 0: the shared-memory form with
// that many bytes of window and tap list; H pass TW 32 and TH one of 16,
// 32, 64, 128, W pass TH x TW = 16 x 256 (or any TH a multiple of 16 and TW
// of 32 with eight warps).  smem == 0: the global form, H pass TW 32 and TH
// a multiple of 32, W pass TW 128 and TH a multiple of 8.  vec: the
// plane's rows start on 16-byte boundaries (W a multiple of 4, x aligned).
// pre: the n taps are all equal (a box: the shared form multiplies its
// window by that weight once, then adds).
extern "C" int rf_conv1d(int along_h, const float* x, float* out, int C, int H, int W, int R,
                         int zero, int TH, int TW, const float* w, const int* pos, int n, int smem,
                         int vec, int pre, void* stream) {
  bool ok;
  if (smem > 0)
    ok = along_h ? TW == 32 && (TH == 16 || TH == 32 || TH == 64 || TH == 128)
                 : TW % 32 == 0 && TH % 16 == 0 && (TH / 16) * (TW / 32) == rf::kThreads / 32;
  else
    ok = along_h ? (TW == 32 && TH % 32 == 0) : (TW == 32 * rf::kOut && TH % 8 == 0);
  if (!ok || R < 0 || n < 0 || TH <= 0 || (pre && n == 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (along_h)
    return rf::launch<true>(x, out, C, H, W, R, zero, TH, TW, w, pos, n, smem, vec, pre, s);
  return rf::launch<false>(x, out, C, H, W, R, zero, TH, TW, w, pos, n, smem, vec, pre, s);
}
