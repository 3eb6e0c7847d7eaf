// conv1d_h / conv1d_w: a 1-D correlation of each channel plane of an f32
// (C, H, W) image along H or along W, with edge (clamp) or zero borders.
//
// Replaces pallas_ops.conv1d_h / conv1d_w (_conv_h_kernel, _conv_w_kernel).
// The TPU kernels padded the image in the wrapper and streamed whole-height
// (H pass) or whole-width (W pass) blocks of one channel through VMEM.  Here
// a block owns one (TH x TW) output tile of one channel plane:
//
//   * The tile plus its 1-D halo -- (TH + 2R) x TW for the H pass,
//     TH x (TW + 2R) for the W pass -- loads once into shared memory with
//     clamped (edge) or zero-filled (zero) reads, lanes along W.
//   * The tap list is the nonzero taps of the vector in ascending order
//     (weight, position).  Each thread computes kOut outputs of the tile (8
//     rows apart for the H pass, 32 columns apart for the W pass, so a warp
//     reads consecutive shared-memory words), and for each starts from the
//     first product, then acc = __fadd_rn(acc, __fmul_rn(x, w)): the order
//     and rounding of the plain version (cuda_ops.correlate1d), so the two
//     are bit-equal.  No tap list: zeros.
//   * Any radius.  Where no tile's window fits shared memory
//     (cuda_ops.choose_conv1d_tile) the same loop reads every tap through
//     the clamped (or zero-filled) global coordinate, from L1/L2.
//
// Bound on the card: at frost's radius 160 the tap loop's operations (two
// per tap and output: a multiply and an add, never contracted) outweigh
// the bytes about fourfold; the kernel spends a shared-memory load per tap
// and output beside them (cuda_ops.conv1d_h has its time).
//
// Grid: (ceil(W / TW), ceil(H / TH), C).

#include "conv_tile.cuh"

namespace rf {

constexpr int kOut = 4;

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

// kAlongH: the H pass (else W).  kShared: the window in shared memory (else
// every tap from global memory).  pos holds each tap's index in 0..2R.
template <bool kAlongH, bool kShared>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int R, int zero,
              int TH, int TW, const float* __restrict__ w_g, const int* __restrict__ pos_g, int n) {
  extern __shared__ float smem[];
  const int y0 = (int)blockIdx.y * TH, x0 = (int)blockIdx.x * TW;
  const size_t plane = (size_t)H * W;
  const float* src = x + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  const int wrows = kAlongH ? TH + 2 * R : TH;
  const int wcols = kAlongH ? TW : TW + 2 * R;
  float* win = smem;
  const float* w = w_g;
  const int* off = pos_g;

  if (kShared) {
    // Tap k of the output at window element i is element i + off[k].
    float* w_s = win + wrows * wcols;
    int* off_s = reinterpret_cast<int*>(w_s + n);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      w_s[i] = w_g[i];
      off_s[i] = pos_g[i] * (kAlongH ? wcols : 1);
    }
    const int gy0 = kAlongH ? y0 - R : y0, gx0 = kAlongH ? x0 : x0 - R;
    for (int i = threadIdx.x; i < wrows * wcols; i += blockDim.x) {
      const int r = i / wcols, c = i - r * wcols;
      int gy = gy0 + r, gx = gx0 + c;
      float v = 0.f;
      if (!zero || (gy >= 0 && gy < H && gx >= 0 && gx < W)) {
        gy = min(max(gy, 0), H - 1);
        gx = min(max(gx, 0), W - 1);
        v = src[(size_t)gy * W + gx];
      }
      win[i] = v;
    }
    w = w_s;
    off = off_s;
    __syncthreads();
  }

  // Tap k of the output at image (gy, gx): the pixel R - pos[k] before it
  // along the pass, through the clamped (or zero-filled) coordinate.
  auto global_tap = [&](int gy, int gx, int k) {
    int s = (kAlongH ? gy : gx) + pos_g[k] - R;
    const int len = kAlongH ? H : W;
    if (zero && (s < 0 || s >= len)) return 0.f;
    s = min(max(s, 0), len - 1);
    return kAlongH ? src[(size_t)s * W + gx] : src[(size_t)gy * W + s];
  };

  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;  // 8 groups of 32
  float acc[kOut];
  if (kAlongH) {
    // TW == 32: lane = column; rows grp, grp + 8, ... in runs of kOut.
    const int gx = x0 + lane;
    for (int r0 = grp; r0 < TH; r0 += 8 * kOut) {
      if (kShared) {
        tap_sum([&](int q, int k) { return win[(r0 + 8 * q) * wcols + lane + off[k]]; }, w, n, acc);
      } else {
        const int cx = min(gx, W - 1);
        tap_sum([&](int q, int k) { return global_tap(min(y0 + r0 + 8 * q, H - 1), cx, k); }, w, n,
                acc);
      }
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const int gy = y0 + r0 + 8 * q;
        if (gy < H && gx < W) dst[(size_t)gy * W + gx] = acc[q];
      }
    }
  } else {
    // TW == 32 * kOut: row grp, grp + 8, ...; columns lane + 32 q.
    for (int r = grp; r < TH; r += 8) {
      const int gy = y0 + r;
      if (kShared) {
        tap_sum([&](int q, int k) { return win[r * wcols + lane + 32 * q + off[k]]; }, w, n, acc);
      } else {
        const int cy = min(gy, H - 1);
        tap_sum([&](int q, int k) { return global_tap(cy, min(x0 + lane + 32 * q, W - 1), k); },
                w, n, acc);
      }
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const int gx = x0 + lane + 32 * q;
        if (gy < H && gx < W) dst[(size_t)gy * W + gx] = acc[q];
      }
    }
  }
}

template <bool kAlongH>
static int launch(const float* x, float* out, int C, int H, int W, int R, int zero, int TH, int TW,
                  const float* w, const int* pos, int n, int smem, cudaStream_t s) {
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  if (smem > 0) {
    auto kernel = conv1d_kernel<kAlongH, true>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, s>>>(x, out, H, W, R, zero, TH, TW, w, pos, n);
  } else {
    conv1d_kernel<kAlongH, false><<<grid, kThreads, 0, s>>>(x, out, H, W, R, zero, TH, TW, w, pos,
                                                            n);
  }
  return (int)cudaGetLastError();
}

}  // namespace rf

// f32 (C, H, W) in and out.  along_h selects the H pass (TW must be 32 and
// TH a multiple of 32) or the W pass (TW 128, TH a multiple of 8).  w / pos
// are the n nonzero taps and their positions in 0..2R, on the device.
// smem > 0: the shared-memory path with that many bytes of window and tap
// list; smem == 0: every tap through global memory.
extern "C" int rf_conv1d(int along_h, const float* x, float* out, int C, int H, int W, int R,
                         int zero, int TH, int TW, const float* w, const int* pos, int n, int smem,
                         void* stream) {
  const bool ok = along_h ? (TW == 32 && TH % 32 == 0) : (TW == 32 * rf::kOut && TH % 8 == 0);
  if (!ok || R < 0 || n < 0 || TH <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (along_h) return rf::launch<true>(x, out, C, H, W, R, zero, TH, TW, w, pos, n, smem, s);
  return rf::launch<false>(x, out, C, H, W, R, zero, TH, TW, w, pos, n, smem, s);
}
