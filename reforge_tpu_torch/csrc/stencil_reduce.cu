// stencil_reduce: a windowed all-channel weighted reduction plus a final
// map, in one pass (bilateral's range-weighted mean).
//
// Replaces pallas_ops.stencil_reduce_mc / _stencil_reduce_kernel_mc, which
// took the per-tap contribution and the final map as traced Python
// closures.  CUDA cannot take a closure, so the reduction is one op
// (cuda_ops.ReduceOp):
//
//   * RD_BILATERAL over a (4, H, W) image of (r, g, b, luma): for each tap
//     (dy, dx, ws) of the list, in list order,
//         d  = n3 - c3                     (c: the centre pixel)
//         wr = expf(-(d * d) * inv2sr) * ws
//         acc += (n0 * wr, n1 * wr, n2 * wr, wr)
//     and out = acc[0..2] / acc[3], a (3, H, W) image.
//     Every product and sum rounds on its own (__fmul_rn/__fadd_rn, never
//     contracted into an FMA), expf is the full-precision one (no
//     --use_fast_math) and the division is IEEE, all in the order of the
//     plain version (cuda_ops.stencil_reduce_mc_plain).
//
// A block owns one (TH x TW) output tile.  Where the tile plus its (RH, RW)
// halo of all four channels fits shared memory (cuda_ops.choose_reduce_tile)
// it loads once, with clamped (edge) or zero-filled (zero) reads
// (conv_tile.cuh load_window), beside the tap table; each thread then
// evaluates its pixels from there, one f32 accumulator per channel.  A
// radius whose tile fits nowhere takes the same loop with every tap read
// through the clamped (or zero-filled) global coordinate, from L1/L2.
//
// Bound on the card: the tap loop.  Per pixel and tap it spends one
// expf (one MUFU.EX2 beside its range reduction), ten other f32
// operations and four window loads, against 28 bytes of device memory
// per pixel for all taps together.  The SFU term is the largest of the
// bound at radius 4 (81 taps), but nvcc's loop issues about 32
// instructions per tap and pixel, and issue is what the kernel waits on
// (cuda_ops.stencil_reduce_mc has its time).
//
// Tap positions arrive as two int arrays, dy then dx, each in 0..2R.
// Grid: (ceil(W / TW), ceil(H / TH)).

#include "conv_tile.cuh"

namespace rf {

enum ReduceKind : int { RD_BILATERAL = 0 };

// acc (re)starts at tap 0's contribution when `first`, as the plain
// version's `acc = t if acc is None else acc + t`.
__device__ __forceinline__ void bilateral_tap(const float* v, float c3, float ws, float inv2sr,
                                              bool first, float* acc) {
  const float d = __fsub_rn(v[3], c3);
  const float wr = __fmul_rn(expf(__fmul_rn(-__fmul_rn(d, d), inv2sr)), ws);
  const float t0 = __fmul_rn(v[0], wr), t1 = __fmul_rn(v[1], wr), t2 = __fmul_rn(v[2], wr);
  if (first) {
    acc[0] = t0;
    acc[1] = t1;
    acc[2] = t2;
    acc[3] = wr;
  } else {
    acc[0] = __fadd_rn(acc[0], t0);
    acc[1] = __fadd_rn(acc[1], t1);
    acc[2] = __fadd_rn(acc[2], t2);
    acc[3] = __fadd_rn(acc[3], wr);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
stencil_reduce_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W,
                      int RH, int RW, int zero, int TH, int TW, const float* __restrict__ w_g,
                      const int* __restrict__ pos_g, int n, float inv2sr) {
  extern __shared__ float smem[];
  Tile t{H, W, RH, RW, TH, TW, (int)blockIdx.y * TH, (int)blockIdx.x * TW};
  const size_t plane = (size_t)H * W;
  const int cols = t.wcols();
  const int cs = t.wrows() * cols;  // one channel's window
  float* win = smem;
  float* w_s = win + 4 * cs;
  int* off_s = reinterpret_cast<int*>(w_s + n);

  if (kShared) {
    copy_to_shared(w_g, n, w_s);
    for (int i = threadIdx.x; i < n; i += blockDim.x) off_s[i] = pos_g[i] * cols + pos_g[n + i];
#pragma unroll
    for (int c = 0; c < 4; ++c) load_window(x + c * plane, t, zero != 0, win + c * cs);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
    const int y = i / TW, xx = i - y * TW;
    const int gy = t.y0 + y, gx = t.x0 + xx;
    if (gy >= H || gx >= W) continue;
    float acc[4], v[4];
    if (kShared) {
      // Window pixel (y + dy, xx + dx) of channel c is tap (dy, dx).
      const float* base = win + y * cols + xx;
      const float c3 = base[3 * cs + RH * cols + RW];
      for (int k = 0; k < n; ++k) {
        const float* p = base + off_s[k];
        v[0] = p[0];
        v[1] = p[cs];
        v[2] = p[2 * cs];
        v[3] = p[3 * cs];
        bilateral_tap(v, c3, w_s[k], inv2sr, k == 0, acc);
      }
    } else {
      const float c3 = x[3 * plane + (size_t)gy * W + gx];
      for (int k = 0; k < n; ++k) {
        int sy = gy + pos_g[k] - RH, sx = gx + pos_g[n + k] - RW;
        const bool inside = sy >= 0 && sy < H && sx >= 0 && sx < W;
        sy = min(max(sy, 0), H - 1);
        sx = min(max(sx, 0), W - 1);
        const float* p = x + (size_t)sy * W + sx;
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = (zero && !inside) ? 0.f : p[c * plane];
        bilateral_tap(v, c3, w_g[k], inv2sr, k == 0, acc);
      }
    }
    const size_t at = (size_t)gy * W + gx;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * plane + at] = __fdiv_rn(acc[c], acc[3]);
  }
}

}  // namespace rf

// f32 (4, H, W) in, (3, H, W) out.  smem > 0: the shared-memory path with
// that many bytes of window and tap table; smem == 0: every tap through
// global memory.  The caller checks the tap range.
extern "C" int rf_stencil_reduce(const float* x, float* out, int H, int W, int RH, int RW,
                                 int zero, int TH, int TW, int kind, const float* w,
                                 const int* pos, int n, float inv2sr, int smem, void* stream) {
  if (kind != rf::RD_BILATERAL || n < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(rf::stencil_reduce_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    rf::stencil_reduce_kernel<true><<<grid, rf::kThreads, smem, s>>>(
        x, out, H, W, RH, RW, zero, TH, TW, w, pos, n, inv2sr);
  } else {
    rf::stencil_reduce_kernel<false><<<grid, rf::kThreads, 0, s>>>(
        x, out, H, W, RH, RW, zero, TH, TW, w, pos, n, inv2sr);
  }
  return (int)cudaGetLastError();
}
