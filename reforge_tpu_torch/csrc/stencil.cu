// stencil_apply: a per-pixel neighbourhood function of each channel plane.
//
// Replaces pallas_ops.stencil_apply / _stencil_kernel, which evaluated a
// traced Python closure over tap views of a VMEM strip.  CUDA cannot take
// a closure, so the function is one of two ops (cuda_ops.StencilOp):
//
//   * ST_WSUM: the sum of n terms w[i] * tap(dy_i, dx_i), the nonzero
//     taps of a (2RH+1) x (2RW+1) table in ascending (dy, dx), in the
//     order of reforge_tpu.kernels.ops.conv2d (pixel_ops.cuh
//     wsum_ordered).  Every product and sum rounds on its own
//     (__fmul_rn/__fadd_rn), so cancellation-built tables (the
//     laplacian of sharpen) round as the plain version does.
//   * ST_MEDIAN9: the median of the 3x3 neighbourhood by Smith's
//     19-exchange network.
//
// A block owns one (TH x TW) output tile of one channel plane; the tile
// and its (RH, RW) halo load once into shared memory with clamped (edge)
// or zero-filled (zero) reads (conv_tile.cuh load_window), then each
// thread evaluates its pixels from there: one device-memory read and one
// write per pixel.  Term positions arrive as dy * 64 + dx (radii <= 16).
//
// Grid: (ceil(W / TW), ceil(H / TH), C).

#include "conv_tile.cuh"
#include "pixel_ops.cuh"

namespace rf {

enum StencilKind : int { ST_WSUM = 0, ST_MEDIAN9 = 1 };

__global__ void __launch_bounds__(kThreads)
stencil_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int RH,
               int RW, int zero, int TH, int TW, int kind, const float* __restrict__ w_g,
               const int* __restrict__ idx_g, int n) {
  extern __shared__ float smem[];
  Tile t{H, W, RH, RW, TH, TW, (int)blockIdx.y * TH, (int)blockIdx.x * TW};
  const int cols = t.wcols();
  float* win = smem;
  float* w_s = win + t.wrows() * cols;
  int* off_s = reinterpret_cast<int*>(w_s + n);
  const int c = blockIdx.z;
  const size_t plane = (size_t)H * W;

  copy_to_shared(w_g, n, w_s);
  for (int i = threadIdx.x; i < n; i += blockDim.x) off_s[i] = (idx_g[i] >> 6) * cols + (idx_g[i] & 63);
  load_window(x + c * plane, t, zero != 0, win);
  __syncthreads();

  for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
    const int y = i / TW, xx = i - y * TW;
    const int gy = t.y0 + y, gx = t.x0 + xx;
    if (gy >= H || gx >= W) continue;
    // Window pixel (y + dy, xx + dx) is tap (dy, dx) of output pixel (y, xx).
    const float* base = win + y * cols + xx;
    float v;
    if (kind == ST_WSUM) {
      v = wsum_ordered([&](int k) { return k < 0 ? base[RH * cols + RW] : base[off_s[k]]; },
                       w_s, n);
    } else {
      float m[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) m[k] = base[(k / 3) * cols + k % 3];
      v = median9(m);
    }
    out[c * plane + (size_t)gy * W + gx] = v;
  }
}

}  // namespace rf

// f32 (C, H, W) in and out.  The caller checks radii <= 16, a tap table
// matching (RH, RW) and radius 1 for the median.
extern "C" int rf_stencil_apply(const float* x, float* out, int C, int H, int W, int RH, int RW,
                                int zero, int TH, int TW, int kind, const float* w,
                                const int* idx, int n, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(rf::stencil_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  rf::stencil_kernel<<<grid, rf::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, H, W, RH, RW, zero, TH, TW, kind, w, idx, n);
  return (int)cudaGetLastError();
}
