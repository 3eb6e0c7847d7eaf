// sep_conv_multi: N separable convolutions of one (C, H, W) input.
//
// Serves three TPU kernels of reforge_tpu/kernels/pallas_ops.py through
// one Hopper kernel: sep_conv_fused (one conv, f32, edge or zero border),
// sep_conv_fused_multi (N convs of one input sharing its loads) and
// sep_conv_fused_mxu (bf16 storage; the TPU ran it as MXU band matmuls,
// here it is the same f32 tap loop on bf16 loads).
//
// Grid: (ceil(W / TW), ceil(H / TH), C).  Outputs are N planes stacked as
// (N, C, H, W).  See conv_tile.cuh for the tile stage.

#include "conv_tile.cuh"

namespace rf {

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
sep_conv_multi_kernel(const TIn* __restrict__ x, TOut* __restrict__ out, int C, int H, int W,
                      const float* __restrict__ taps, const int* __restrict__ meta, int n_plans,
                      int n_taps, int RH, int RW, int zero, int TH, int TW) {
  extern __shared__ float smem[];
  Tile t{H, W, RH, RW, TH, TW, (int)blockIdx.y * TH, (int)blockIdx.x * TW};
  float* win = smem;
  float* tmp = win + t.wrows() * t.wcols();
  float* tap_s = tmp + TH * t.wcols();
  const int c = blockIdx.z;
  const size_t plane = (size_t)H * W;

  copy_to_shared(taps, n_taps, tap_s);
  load_window(x + c * plane, t, zero != 0, win);
  __syncthreads();

  for (int k = 0; k < n_plans; ++k) {
    const int rh = meta[4 * k], rw = meta[4 * k + 1];
    h_pass(win, tap_s + meta[4 * k + 2], rh, t, tmp);
    __syncthreads();
    const float* ww = tap_s + meta[4 * k + 3];
    TOut* dst = out + ((size_t)k * C + c) * plane;
    for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
      const int y = i / TW, xx = i - y * TW;
      const int gy = t.y0 + y, gx = t.x0 + xx;
      if (gy < H && gx < W) dst[(size_t)gy * W + gx] = from_f32<TOut>(w_at(tmp, ww, rw, t, y, xx));
    }
    __syncthreads();
  }
}

template <typename TIn, typename TOut>
static int launch(const void* x, void* out, int C, int H, int W, const float* taps,
                  const int* meta, int n_plans, int n_taps, int RH, int RW, int zero, int TH,
                  int TW, int smem, cudaStream_t stream) {
  auto kernel = sep_conv_multi_kernel<TIn, TOut>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const TIn*>(x), static_cast<TOut*>(out),
                                           C, H, W, taps, meta, n_plans, n_taps, RH, RW, zero,
                                           TH, TW);
  return (int)cudaGetLastError();
}

}  // namespace rf

// in_bf16 selects bf16 input (else f32); the output is always f32.
extern "C" int rf_sep_conv_multi(int in_bf16, const void* x, void* out, int C, int H, int W,
                                 const float* taps, const int* meta, int n_plans, int n_taps,
                                 int RH, int RW, int zero, int TH, int TW, int smem,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return rf::launch<__nv_bfloat16, float>(x, out, C, H, W, taps, meta, n_plans, n_taps, RH,
                                            RW, zero, TH, TW, smem, s);
  return rf::launch<float, float>(x, out, C, H, W, taps, meta, n_plans, n_taps, RH, RW, zero,
                                  TH, TW, smem, s);
}

extern "C" const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
