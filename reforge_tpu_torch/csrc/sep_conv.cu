// sep_conv_multi: N separable convolutions of one (C, H, W) input.
//
// Serves four TPU kernels of reforge_tpu/kernels/pallas_ops.py through
// one Hopper kernel: sep_conv_fused (one conv, f32, edge or zero border),
// sep_conv_fused_multi (N convs of one input sharing its loads),
// sep_conv_fused_mxu (bf16 storage; the TPU ran it as MXU band matmuls,
// here it is the same f32 tap loop on a bf16 window) and
// sep_conv_fused_mxu_x3 (heavy f32 convs; the TPU split each operand into
// three bf16 terms for its MXU).
//
// Design (conv_tile.cuh, the register-blocked stage): a block loads its
// tile's window once as f32 (16 bytes a thread inside the image, cp.async
// for f32; clamped or zero-filled reads at its border), then for each
// plan runs the H pass into shared
// memory and the W pass from there, kConvRun outputs a thread from a
// sliding register window, and stores the plan's output tile through
// shared memory in whole rows.  Every output is the FMA chain of the
// stage this replaced, bit for bit.
//
// Bound on the card: the window load, then the two passes' FMAs and
// shared-memory loads and the staged stores, each near the device-memory
// time.  At 4K on an H100 80GB HBM3 (700 W): sep_conv_fused radius 12
// 0.212 ms against its 0.079 ms bound (0.61 before this stage), _multi
// radii 6 + 12 0.314, _mxu 0.228, _mxu_x3 radius 24 0.448 (PERF.md §6).
//
// Grid: (ceil(W / TW), ceil(H / TH), C).  Outputs are N f32 planes
// stacked as (N, C, H, W).

#include <cstdint>

#include "conv_tile.cuh"

namespace rf {

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
sep_conv_multi_kernel(const TIn* __restrict__ x, float* __restrict__ out, int C, int H, int W,
                      const float* __restrict__ taps, const int* __restrict__ meta, int n_plans,
                      int n_taps, int RH, int RW, int zero, int TH, int TW, int align,
                      int vec) {
  extern __shared__ __align__(16) float smem[];
  const RunTile t =
      run_tile(H, W, RH, RW, TH, TW, (int)blockIdx.y * TH, (int)blockIdx.x * TW, align);
  float* win = reinterpret_cast<float*>(smem);
  float* tmp = win + t.window_floats();
  float* tap_s = tmp + TH * t.tp;
  const int c = blockIdx.z;
  const size_t plane = (size_t)H * W;

  load_window_async(x + c * plane, t, zero != 0, vec != 0, win);
  copy_to_shared(taps, n_taps, tap_s);
  cp_async_wait_all();
  __syncthreads();

  // the conv passes
  // W-pass runs of this thread: row r, columns from (q0 + i * q_step) * kConvRun.
  const int r = threadIdx.x % TH, q0 = threadIdx.x / TH, q_step = blockDim.x / TH;
  const int n_q = TW / kConvRun;
  for (int k = 0; k < n_plans; ++k) {
    const int rw = meta[4 * k + 1];
    h_pass_runs(win, tap_s + meta[4 * k + 2], meta[4 * k], t, tmp);
    __syncthreads();
    const float* ww = tap_s + meta[4 * k + 3];
    float acc[kMaxRuns][kConvRun];
#pragma unroll
    for (int i = 0; i < kMaxRuns; ++i) {
      const int q = q0 + i * q_step;
      if (q < n_q) run_conv(tmp + r * t.tp + q * kConvRun + (RW - rw), 1, 2 * rw + 1, ww, acc[i]);
    }
    __syncthreads();  // tmp stages the output tile from here
#pragma unroll
    for (int i = 0; i < kMaxRuns; ++i) {
      const int q = q0 + i * q_step;
      if (q < n_q) stage_run(tmp, t, r, q * kConvRun, acc[i]);
    }
    __syncthreads();
    store_tile(tmp, t, out + ((size_t)k * C + c) * plane);
    __syncthreads();  // before the next plan's H pass
  }
}

template <typename TIn>
static int launch(const void* x, void* out, int C, int H, int W, const float* taps,
                  const int* meta, int n_plans, int n_taps, int RH, int RW, int zero, int TH,
                  int TW, int align, int smem, cudaStream_t stream) {
  auto kernel = sep_conv_multi_kernel<TIn>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (TH % kConvRun != 0 || kThreads % TH != 0 || TW % kConvRun != 0 ||
      TH * TW > kMaxRuns * kThreads * kConvRun || (align != kAlign && align != 1))
    return (int)cudaErrorInvalidValue;
  // 16-byte window loads need 16-byte rows (the input aligned, W a
  // multiple of 8) and kAlign's layout
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 8 == 0 && align == kAlign;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const TIn*>(x), static_cast<float*>(out),
                                           C, H, W, taps, meta, n_plans, n_taps, RH, RW, zero,
                                           TH, TW, align, vec);
  return (int)cudaGetLastError();
}

}  // namespace rf

// in_bf16 selects bf16 input (else f32); the output is always f32.  align
// and smem are cuda_ops.conv_layout's for the tile.
extern "C" int rf_sep_conv_multi(int in_bf16, const void* x, void* out, int C, int H, int W,
                                 const float* taps, const int* meta, int n_plans, int n_taps,
                                 int RH, int RW, int zero, int TH, int TW, int align, int smem,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return rf::launch<__nv_bfloat16>(x, out, C, H, W, taps, meta, n_plans, n_taps, RH, RW, zero,
                                     TH, TW, align, smem, s);
  return rf::launch<float>(x, out, C, H, W, taps, meta, n_plans, n_taps, RH, RW, zero, TH, TW,
                           align, smem, s);
}

extern "C" const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
