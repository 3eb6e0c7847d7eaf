// stencil_apply_mc: a cross-channel linear stencil, (C_in, H, W) ->
// (C_out, H, W).
//
// Replaces pallas_ops.stencil_apply_mc / _stencil_kernel_mc, which ran a
// traced Python closure fn(tap) -> (C_out, rows, W) over a double-buffered
// VMEM strip holding every input channel.  A CUDA kernel takes no closure,
// so the function is a record (cuda_ops.LinearStencilOp): a
// (C_out, C_in, 2RH+1, 2RW+1) tap table, whose nonzero terms for output
// channel o are listed in ascending (c, dy, dx):
//
//   out[o](y, x) = sum_k w_k * in[c_k](y + dy_k - RH, x + dx_k - RW)
//
// summed as one serial chain with every product and sum rounded on its own
// (__fmul_rn/__fadd_rn), the order of the plain PyTorch version, so the two
// agree bit for bit.  Borders: clamped coordinates (edge) or zeros (zero).
//
// Forms, chosen by shape before the launch (cuda_ops.choose_stencil_mc_form):
//
//   * The run forms (stencil_mc.cuh; f32 here, bf16 in
//     stencil_mc_bf16.cu): 1-4 input and output channels at radii 1-3,
//     a table with every term (run) or with some absent (run_masked).
//     Persistent blocks copy the next tile's window while they compute
//     this one's; each thread makes eight outputs of a row for every
//     output channel from register windows, a weight loaded once for
//     eight outputs and no offset loaded at all; each warp stores its
//     outputs through a staging area of its own.
//   * The general form (stencil_mc_kernel, below), any other table: a
//     block owns one (TH x TW) output tile.  Where the tile and its halo
//     of all C_in channels and the term table fit shared memory, they
//     load once (conv_tile.cuh load_window) and every term reads shared
//     memory through its window offset; otherwise (global) the block
//     reads the terms and each tap through global memory (the clamped
//     global coordinate).  Each thread walks its pixels one at a time and
//     each output channel's terms as one chain.
//
// Bound on the card: device memory at small tables, the term loop (two
// f32 instructions a term and pixel, in issue slots) at large ones.  The
// general form spends the issue time of about 11 a term and pixel (a
// chain of two shared loads ahead of each product, one chain a thread);
// the run forms' loop issues 2.19 (350 SASS instructions a (c, dy) for
// 320 FMUL and FADD at radius 2, four outputs, cuobjdump).  Times:
// PERF.md.
//
// Grid: (ceil(W / TW), ceil(H / TH)) for the general form; the run forms'
// persistent blocks.

#include "stencil_mc.cuh"

namespace rf {

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_mc_kernel(const T* __restrict__ x, T* __restrict__ out, int C_in, int C_out, int H, int W,
                  int RH, int RW, int zero, int TH, int TW, int in_shared,
                  const float* __restrict__ w_g, const int* __restrict__ pos_g,
                  const int* __restrict__ start_g, int n) {
  extern __shared__ float smem[];
  const Tile t{H, W, RH, RW, TH, TW, (int)blockIdx.y * TH, (int)blockIdx.x * TW};
  const int rows = t.wrows(), cols = t.wcols();
  const size_t plane = (size_t)H * W;
  // Shared: the window of every input channel, then the term weights,
  // their window offsets and each output channel's first term.  The
  // global-memory path reads the terms where they lie.
  float* win = smem;
  const float* w_t = w_g;
  const int* start_t = start_g;
  int* off_s = nullptr;
  if (in_shared) {
    float* w_s = win + C_in * rows * cols;
    off_s = reinterpret_cast<int*>(w_s + n);
    int* start_s = off_s + n;
    copy_to_shared(w_g, n, w_s);
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      off_s[k] = (pos_g[3 * k] * rows + pos_g[3 * k + 1]) * cols + pos_g[3 * k + 2];
    for (int i = threadIdx.x; i <= C_out; i += blockDim.x) start_s[i] = start_g[i];
    for (int c = 0; c < C_in; ++c) load_window(x + c * plane, t, zero != 0, win + c * rows * cols);
    w_t = w_s;
    start_t = start_s;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
    const int y = i / TW, xx = i - y * TW;
    const int gy = t.y0 + y, gx = t.x0 + xx;
    if (gy >= H || gx >= W) continue;
    // Window pixel (y + dy, xx + dx) of channel c is tap (c, dy, dx).
    const float* base = win + y * cols + xx;
    auto tap = [&](int k) -> float {
      if (in_shared) return base[off_s[k]];
      int sy = gy + pos_g[3 * k + 1] - RH, sx = gx + pos_g[3 * k + 2] - RW;
      if (zero && (sy < 0 || sy >= H || sx < 0 || sx >= W)) return 0.f;
      sy = min(max(sy, 0), H - 1);
      sx = min(max(sx, 0), W - 1);
      return to_f32(x[pos_g[3 * k] * plane + (size_t)sy * W + sx]);
    };
    for (int o = 0; o < C_out; ++o) {
      const int k0 = start_t[o], k1 = start_t[o + 1];
      float acc = 0.f;
      if (k0 < k1) {
        acc = __fmul_rn(tap(k0), w_t[k0]);
        for (int k = k0 + 1; k < k1; ++k) acc = __fadd_rn(acc, __fmul_rn(tap(k), w_t[k]));
      }
      out[o * plane + (size_t)gy * W + gx] = from_f32<T>(acc);
    }
  }
}

template <typename T>
static int launch(const void* x, void* out, int C_in, int C_out, int H, int W, int RH, int RW,
                  int zero, int TH, int TW, int in_shared, const float* w, const int* pos,
                  const int* start, int n, int smem, cudaStream_t stream) {
  auto kernel = stencil_mc_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), C_in,
                                           C_out, H, W, RH, RW, zero, TH, TW, in_shared, w, pos,
                                           start, n);
  return (int)cudaGetLastError();
}

int launch_mc_run_f32(const void* x, void* out, int C_in, int CO, int H, int W, int RH, int RW,
                      int zero, int vec, int masked, const float* w, const int* mask,
                      int nonempty, int smem, cudaStream_t s) {
  return launch_mc_run<float>(x, out, C_in, CO, H, W, RH, RW, zero, vec, masked, w, mask,
                              nonempty, smem, s);
}

}  // namespace rf

// (C_in, H, W) in, (C_out, H, W) out, both f32 or both bf16 (bf16 != 0).
// form 0, the general form: w, n weights; pos, (c, dy, dx) per term;
// start, C_out + 1 term offsets.  in_shared: the window of every input
// channel and the terms lie in shared memory (the caller sized smem for
// them), else both read global memory and smem is 0.
// form 1 (every term of the table) or 2 (a mask of the terms), the run
// forms: C_in and C_out in 1..4, RH and RW in 1..3, the tile (TH, TW)
// (rf::kMcTH, rf::kMcTW), in_shared 1; run_w and run_mask, the weight
// rows and term masks of stencil_mc.cuh's layout on the device; nonempty,
// bit o set where output channel o has a term; smem, the form's bytes
// (cuda_ops.stencil_mc_run_footprint); vec: out starts on a 16-byte
// boundary and its rows are multiples of 16 bytes.
extern "C" int rf_stencil_apply_mc(int bf16, const void* x, void* out, int C_in, int C_out, int H,
                                   int W, int RH, int RW, int zero, int TH, int TW, int in_shared,
                                   const float* w, const int* pos, const int* start, int n,
                                   int form, const float* run_w, const int* run_mask,
                                   int nonempty, int vec, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1 || form == 2) {
    if (C_in < 1 || C_in > rf::kMcMaxC || C_out < 1 || C_out > rf::kMcMaxC || RH < 1 ||
        RH > rf::kMcMaxR || RW < 1 || RW > rf::kMcMaxR || TH != rf::kMcTH || TW != rf::kMcTW ||
        !in_shared)
      return (int)cudaErrorInvalidValue;
    auto go = [&](auto launcher) {
      return launcher(x, out, C_in, C_out, H, W, RH, RW, zero, vec, form == 2, run_w, run_mask,
                      nonempty, smem, s);
    };
    return bf16 ? go(rf::launch_mc_run_bf16) : go(rf::launch_mc_run_f32);
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return rf::launch<__nv_bfloat16>(x, out, C_in, C_out, H, W, RH, RW, zero, TH, TW, in_shared,
                                     w, pos, start, n, smem, s);
  return rf::launch<float>(x, out, C_in, C_out, H, W, RH, RW, zero, TH, TW, in_shared, w, pos,
                           start, n, smem, s);
}
