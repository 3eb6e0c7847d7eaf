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
// Two forms, chosen by shape before the launch (cuda_ops.choose_stencil_form):
//
//   * Radius 1 (every shipped table: sharpen, emboss, sobel, the
//     laplacian; median3), stencil_r1_kernel, one form per kind.  There is
//     no shared memory: a thread makes kRun3 consecutive outputs of a row
//     and walks kR1Rows rows down its column strip, holding a 3-row
//     register window of kRun3 + 2 values a row and reading one new row a
//     step from global memory (two 16-byte loads and the two halo values,
//     which the neighbouring lanes' lines bring into L1).  A warp's lanes
//     sit on consecutive runs, so its loads and its 16-byte stores cover
//     whole rows.  The table's nine weights ride in the kernel's
//     parameters and its nonzero positions in a mask, so every tap is a
//     fixed register and every weight a constant-bank operand; each
//     output still adds its terms from -0 (the additive identity: the
//     bits of a chain that starts at its first term) in ascending order.
//   * Any other radius up to 16, stencil_kernel: a block owns one (TH x
//     TW) output tile of one channel plane; the tile and its (RH, RW) halo
//     load once into shared memory with clamped (edge) or zero-filled
//     (zero) reads (conv_tile.cuh load_window), then each thread evaluates
//     its pixels from there.  Term positions arrive as dy * 64 + dx.
//
// Bound on the card: device memory, one read and one write a pixel (0.079
// ms for four 4K planes on an H100); sharpen needs 9 f32 instructions a
// pixel, median9 38.  Times: cuda_ops.stencil_apply and PERF.md.
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

// ---- the radius-1 form ----------------------------------------------------------

constexpr int kRun3 = 8;                          // outputs a thread, along a row
constexpr int kR1Rows = 8;                        // rows a warp walks down
constexpr int kR1TH = kR1Rows * (kThreads / 32);  // tile rows
constexpr int kR1TW = 32 * kRun3;                 // tile columns

// The 3x3 table's weights, (dy, dx) at 3 dy + dx; absent terms hold 0 and
// are skipped by the mask.
struct Taps3x3 {
  float w[9];
};

// v[k] = image pixel (gy, gx0 - 1 + k), k < kRun3 + 2, of a plane, through
// the clamped coordinate (edge) or 0 outside (zero).  vec: rows start on
// 16-byte boundaries; a run inside the image then loads 16 bytes twice.
__device__ __forceinline__ void load_row3(const float* __restrict__ plane, int H, int W, int gy,
                                          int gx0, bool zero, bool vec, float* v) {
  if (zero && (gy < 0 || gy >= H)) {
#pragma unroll
    for (int k = 0; k < kRun3 + 2; ++k) v[k] = 0.f;
    return;
  }
  const float* row = plane + (size_t)min(max(gy, 0), H - 1) * W;
  if (vec && gx0 >= 1 && gx0 + kRun3 < W) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + gx0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + gx0 + 4));
    v[0] = __ldg(row + gx0 - 1);
    v[1] = a.x;
    v[2] = a.y;
    v[3] = a.z;
    v[4] = a.w;
    v[5] = b.x;
    v[6] = b.y;
    v[7] = b.z;
    v[8] = b.w;
    v[9] = __ldg(row + gx0 + kRun3);
    return;
  }
#pragma unroll
  for (int k = 0; k < kRun3 + 2; ++k) {
    const int gx = gx0 - 1 + k;
    const float a = __ldg(row + min(max(gx, 0), W - 1));
    v[k] = zero && (gx < 0 || gx >= W) ? 0.f : a;
  }
}

// Output j of the run from the rows above, at and below it.
template <int kKind>
__device__ __forceinline__ float r1_eval(const float* r0, const float* r1, const float* r2, int j,
                                         int mask, const Taps3x3& t) {
  const float m[9] = {r0[j], r0[j + 1], r0[j + 2], r1[j], r1[j + 1],
                      r1[j + 2], r2[j], r2[j + 1], r2[j + 2]};
  if constexpr (kKind == ST_MEDIAN9) {
    float v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = m[k];
    return median9(v);
  } else {
    if (mask == 0) return __fmul_rn(m[4], 0.f);  // no terms: the centre times 0
    float acc = -0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      if (mask >> k & 1) acc = __fadd_rn(acc, __fmul_rn(m[k], t.w[k]));
    return acc;
  }
}

// Block (bx, by) makes output tile (by, bx) of channels blockIdx.z,
// blockIdx.z + gridDim.z, ...  At least three blocks an SM, the row loop
// rolled: left alone, ptxas gave median9's form 138 registers, one block
// an SM, 40% slower; a floor of four made it spill (both timed on the
// card).
template <int kKind>
__global__ void __launch_bounds__(kThreads, 3)
stencil_r1_kernel(const float* __restrict__ x, float* __restrict__ out, int C, int H, int W,
                  int zero, int vec, int mask, const Taps3x3 taps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gx0 = (int)blockIdx.x * kR1TW + lane * kRun3;
  const int ys = (int)blockIdx.y * kR1TH + warp * kR1Rows;
  if (gx0 >= W || ys >= H) return;
  const int ye = min(ys + kR1Rows, H);
  const size_t plane = (size_t)H * W;
  const bool zr = zero != 0, vc = vec != 0, full = vc && gx0 + kRun3 <= W;
  for (int c = blockIdx.z; c < C; c += gridDim.z) {
    const float* src = x + c * plane;
    float* dst = out + c * plane;
    float r0[kRun3 + 2], r1[kRun3 + 2], r2[kRun3 + 2];
    load_row3(src, H, W, ys - 1, gx0, zr, vc, r0);
    load_row3(src, H, W, ys, gx0, zr, vc, r1);
#pragma unroll 1
    for (int y = ys; y < ye; ++y) {
      load_row3(src, H, W, y + 1, gx0, zr, vc, r2);
      float o[kRun3];
#pragma unroll
      for (int j = 0; j < kRun3; ++j) o[j] = r1_eval<kKind>(r0, r1, r2, j, mask, taps);
      float* d = dst + (size_t)y * W + gx0;
      if (full) {
        reinterpret_cast<float4*>(d)[0] = make_float4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<float4*>(d)[1] = make_float4(o[4], o[5], o[6], o[7]);
      } else {
#pragma unroll
        for (int j = 0; j < kRun3; ++j)
          if (gx0 + j < W) d[j] = o[j];
      }
#pragma unroll
      for (int k = 0; k < kRun3 + 2; ++k) {
        r0[k] = r1[k];
        r1[k] = r2[k];
      }
    }
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

// The radius-1 form: f32 (C, H, W) in and out, of a 3x3 table (w9: nine
// weights on the host, 3 dy + dx; mask: bit 3 dy + dx set for each term,
// in ascending order) or the median.  vec: x and out start on 16-byte
// boundaries and W is a multiple of 4.
extern "C" int rf_stencil_r1(const float* x, float* out, int C, int H, int W, int zero, int kind,
                             const float* w9, int mask, int vec, void* stream) {
  if (kind != rf::ST_WSUM && kind != rf::ST_MEDIAN9) return (int)cudaErrorInvalidValue;
  rf::Taps3x3 taps;
  for (int k = 0; k < 9; ++k) taps.w[k] = w9[k];
  dim3 grid((W + rf::kR1TW - 1) / rf::kR1TW, (H + rf::kR1TH - 1) / rf::kR1TH, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = kind == rf::ST_WSUM ? rf::stencil_r1_kernel<rf::ST_WSUM>
                                    : rf::stencil_r1_kernel<rf::ST_MEDIAN9>;
  kernel<<<grid, rf::kThreads, 0, s>>>(x, out, C, H, W, zero, vec, mask, taps);
  return (int)cudaGetLastError();
}
