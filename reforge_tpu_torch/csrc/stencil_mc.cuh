// stencil_apply_mc's run forms (stencil_mc.cu: the f32 forms, the general
// form and the entry point; stencil_mc_bf16.cu: the bf16 forms).
//
// A run form serves a table of 1-4 input and 1-4 output channels at radii
// 1-3 on each axis, templated on the storage type, the W radius RW, the
// output channels CO and whether the table has every term (kMasked
// false) or some absent (kMasked true: one bit a (o, c, dy, dx)).
//
//   * Persistent blocks, two an SM (the occupancy API sizes the grid), walk
//     the 32 x 64 output tiles.  A tile's window of every input channel
//     lies in shared memory as f32 in rows of odd pitch; the next tile's
//     window is copied while this one computes: 4 bytes a lane by
//     cp.async for f32 (clamped or zero-filled at the border), through
//     registers for bf16 (widened to f32; cp.async cannot convert).
//   * A warp's lanes sit on the tile's 32 rows (the odd pitch puts their
//     reads on 32 banks) and each thread makes kMcRun consecutive outputs
//     of its row for every output channel: CO x kMcRun independent chains
//     in registers.  For each input channel c and window row dy (both
//     loops rolled) it loads the row's kMcRun + 2RW window values into
//     registers once, then, unrolled, for each dx and o runs one rounded
//     multiply and one rounded add into acc[o][j] for its kMcRun outputs.
//     A weight is one shared-memory broadcast (16-byte loads of the row's
//     CO x (2RW+1) weights) a (o, c, dy, dx) for kMcRun outputs; the
//     masked form tests one warp-uniform bit there.  No offsets are
//     loaded: every tap is a register.
//   * Each warp stores its own outputs through a staging area of its own
//     (store_mc_runs), so a tile costs the block one barrier.
//   * Each output adds its terms in ascending (c, dy, dx) from -0 (the
//     additive identity: the bits of a chain that starts at its first
//     term), every product and sum rounded on its own, so it is bit-equal
//     to the general form and to the plain version; an output channel
//     with no terms starts, and stays, at +0.
//
// Dynamic shared memory, in order: the weights (a row of kRowW floats, o
// major then dx, for each (c, dy)), the masks (an int a (c, dy): bit
// o (2RW+1) + dx), each warp's staging area (32 rows at pitch kMcStage),
// and two windows of C_in planes of (32 + 2RH) rows at pitch kPitch
// (cuda_ops.stencil_mc_run_footprint).

#pragma once

#include "conv_tile.cuh"

namespace rf {

constexpr int kMcRun = 8;                        // outputs a thread, along a row
constexpr int kMcTH = 32;                        // tile rows: a warp's lanes
constexpr int kMcTW = kMcRun * (kThreads / 32);  // tile columns: a run a warp
constexpr int kMcMaxC = 4;                       // input and output channels
constexpr int kMcMaxR = 3;                       // radius on each axis

template <int RW, int CO>
struct McRun {
  static constexpr int kKW = 2 * RW + 1;
  static constexpr int kRowW = (CO * kKW + 3) / 4 * 4;  // a (c, dy)'s weights, padded
  static constexpr int kCols = kMcTW + 2 * RW;
  static constexpr int kPitch = kCols | 1;
};

// Starts the copy of the window of the tile at (y0, x0): image (y0 - RH +
// r, x0 - RW + col) of channel ch at window ch plane + r kPitch + col,
// through the clamped coordinate (edge) or 0 outside (zero).  Consecutive
// threads take consecutive columns of a row.
template <typename T, int RW>
__device__ __forceinline__ void issue_mc_window(const T* __restrict__ x, int C_in, int H, int W,
                                                int RH, int y0, int x0, bool zero, int plane,
                                                float* __restrict__ win) {
  using G = McRun<RW, 1>;
  const size_t hw = (size_t)H * W;
  const int n = (kMcTH + 2 * RH) * G::kCols, gy0 = y0 - RH, xs = x0 - RW;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / G::kCols, col = i - r * G::kCols;
    const int gy = gy0 + r, gx = xs + col;
    const bool fill = zero && !(gy >= 0 && gy < H && gx >= 0 && gx < W);
    const T* s = x + (size_t)min(max(gy, 0), H - 1) * W + min(max(gx, 0), W - 1);
    float* d = win + r * G::kPitch + col;
#pragma unroll
    for (int ch = 0; ch < kMcMaxC; ++ch) {
      if (ch < C_in) {
        if constexpr (std::is_same_v<T, float>)
          cp_async4(d + ch * plane, s + ch * hw, fill);
        else
          d[ch * plane] = fill ? 0.f : to_f32(s[ch * hw]);
      }
    }
  }
}

// acc[o][j]: output (y0 + lane, x0 + warp kMcRun + j) of channel o of
// the tile whose window is `win`.  Threads past the image's edge compute
// from clamped window cells; their outputs are not stored.
template <int RW, int CO, bool kMasked>
__device__ __forceinline__ void mc_run_terms(const float* __restrict__ win,
                                             const float* __restrict__ w_s,
                                             const int* __restrict__ mask_s, int C_in, int RH,
                                             int plane, int nonempty, float (&acc)[CO][kMcRun]) {
  using G = McRun<RW, CO>;
  constexpr int KW = G::kKW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KH = 2 * RH + 1;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
#pragma unroll
    for (int j = 0; j < kMcRun; ++j) acc[o][j] = (nonempty >> o & 1) ? -0.f : 0.f;
  }
  // Window (lane + dy, warp kMcRun + j + dx) of channel c is term (c, dy, dx) of output j.
  const float* base = win + lane * G::kPitch + warp * kMcRun;
#pragma unroll 1
  for (int c = 0; c < C_in; ++c) {
#pragma unroll 1
    for (int dy = 0; dy < KH; ++dy) {
      const int row = c * KH + dy;
      const float* src = base + c * plane + dy * G::kPitch;
      float v[kMcRun + 2 * RW], w[G::kRowW];
#pragma unroll
      for (int k = 0; k < kMcRun + 2 * RW; ++k) v[k] = src[k];
#pragma unroll
      for (int q = 0; q < G::kRowW / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(w_s + row * G::kRowW)[q];
        w[4 * q] = f.x;
        w[4 * q + 1] = f.y;
        w[4 * q + 2] = f.z;
        w[4 * q + 3] = f.w;
      }
      const int m = kMasked ? mask_s[row] : 0;
#pragma unroll
      for (int dx = 0; dx < KW; ++dx) {
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          if (!kMasked || (m >> (o * KW + dx) & 1)) {
#pragma unroll
            for (int j = 0; j < kMcRun; ++j)
              acc[o][j] = __fadd_rn(acc[o][j], __fmul_rn(v[j + dx], w[o * KW + dx]));
          }
        }
      }
    }
  }
}

// A warp's outputs (32 rows of kMcRun columns, CO channels) leave through
// a staging area of its own, a channel at a time: each lane puts its run
// there (lanes on rows, at the odd pitch kMcStage: distinct banks), and
// after a __syncwarp the lanes store 32 / kMcRun rows an instruction,
// whole 32-byte sectors in f32 (pairs of bf16 where the rows are
// aligned, vec).  No other warp waits for it.  Stored straight from a
// thread's registers, a warp's store would touch 32 rows, half a sector
// a lane.
constexpr int kMcStage = kMcRun | 1;

template <typename T, int CO>
__device__ __forceinline__ void store_mc_runs(const float (&acc)[CO][kMcRun],
                                              float* __restrict__ st, T* __restrict__ out, int H,
                                              int W, int y0, int x0, bool vec) {
  const int lane = threadIdx.x & 31;
  const size_t hw = (size_t)H * W;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    __syncwarp();  // the previous channel is read
#pragma unroll
    for (int j = 0; j < kMcRun; ++j) st[lane * kMcStage + j] = acc[o][j];
    __syncwarp();
    T* plane = out + o * hw;
    if (std::is_same_v<T, __nv_bfloat16> && vec && x0 + kMcRun <= W) {
      constexpr int kPairs = kMcRun / 2, kRows = 32 / kPairs;
#pragma unroll
      for (int k = 0; k < kMcTH / kRows; ++k) {
        const int r = k * kRows + lane / kPairs, c = 2 * (lane % kPairs);
        if (y0 + r < H)
          *reinterpret_cast<__nv_bfloat162*>(plane + (size_t)(y0 + r) * W + x0 + c) =
              __floats2bfloat162_rn(st[r * kMcStage + c], st[r * kMcStage + c + 1]);
      }
    } else {
      constexpr int kRows = 32 / kMcRun;
#pragma unroll
      for (int k = 0; k < kMcTH / kRows; ++k) {
        const int r = k * kRows + lane / kMcRun, c = lane % kMcRun;
        if (y0 + r < H && x0 + c < W)
          plane[(size_t)(y0 + r) * W + x0 + c] = from_f32<T>(st[r * kMcStage + c]);
      }
    }
  }
}

// Persistent blocks: block b makes tiles b, b + gridDim.x, ... (row-major
// over tiles_x columns of tiles), each tile's window copied while the
// tile before it computes: one barrier a tile.  w_g, mask_g: the weight
// rows and masks of the shared-memory layout above; nonempty: bit o set
// where output channel o has a term.
template <typename T, int RW, int CO, bool kMasked>
__global__ void __launch_bounds__(kThreads, 2)
stencil_mc_run_kernel(const T* __restrict__ x, T* __restrict__ out, int C_in, int H, int W,
                      int RH, int zero, int vec, const float* __restrict__ w_g,
                      const int* __restrict__ mask_g, int nonempty, int tiles_x, int n_tiles) {
  using G = McRun<RW, CO>;
  extern __shared__ __align__(16) float mc_smem[];
  const int n_rows = C_in * (2 * RH + 1);
  const int plane = (kMcTH + 2 * RH) * G::kPitch, window = C_in * plane;
  float* w_s = mc_smem;
  int* mask_s = reinterpret_cast<int*>(w_s + n_rows * G::kRowW);
  float* stage = reinterpret_cast<float*>(mask_s + n_rows) + (threadIdx.x >> 5) * kMcTH * kMcStage;
  float* win0 = reinterpret_cast<float*>(mask_s + n_rows) + kThreads / 32 * kMcTH * kMcStage;
  copy_to_shared(w_g, n_rows * G::kRowW, w_s);
  for (int i = threadIdx.x; i < n_rows; i += kThreads) mask_s[i] = mask_g[i];
  auto issue = [&](int tile, float* win) {
    if (tile >= n_tiles) return;
    const int ty = tile / tiles_x;
    issue_mc_window<T, RW>(x, C_in, H, W, RH, ty * kMcTH, (tile - ty * tiles_x) * kMcTW,
                           zero != 0, plane, win);
  };
  issue(blockIdx.x, win0);
  cp_async_commit();
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    cp_async_wait<0>();
    __syncthreads();  // this tile's window is in; no warp reads the other one
    issue(tile + gridDim.x, win0 + ((i + 1) & 1) * window);
    cp_async_commit();
    float acc[CO][kMcRun];
    mc_run_terms<RW, CO, kMasked>(win0 + (i & 1) * window, w_s, mask_s, C_in, RH, plane,
                                  nonempty, acc);
    const int ty = tile / tiles_x;
    store_mc_runs<T, CO>(acc, stage, out, H, W, ty * kMcTH,
                         (tile - ty * tiles_x) * kMcTW + (threadIdx.x >> 5) * kMcRun, vec != 0);
  }
}

// Shared-memory bytes of the form (cuda_ops.stencil_mc_run_footprint).
template <int RW, int CO>
__host__ __device__ constexpr int mc_run_bytes(int C_in, int RH) {
  using G = McRun<RW, CO>;
  const int n_rows = C_in * (2 * RH + 1);
  return 4 * (n_rows * G::kRowW + n_rows + kThreads / 32 * kMcTH * kMcStage +
              2 * C_in * (kMcTH + 2 * RH) * G::kPitch);
}

template <typename T, int RW, int CO, bool kMasked>
static int launch_mc_form(const void* x, void* out, int C_in, int H, int W, int RH, int zero,
                          int vec, const float* w, const int* mask, int nonempty, int smem,
                          cudaStream_t s) {
  if (smem != mc_run_bytes<RW, CO>(C_in, RH)) return (int)cudaErrorInvalidValue;
  auto kernel = stencil_mc_run_kernel<T, RW, CO, kMasked>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kMcTW - 1) / kMcTW;
  const int n_tiles = tiles_x * ((H + kMcTH - 1) / kMcTH);
  const int blocks = min(n_tiles, max(per_sm, 1) * n_sms);
  kernel<<<blocks, kThreads, smem, s>>>(static_cast<const T*>(x), static_cast<T*>(out), C_in, H,
                                        W, RH, zero, vec, w, mask, nonempty, tiles_x, n_tiles);
  return (int)cudaGetLastError();
}

// The form of (RW, CO, masked) for storage type T: RW in 1..kMcMaxR, CO
// in 1..kMcMaxC (the caller checks).
template <typename T>
int launch_mc_run(const void* x, void* out, int C_in, int CO, int H, int W, int RH, int RW,
                  int zero, int vec, int masked, const float* w, const int* mask, int nonempty,
                  int smem, cudaStream_t s) {
#define RF_MC_FORM(R, C)                                                                        \
  if (RW == R && CO == C)                                                                       \
    return masked ? launch_mc_form<T, R, C, true>(x, out, C_in, H, W, RH, zero, vec, w, mask,   \
                                                  nonempty, smem, s)                            \
                  : launch_mc_form<T, R, C, false>(x, out, C_in, H, W, RH, zero, vec, w, mask,  \
                                                   nonempty, smem, s);
  RF_MC_FORM(1, 1) RF_MC_FORM(1, 2) RF_MC_FORM(1, 3) RF_MC_FORM(1, 4)
  RF_MC_FORM(2, 1) RF_MC_FORM(2, 2) RF_MC_FORM(2, 3) RF_MC_FORM(2, 4)
  RF_MC_FORM(3, 1) RF_MC_FORM(3, 2) RF_MC_FORM(3, 3) RF_MC_FORM(3, 4)
#undef RF_MC_FORM
  return (int)cudaErrorInvalidValue;
}

int launch_mc_run_f32(const void* x, void* out, int C_in, int CO, int H, int W, int RH, int RW,
                      int zero, int vec, int masked, const float* w, const int* mask,
                      int nonempty, int smem, cudaStream_t s);
int launch_mc_run_bf16(const void* x, void* out, int C_in, int CO, int H, int W, int RH, int RW,
                       int zero, int vec, int masked, const float* w, const int* mask,
                       int nonempty, int smem, cudaStream_t s);

}  // namespace rf
