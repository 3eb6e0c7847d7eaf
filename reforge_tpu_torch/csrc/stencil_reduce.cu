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
// Three forms, chosen by shape before the launch
// (cuda_ops.choose_reduce_form):
//
//   * The run form (stencil_reduce_run_kernel<R, kDense>, radii 1-8 with
//     rh == rw, a tap list in row-major (dy, dx) order; kDense where it
//     holds every tap of the window, so no tap mask is tested): persistent
//     blocks, two an SM, walk the 32 x 64 output tiles.  A tile's window
//     of four channels is copied 4 bytes a lane by cp.async into rows of
//     odd pitch (clamped or zero-filled at the border), the next tile's
//     while this one computes where two windows fit (radii 1-5).  A
//     warp's lanes sit on the tile's 32 rows (the odd pitch puts their
//     reads on 32 banks) and each thread makes kReduceRun consecutive
//     outputs of its row: for each window row dy it slides a register
//     window of kReduceRun + 2R values of each channel across the row's
//     taps, so a window value loads from shared memory once a row, not
//     once a tap.  Offsets are immediates; a tap's weight comes from
//     shared memory once a run.  Each output adds its taps from -0 (the
//     additive identity: the bits of a chain that starts at its first
//     tap) in list order, so it is bit-equal to the other forms and to
//     the plain version's order.
//   * The shared form (stencil_reduce_kernel<true>), any other tap list
//     whose tile plus (RH, RW) halo of all four channels fits shared
//     memory (cuda_ops.choose_reduce_tile): the window loads with clamped
//     or zero-filled scalar reads (conv_tile.cuh load_window) beside the
//     tap table, and each thread runs the list from there, a pixel at a
//     time.
//   * The global form (stencil_reduce_kernel<false>), a radius whose tile
//     fits nowhere: the same loop with every tap read through the clamped
//     (or zero-filled) global coordinate, from L1/L2.
//
// Bound on the card: issue slots.  A tap and pixel needs a difference, a
// square, a scale, expf (8 SASS instructions around its MUFU.EX2 in a
// loop on sm_90a, read with cuobjdump -sass), the spatial weight, three
// products and four sums: 19 instructions, against 28 bytes of device
// memory per pixel for all taps together.  The range weight of tap o at
// pixel p equals that of tap -o at pixel p + o (the difference only
// changes sign), so the least work counts it once a pair: about 13.  The
// run form issues close to the first count (its loop: 20 a tap and pixel
// with its shared loads, cuobjdump -sass), the shared form about 32 (its
// loop's loads and
// indexing); a window copied before the tile's work and not beside it
// cost the run form a sixth of its time (the window load cut out, on
// the card).  PERF.md §6 has the times.
//
// Tap positions arrive as two int arrays, dy then dx, each in 0..2R (the
// shared and global forms), or as a weight table of (2R+1)^2 and a mask
// of each row's taps (the run form).  Grid: (ceil(W / TW), ceil(H / TH)),
// or the run form's persistent blocks.

#include "conv_tile.cuh"

namespace rf {

enum ReduceKind : int { RD_BILATERAL = 0 };

// The range weight times the spatial weight of a tap whose luma is n3,
// at a pixel whose luma is c3.
__device__ __forceinline__ float bilateral_weight(float n3, float c3, float ws, float inv2sr) {
  const float d = __fsub_rn(n3, c3);
  return __fmul_rn(expf(__fmul_rn(-__fmul_rn(d, d), inv2sr)), ws);
}

// acc (re)starts at tap 0's contribution when `first`, as the plain
// version's `acc = t if acc is None else acc + t`.
__device__ __forceinline__ void bilateral_tap(const float* v, float c3, float ws, float inv2sr,
                                              bool first, float* acc) {
  const float wr = bilateral_weight(v[3], c3, ws, inv2sr);
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

// ---- the run form ------------------------------------------------------------------

constexpr int kReduceRun = 8;                            // outputs a thread, along a row
constexpr int kReduceTH = 32;                            // tile rows: a warp's lanes
constexpr int kReduceTW = kReduceRun * (kThreads / 32);  // tile columns: a run a warp
// Shared memory a run-form block may take (cuda_ops.REDUCE_RUN_SMEM): two
// blocks an SM, beside the 1 KB the SM keeps for each.
constexpr int kReduceRunSmem = 110 * 1024;

// Window geometry of radius R: image column x0 - R sits at window column
// lo, so that window column 0 is a multiple of 4 (x0 is); n4 chunks of 4
// columns a row, at the odd pitch 4 n4 | 1.  Two window buffers where both
// fit kReduceRunSmem beside the tables (the next tile's window loads while
// this one's is read), else one (cuda_ops.reduce_run_footprint).
template <int R>
struct RunWindow {
  static constexpr int kD = 2 * R + 1;
  static constexpr int kLo = (4 - R % 4) % 4;
  static constexpr int kN4 = (kLo + kReduceTW + 2 * R + 3) / 4;
  static constexpr int kPitch = (4 * kN4) | 1;
  static constexpr int kRows = kReduceTH + 2 * R;
  static constexpr int kPlane = kRows * kPitch;  // one channel
  static constexpr int kTables = kD * kD + kD;   // the weights and the row masks
  static constexpr int kBuffers = 4 * (2 * 4 * kPlane + kTables) <= kReduceRunSmem ? 2 : 1;
  static constexpr int kBytes = 4 * (kBuffers * 4 * kPlane + kTables);
};

// Starts the copy of the window of the tile at (y0, x0), all four channels:
// image (y0 - R + r, x0 - R - lo + c) of channel ch at window ch kPlane +
// r kPitch + c, through the clamped coordinate (edge) or 0 outside (zero).
// Rows by warps, columns by lanes: a warp reads whole lines and writes
// consecutive banks.
template <int R>
__device__ __forceinline__ void issue_run_window(const float* __restrict__ x, int H, int W, int y0,
                                                 int x0, bool zero, float* __restrict__ win) {
  using G = RunWindow<R>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t plane = (size_t)H * W;
  const int gy0 = y0 - R, xs = x0 - R - G::kLo;
  for (int r = warp; r < G::kRows; r += kThreads / 32) {
    const int gy = gy0 + r;
    const bool row_in = gy >= 0 && gy < H;
    const float* src = x + (size_t)min(max(gy, 0), H - 1) * W;
    float* dst = win + r * G::kPitch;
    for (int c = lane; c < 4 * G::kN4; c += 32) {
      const int gx = xs + c;
      const bool fill = zero && !(row_in && gx >= 0 && gx < W);
      const float* s = src + min(max(gx, 0), W - 1);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) cp_async4(dst + c + ch * G::kPlane, s + ch * plane, fill);
    }
  }
}

// The outputs of one tile from its window.  kDense: the list has every tap
// of the window (no row mask to test).
template <int R, bool kDense>
__device__ __forceinline__ void reduce_run_tile(const float* __restrict__ win,
                                                const float* __restrict__ w_s,
                                                const int* __restrict__ rows_s,
                                                float* __restrict__ out, int H, int W, int y0,
                                                int x0, bool vec, float inv2sr) {
  using G = RunWindow<R>;
  constexpr int D = G::kD;
  // lane: tile row; warp: a run of kReduceRun columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gy = y0 + lane, gx0 = x0 + warp * kReduceRun;
  if (gy >= H || gx0 >= W) return;
  // Window (lane + dy, lo + warp kReduceRun + j + dx) is tap (dy, dx) of output j.
  const float* base = win + lane * G::kPitch + G::kLo + warp * kReduceRun;
  float c3[kReduceRun], acc[4][kReduceRun];
#pragma unroll
  for (int j = 0; j < kReduceRun; ++j) {
    c3[j] = base[3 * G::kPlane + R * G::kPitch + R + j];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c][j] = -0.f;
  }
#pragma unroll 1
  for (int dy = 0; dy < D; ++dy) {
    const int row = kDense ? 0 : rows_s[dy];
    const float* src = base + dy * G::kPitch;
    const float* ws_row = w_s + dy * D;
    // v[c][k]: window column k of this row; column kReduceRun - 1 + dx
    // loads at tap dx, once its outputs need it.
    float v[4][kReduceRun + 2 * R];
#pragma unroll
    for (int k = 0; k < kReduceRun - 1; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c][k] = src[c * G::kPlane + k];
    }
#pragma unroll
    for (int dx = 0; dx < D; ++dx) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c][kReduceRun - 1 + dx] = src[c * G::kPlane + kReduceRun - 1 + dx];
      if (kDense || (row >> dx & 1)) {
        const float ws = ws_row[dx];
#pragma unroll
        for (int j = 0; j < kReduceRun; ++j) {
          const float wr = bilateral_weight(v[3][j + dx], c3[j], ws, inv2sr);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            acc[c][j] = __fadd_rn(acc[c][j], __fmul_rn(v[c][j + dx], wr));
          acc[3][j] = __fadd_rn(acc[3][j], wr);
        }
      }
    }
  }
  const size_t plane = (size_t)H * W;
  float* dst = out + (size_t)gy * W + gx0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float o[kReduceRun];
#pragma unroll
    for (int j = 0; j < kReduceRun; ++j) o[j] = __fdiv_rn(acc[c][j], acc[3][j]);
    float* d = dst + c * plane;
    if (vec && gx0 + kReduceRun <= W) {
#pragma unroll
      for (int q = 0; q < kReduceRun / 4; ++q)
        reinterpret_cast<float4*>(d)[q] =
            make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < kReduceRun; ++j)
        if (gx0 + j < W) d[j] = o[j];
    }
  }
}

// Persistent blocks: block b makes tiles b, b + gridDim.x, ... (row-major
// over tiles_x columns of tiles), each tile's window copied by cp.async
// while the tile before it computes where two buffers fit.  w_g: the
// spatial weight of tap (dy, dx) at dy (2R + 1) + dx (0 where the list
// lacks it); rows_g: bit dx of row dy set where it has it.
template <int R, bool kDense>
__global__ void __launch_bounds__(kThreads, 2)
stencil_reduce_run_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W,
                          int zero, int vec, const float* __restrict__ w_g,
                          const int* __restrict__ rows_g, float inv2sr, int tiles_x,
                          int n_tiles) {
  using G = RunWindow<R>;
  constexpr int D = G::kD, kWin = 4 * G::kPlane;
  extern __shared__ float smem[];
  float* w_s = smem + G::kBuffers * kWin;
  int* rows_s = reinterpret_cast<int*>(w_s + D * D);
  copy_to_shared(w_g, D * D, w_s);
  for (int i = threadIdx.x; i < D; i += kThreads) rows_s[i] = rows_g[i];
  auto issue = [&](int tile, float* win) {
    if (tile >= n_tiles) return;
    const int ty = tile / tiles_x;
    issue_run_window<R>(x, H, W, ty * kReduceTH, (tile - ty * tiles_x) * kReduceTW, zero != 0,
                        win);
  };
  issue(blockIdx.x, smem);
  cp_async_commit();
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    float* win = smem + (i % G::kBuffers) * kWin;
    if constexpr (G::kBuffers == 2) {
      issue(tile + gridDim.x, smem + ((i + 1) & 1) * kWin);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int ty = tile / tiles_x;
    reduce_run_tile<R, kDense>(win, w_s, rows_s, out, H, W, ty * kReduceTH,
                               (tile - ty * tiles_x) * kReduceTW, vec != 0, inv2sr);
    __syncthreads();  // the window is read: it may be refilled
    if constexpr (G::kBuffers == 1) {
      issue(tile + gridDim.x, smem);
      cp_async_commit();
    }
  }
}

template <int R, bool kDense>
static int launch_run(const float* x, float* out, int H, int W, int zero, int vec, const float* w,
                      const int* rows, float inv2sr, int smem, int n_sms, cudaStream_t s) {
  if (smem != RunWindow<R>::kBytes || n_sms < 1) return (int)cudaErrorInvalidValue;
  auto kernel = stencil_reduce_run_kernel<R, kDense>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kReduceTW - 1) / kReduceTW;
  const int n_tiles = tiles_x * ((H + kReduceTH - 1) / kReduceTH);
  const int blocks = min(n_tiles, max(per_sm, 1) * n_sms);
  kernel<<<blocks, kThreads, smem, s>>>(x, out, H, W, zero, vec, w, rows, inv2sr, tiles_x,
                                        n_tiles);
  return (int)cudaGetLastError();
}

template <int R>
static int launch_radius(const float* x, float* out, int H, int W, int zero, int vec, int dense,
                         const float* w, const int* rows, float inv2sr, int smem, int n_sms,
                         cudaStream_t s) {
  return dense ? launch_run<R, true>(x, out, H, W, zero, vec, w, rows, inv2sr, smem, n_sms, s)
               : launch_run<R, false>(x, out, H, W, zero, vec, w, rows, inv2sr, smem, n_sms, s);
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

// The run form: radius R in 1..8 (the compiled forms), f32 (4, H, W) in,
// (3, H, W) out; w: (2R+1)^2 spatial weights and rows: 2R+1 tap masks, on
// the device; dense: every tap of the window is in the list; smem: the
// form's window buffers and tables (cuda_ops.reduce_run_footprint); n_sms:
// the card's SMs.  vec: x and out start on 16-byte boundaries and W is a
// multiple of 4.
extern "C" int rf_stencil_reduce_run(const float* x, float* out, int H, int W, int R, int zero,
                                     int vec, int dense, const float* w, const int* rows,
                                     float inv2sr, int smem, int n_sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RF_RADIUS(K) \
  case K:            \
    return rf::launch_radius<K>(x, out, H, W, zero, vec, dense, w, rows, inv2sr, smem, n_sms, s);
  switch (R) {
    RF_RADIUS(1) RF_RADIUS(2) RF_RADIUS(3) RF_RADIUS(4)
    RF_RADIUS(5) RF_RADIUS(6) RF_RADIUS(7) RF_RADIUS(8)
  }
#undef RF_RADIUS
  return (int)cudaErrorInvalidValue;
}
