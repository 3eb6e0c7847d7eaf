// graph_strip: a whole single-tier graph in one pass over the frame.
//
// The kernel template and its launch (graph_strip.cu: the f32 forms and
// the entry point; graph_strip_bf16.cu: the bf16 forms).
//
// Replaces pallas_ops.graph_strip_fused / _graph_strip_kernel: N
// edge-clamped separable convs of the graph input share one shared-memory
// window, then a channel-local epilogue evaluates every conv epilogue and
// pointwise node per pixel while the tile is on chip.  Only the final
// output is written to device memory.
//
// The TPU kernel's epilogue was a traced Python closure.  Here it is a
// per-graph op list built once per program (graph/program.py), passed by
// value in the kernel's parameters: each op is {code, in0, in1, out,
// plane} ints and kOpFloats float params.  Per pixel,
// slot 0 holds the input, slots 1..N the conv results, and each op writes
// its node's output slot, rounded to storage as the inter-node store would
// (bf16 round-to-nearest-even, or the rgba8 UNORM grid).  Alpha (ci == 3)
// passes through where the builtin's channel form says so.  The program
// builder numbers slots by liveness, so kMaxSlots of them hold any graph
// the planner sends here.
//
// Design (conv_tile.cuh, the register-blocked stage):
//   * The window loads once (cp.async inside the image, clamped reads at
//     its border); each plan's H pass goes to one shared buffer, and its W
//     pass leaves kConvRun outputs of each of a thread's runs (one row,
//     consecutive columns) in registers.  No conv result returns to
//     shared memory, so the tile is sep_conv_multi's.
//   * The epilogue runs op by op over groups of kGroup pixels: the slots
//     are registers (v[kMaxSlots][kGroup], read and written through
//     unrolled selects over the fixed slot count), each op decoded once a
//     group.  Results go out through the H-pass buffer, whole rows a
//     warp (coalesced stores).
//   * The grid's fastest dimension is the channel, so the four blocks of a
//     tile run together and the L2 serves the hoisted fade plane to the
//     second and third colour channel; alpha reads no plane.
//   * Compiled per plan count (1..kMaxPlans) and with and without channel
//     ops: inlined channel ops (two powf among them) cost the flagship 13%
//     when compiled into its form (PERF.md).
//
// Bound on the card: the epilogue (op dispatch, slot selects, the IEEE
// divisions' slow-path calls; half the time), then the convs, against
// 265 MB of device memory for the flagship at 4K.  The flagship at 4K on
// an H100 80GB HBM3 (700 W): 0.665 ms in rgba32f, 0.701 in rgba16f,
// against its 0.089 ms bound (1.41 before this design; PERF.md §6).
//
// Grid: (C, ceil(W / TW), ceil(H / TH)).

#pragma once

#include <cstdint>

#include "conv_tile.cuh"
#include "pixel_ops.cuh"

namespace rf {

constexpr int kMaxSlots = 4;  // value slots a pixel (cuda_ops.MAX_SLOTS)
constexpr int kMaxPlans = 3;  // convs of the input (cuda_ops.MAX_PLANS)
constexpr int kOpFloats = 8;  // cuda_ops.STRIP_OP_FLOATS
constexpr int kMaxOps = 32;   // ops of a graph (cuda_ops.MAX_OPS)
// Threads a block, and the W-pass runs each holds in registers for every
// plan until the epilogue: a tile has at most kMaxRuns * kThreads runs.
constexpr int kStripThreads = kThreads;
constexpr int kRunsPerThread = kMaxRuns * kThreads / kStripThreads;
static_assert(1 + kMaxPlans <= kMaxSlots, "the input and every conv result need a slot");

// The op list, by value in the kernel's parameters (a __grid_constant__:
// the constant bank), so the epilogue's decode of each op is a uniform
// constant load, not a device-memory read.
struct StripOp {
  int code, in0, in1, out, plane;
  float p[kOpFloats];
};
struct StripOps {
  int n;
  StripOp op[kMaxOps];
};

enum Op : int {
  OP_COPY = 0,        // in0
  OP_TAKE1 = 1,       // in1 (a conv node whose output is its blur)
  OP_UNSHARP = 2,     // rgb: in0 + p0 * (in0 - in1)
  OP_MIX = 3,         // in0 + (in1 - in0) * p0
  OP_ACES = 4,        // rgb: ACES filmic of in0 * p0
  OP_REINHARD = 5,    // rgb: Reinhard of in0 * p0
  OP_VIGNETTE = 6,    // rgb: in0 * radial fade (p0 strength, p1 radius, p2 = 1.42 - radius)
  OP_FADE_PLANE = 7,  // rgb: in0 * aux[plane]
  OP_CH0 = 8,         // OP_CH0 + k: rgb: channel op k (pixel_ops.cuh) of in0, in1
};

template <bool kChannelOps>
__device__ __forceinline__ float apply_op(int code, int ci, float a, float b, const float* p,
                                          float plane_v, int gy, int gx, int H, int W) {
  const bool rgb = ci < 3;
  switch (code) {
    case OP_COPY: return a;
    case OP_TAKE1: return b;
    case OP_UNSHARP: return rgb ? a + p[0] * (a - b) : a;
    case OP_MIX: return a + (b - a) * p[0];
    case OP_ACES: {
      if (!rgb) return a;
      const float v = a * p[0];
      return clip01((v * (2.51f * v + 0.03f)) / (v * (2.43f * v + 0.59f) + 0.14f));
    }
    case OP_REINHARD: {
      if (!rgb) return a;
      const float v = a * p[0];
      return v / (1.f + v);
    }
    case OP_VIGNETTE: {
      if (!rgb) return a;
      const float ny = ((float)gy / (float)max(H - 1, 1)) * 2.f - 1.f;
      const float nx = ((float)gx / (float)max(W - 1, 1)) * 2.f - 1.f;
      const float d = sqrtf(nx * nx + ny * ny);
      return a * (1.f - p[0] * smoothstep(p[1], p[2], d));
    }
    case OP_FADE_PLANE: return rgb ? a * plane_v : a;
  }
  if (kChannelOps && code >= OP_CH0 && code < OP_CH0 + CH_COUNT)
    return rgb ? channel_op(code - OP_CH0, ci, a, b, p, gy, gx) : a;
  return __int_as_float(0x7fc00000);  // unknown opcode: NaN, caught by the checks
}

// Pixels of one step of the epilogue: a thread's runs go through it
// kGroup pixels at a time, in a loop that is not unrolled (its code, one
// switch over the opcodes, appears once in each kernel form).
constexpr int kGroup = 4;
constexpr int kGroups = kRunsPerThread * kConvRun / kGroup;

using Slots = float[kMaxSlots][kGroup];

// c ? a : b as one PTX select.  The front end cannot see through it, so a
// chain of them over a register array never becomes an indexed access,
// which would put the array in local memory.
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\tselp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)c));
  return r;
}

// Slot s of pixel j (s uniform over the block, j unrolled).
__device__ __forceinline__ float pick(const Slots& v, int s, int j) {
  float a = v[0][j];
#pragma unroll
  for (int k = 1; k < kMaxSlots; ++k) a = select(s == k, v[k][j], a);
  return a;
}

__device__ __forceinline__ void put(Slots& v, int s, int j, float r) {
#pragma unroll
  for (int k = 0; k < kMaxSlots; ++k) v[k][j] = select(s == k, r, v[k][j]);
}

// One op over the group's pixels (gy, gx + j).  Each pixel reads both
// inputs before it writes its output slot.
template <int kCode, bool kChannelOps>
__device__ __forceinline__ void op_group(Slots& v, int in0, int in1, int to, int ci,
                                         const float* p, const float (&pv)[kGroup], int gy, int gx,
                                         int H, int W, int store) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float r = apply_op<kChannelOps>(kCode, ci, pick(v, in0, j), pick(v, in1, j), p, pv[j],
                                          gy, gx + j, H, W);
    put(v, to, j, store_round(r, store));
  }
}

// Value j of group g of a thread's runs (g runtime, j unrolled): a select
// over the groups, so the held values stay in registers.
__device__ __forceinline__ float held_at(const float (&h)[kRunsPerThread][kConvRun], int g, int j) {
  float a = h[0][j];
#pragma unroll
  for (int gg = 1; gg < kGroups; ++gg)
    a = select(g == gg, h[gg * kGroup / kConvRun][gg * kGroup % kConvRun + j], a);
  return a;
}

// At least two blocks an SM (up to 128 registers a thread): left to its
// own heuristic, ptxas held the one-plan forms to 80 registers and
// spilled around the IEEE division's slow-path calls.
template <typename T, bool kChannelOps, int kPlans>
__global__ void __launch_bounds__(kStripThreads, 2)
graph_strip_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ aux,
                   int C, int H, int W, const float* __restrict__ taps,
                   const int* __restrict__ meta, int n_taps, int RH, int RW, int TH, int TW,
                   int align, int out_slot, int store, float time, int vec, int row0, int Hg,
                   const __grid_constant__ StripOps ops) {
  extern __shared__ __align__(16) float smem[];
  const RunTile t =
      run_tile(H, W, RH, RW, TH, TW, (int)blockIdx.z * TH, (int)blockIdx.y * TW, align);
  float* win = smem;
  float* tmp = win + t.window_floats();
  float* tap_s = tmp + TH * t.tp;
  const int c = blockIdx.x;
  const size_t plane = (size_t)H * W;
  (void)time;  // no channel-local builtin reads the frame time

  load_window_async(x + c * plane, t, false, vec != 0 && align == kAlign, win);
  copy_to_shared(taps, n_taps, tap_s);
  cp_async_wait_all();
  __syncthreads();

  // the conv passes
  // W-pass runs of this thread: row r, columns from (q0 + i * q_step) * kConvRun.
  const int r = threadIdx.x % TH, q0 = threadIdx.x / TH, q_step = blockDim.x / TH;
  const int n_q = TW / kConvRun;
  float held[kPlans][kRunsPerThread][kConvRun];
#pragma unroll
  for (int k = 0; k < kPlans; ++k) {
    const int rw = meta[4 * k + 1];
    if (k > 0) __syncthreads();  // plan k - 1's W passes are done with tmp
    h_pass_runs(win, tap_s + meta[4 * k + 2], meta[4 * k], t, tmp);
    __syncthreads();
    const float* ww = tap_s + meta[4 * k + 3];
#pragma unroll
    for (int i = 0; i < kRunsPerThread; ++i) {
      const int q = q0 + i * q_step;
      if (q < n_q)
        run_conv(tmp + r * t.tp + q * kConvRun + (RW - rw), 1, 2 * rw + 1, ww, held[k][i]);
    }
  }
  __syncthreads();  // tmp stages the output tile from here

  // the epilogue
  const float zeros[kGroup] = {};
  const float unknown = __int_as_float(0x7fc00000);
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const int q = q0 + g * kGroup / kConvRun * q_step;
    const int c0 = q * kConvRun + g * kGroup % kConvRun;  // tile column of the group
    const int gy = t.y0 + r, gx = t.x0 + c0;
    if (q >= n_q || gy >= H || gx >= W) continue;
    const int yy = row0 + gy;  // the image row of the slab's row gy
    Slots v;
    const float* xc = win + (RH + r) * t.wp + t.lo + RW + c0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      v[0][j] = xc[j];
#pragma unroll
      for (int k = 0; k < kPlans; ++k) v[1 + k][j] = held_at(held[k], g, j);
#pragma unroll
      for (int k = 1 + kPlans; k < kMaxSlots; ++k) v[k][j] = 0.f;
    }
    for (int n = 0; n < ops.n; ++n) {
      const StripOp& o = ops.op[n];
      const int code = o.code, in0 = o.in0, in1 = o.in1, to = o.out, pl = o.plane;
      const float* p = o.p;
#define RF_OP(CODE, PV) \
  op_group<CODE, kChannelOps>(v, in0, in1, to, c, p, PV, yy, gx, Hg, W, store)
#define RF_CH(K) \
  case OP_CH0 + K: RF_OP(OP_CH0 + K, zeros); break;
      static_assert(CH_COUNT == 14, "one case per channel op");
      switch (code) {
        case OP_COPY: RF_OP(OP_COPY, zeros); break;
        case OP_TAKE1: RF_OP(OP_TAKE1, zeros); break;
        case OP_UNSHARP: RF_OP(OP_UNSHARP, zeros); break;
        case OP_MIX: RF_OP(OP_MIX, zeros); break;
        case OP_ACES: RF_OP(OP_ACES, zeros); break;
        case OP_REINHARD: RF_OP(OP_REINHARD, zeros); break;
        case OP_VIGNETTE: RF_OP(OP_VIGNETTE, zeros); break;
        case OP_FADE_PLANE: {
          // the hoisted plane's values of the group (colour channels only)
          float pv[kGroup];
          const float* row = aux + (pl >= 0 ? pl * plane : 0) + (size_t)gy * W + gx;
          if (c < 3 && pl >= 0 && vec && gx + kGroup <= W) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(row));
            pv[0] = a.x, pv[1] = a.y, pv[2] = a.z, pv[3] = a.w;
          } else {
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              pv[j] = c < 3 && pl >= 0 && gx + j < W ? __ldg(row + j) : 0.f;
          }
          RF_OP(OP_FADE_PLANE, pv);
          break;
        }
        RF_CH(0) RF_CH(1) RF_CH(2) RF_CH(3) RF_CH(4) RF_CH(5) RF_CH(6)
        RF_CH(7) RF_CH(8) RF_CH(9) RF_CH(10) RF_CH(11) RF_CH(12) RF_CH(13)
        default:  // an unknown opcode: NaN, caught by the checks
#pragma unroll
          for (int j = 0; j < kGroup; ++j) put(v, to, j, store_round(unknown, store));
      }
#undef RF_CH
#undef RF_OP
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) tmp[r * t.tp + c0 + j] = pick(v, out_slot, j);
  }
  __syncthreads();
  store_tile(tmp, t, out + c * plane);
}

template <typename T, bool kChannelOps, int kPlans>
static int launch(const void* x, void* out, const float* aux, int C, int H, int W,
                  const float* taps, const int* meta, int n_taps, int RH, int RW, int TH, int TW,
                  int align, int out_slot, int store, float time, int row0, int Hg, int smem,
                  cudaStream_t stream, const StripOps& ops) {
  auto kernel = graph_strip_kernel<T, kChannelOps, kPlans>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // cp.async and the plane's float4 loads need 16-byte rows: x and aux
  // aligned, W a multiple of 8
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(aux) % 16 == 0 && W % 8 == 0;
  dim3 grid(C, (W + TW - 1) / TW, (H + TH - 1) / TH);
  kernel<<<grid, kStripThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                                aux, C, H, W, taps, meta, n_taps, RH, RW, TH, TW,
                                                align, out_slot, store, time, vec, row0, Hg,
                                                ops);
  return (int)cudaGetLastError();
}

// The launch of the form for storage type T: plan count n_plans, with or
// without channel ops (graph_strip.cu and graph_strip_bf16.cu instantiate
// it, one storage type each, so that nvcc compiles the two in parallel).
template <typename T>
int launch_strip(int channel_ops, int n_plans, const void* x, void* out, const float* aux, int C,
                 int H, int W, const float* taps, const int* meta, int n_taps, int RH, int RW,
                 int TH, int TW, int align, int out_slot, int store, float time, int row0,
                 int Hg, int smem, cudaStream_t s, const StripOps& ops) {
  static_assert(kMaxPlans == 3, "one case per plan count");
  auto go = [&](auto launcher) {
    return launcher(x, out, aux, C, H, W, taps, meta, n_taps, RH, RW, TH, TW, align, out_slot,
                    store, time, row0, Hg, smem, s, ops);
  };
  const int form = 2 * (n_plans - 1) + (channel_ops != 0);
  switch (form) {
    case 0: return go(launch<T, false, 1>);
    case 1: return go(launch<T, true, 1>);
    case 2: return go(launch<T, false, 2>);
    case 3: return go(launch<T, true, 2>);
    case 4: return go(launch<T, false, 3>);
    case 5: return go(launch<T, true, 3>);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_strip_f32(int channel_ops, int n_plans, const void* x, void* out, const float* aux,
                     int C, int H, int W, const float* taps, const int* meta, int n_taps, int RH,
                     int RW, int TH, int TW, int align, int out_slot, int store, float time,
                     int row0, int Hg, int smem, cudaStream_t s, const StripOps& ops);
int launch_strip_bf16(int channel_ops, int n_plans, const void* x, void* out, const float* aux,
                      int C, int H, int W, const float* taps, const int* meta, int n_taps, int RH,
                      int RW, int TH, int TW, int align, int out_slot, int store, float time,
                      int row0, int Hg, int smem, cudaStream_t s, const StripOps& ops);

}  // namespace rf
