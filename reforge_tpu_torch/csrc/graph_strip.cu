// graph_strip: a whole single-tier graph in one pass over the frame.
//
// Replaces pallas_ops.graph_strip_fused / _graph_strip_kernel: N
// edge-clamped separable convs of the graph input share one shared-memory
// window (conv_tile.cuh), then a channel-local epilogue evaluates every
// conv epilogue and pointwise node per pixel while the tile is on chip.
// Only the final output is written to device memory.
//
// The TPU kernel's epilogue was a traced Python closure.  Here it is a
// per-graph op list built once per program (graph/program.py): each op is
// {code, in0, in1, out, plane} ints and kOpFloats float params.  Per pixel, slot
// 0 holds the input, slots 1..N the conv results, and each op writes its
// node's output slot, rounded to storage as the inter-node store would
// (bf16 round-to-nearest-even, or the rgba8 UNORM grid).  Alpha (ci == 3)
// passes through where the builtin's channel form says so.
//
// Grid: (ceil(W / TW), ceil(H / TH), C); one channel plane per block.

#include "conv_tile.cuh"
#include "pixel_ops.cuh"

namespace rf {

constexpr int kMaxSlots = 32;
constexpr int kOpFloats = 8;  // cuda_ops.STRIP_OP_FLOATS

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

// kChannelOps: the op list holds channel ops.  A graph without them takes
// the kernel compiled without them: compiled in, their code (two powf
// among it) moves nvcc's register allocation of the whole kernel (40 to 32
// registers), which cost the flagship's graph_strip 13% on the card
// (PERF.md).
template <bool kChannelOps>
__device__ float apply_op(int code, int ci, float a, float b, const float* p, float plane_v,
                          int gy, int gx, int H, int W) {
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

template <typename T, bool kChannelOps>
__global__ void __launch_bounds__(kThreads)
graph_strip_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ aux,
                   int C, int H, int W, const float* __restrict__ taps,
                   const int* __restrict__ meta, int n_plans, int n_taps, int RH, int RW, int TH,
                   int TW, const int* __restrict__ op_i, const float* __restrict__ op_f,
                   int n_ops, int out_slot, int store, float time) {
  extern __shared__ float smem[];
  Tile t{H, W, RH, RW, TH, TW, (int)blockIdx.y * TH, (int)blockIdx.x * TW};
  float* win = smem;
  float* tmp = win + t.wrows() * t.wcols();
  float* tap_s = tmp + TH * t.wcols();
  float* blur = tap_s + n_taps;  // n_plans planes of TH * TW
  const int c = blockIdx.z;
  const size_t plane = (size_t)H * W;
  (void)time;  // no channel-local builtin reads the frame time

  copy_to_shared(taps, n_taps, tap_s);
  load_window(x + c * plane, t, false, win);
  __syncthreads();

  for (int k = 0; k < n_plans; ++k) {
    const int rw = meta[4 * k + 1];
    h_pass(win, tap_s + meta[4 * k + 2], meta[4 * k], t, tmp);
    __syncthreads();
    const float* ww = tap_s + meta[4 * k + 3];
    for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
      const int y = i / TW;
      blur[k * TH * TW + i] = w_at(tmp, ww, rw, t, y, i - y * TW);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
    const int y = i / TW, xx = i - y * TW;
    const int gy = t.y0 + y, gx = t.x0 + xx;
    if (gy >= H || gx >= W) continue;
    float v[kMaxSlots];
    v[0] = win[(y + RH) * t.wcols() + xx + RW];
    for (int k = 0; k < n_plans; ++k) v[1 + k] = blur[k * TH * TW + i];
    for (int j = 0; j < n_ops; ++j) {
      const int* o = op_i + 5 * j;
      const float plane_v = o[4] >= 0 ? aux[o[4] * plane + (size_t)gy * W + gx] : 0.f;
      const float r =
            apply_op<kChannelOps>(o[0], c, v[o[1]], v[o[2]], op_f + kOpFloats * j, plane_v, gy,
                                  gx, H, W);
      v[o[3]] = store_round(r, store);
    }
    out[c * plane + (size_t)gy * W + gx] = from_f32<T>(v[out_slot]);
  }
}

template <typename T, bool kChannelOps>
static int launch(const void* x, void* out, const float* aux, int C, int H, int W,
                  const float* taps, const int* meta, int n_plans, int n_taps, int RH, int RW,
                  int TH, int TW, const int* op_i, const float* op_f, int n_ops, int out_slot,
                  int store, float time, int smem, cudaStream_t stream) {
  auto kernel = graph_strip_kernel<T, kChannelOps>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), aux,
                                           C, H, W, taps, meta, n_plans, n_taps, RH, RW, TH, TW,
                                           op_i, op_f, n_ops, out_slot, store, time);
  return (int)cudaGetLastError();
}

}  // namespace rf

// bf16 selects bf16 storage for input and output (else f32); channel_ops
// says whether the op list holds channel ops.  Slots 0..n_plans are the
// input and the conv results; the caller keeps every slot index below
// rf::kMaxSlots.
extern "C" int rf_graph_strip(int bf16, int channel_ops, const void* x, void* out,
                              const float* aux, int C, int H, int W, const float* taps,
                              const int* meta, int n_plans, int n_taps, int RH, int RW, int TH,
                              int TW, const int* op_i, const float* op_f, int n_ops, int out_slot,
                              int store, float time, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto launcher) {
    return launcher(x, out, aux, C, H, W, taps, meta, n_plans, n_taps, RH, RW, TH, TW, op_i, op_f,
                    n_ops, out_slot, store, time, smem, s);
  };
  if (bf16)
    return channel_ops ? go(rf::launch<__nv_bfloat16, true>) : go(rf::launch<__nv_bfloat16, false>);
  return channel_ops ? go(rf::launch<float, true>) : go(rf::launch<float, false>);
}

extern "C" int rf_max_slots() { return rf::kMaxSlots; }
