// graph_strip's f32 forms and its entry point (graph_strip.cuh).

#include "graph_strip.cuh"

namespace rf {

int launch_strip_f32(int channel_ops, int n_plans, const void* x, void* out, const float* aux,
                     int C, int H, int W, const float* taps, const int* meta, int n_taps, int RH,
                     int RW, int TH, int TW, int align, int out_slot, int store, float time,
                     int row0, int Hg, int smem, cudaStream_t s, const StripOps& ops) {
  return launch_strip<float>(channel_ops, n_plans, x, out, aux, C, H, W, taps, meta, n_taps, RH,
                             RW, TH, TW, align, out_slot, store, time, row0, Hg, smem, s, ops);
}

}  // namespace rf

// bf16 selects bf16 storage for input and output (else f32); channel_ops
// says whether the op list holds channel ops.  op_i (5 ints an op: code,
// in0, in1, out, plane) and op_f (rf::kOpFloats floats an op) are host
// arrays.  Slots 0..n_plans are the input and the conv results; the
// caller keeps every slot index below rf::kMaxSlots, n_plans in
// 1..rf::kMaxPlans and n_ops up to rf::kMaxOps.  align and smem are
// cuda_ops.conv_layout's for the tile.  x is a slab of H rows of an image
// of Hg rows whose first row is image row row0 (0 and H for a whole frame):
// the epilogue's coordinates are image rows, its clamped reads the slab's.
extern "C" int rf_graph_strip(int bf16, int channel_ops, const void* x, void* out,
                              const float* aux, int C, int H, int W, const float* taps,
                              const int* meta, int n_plans, int n_taps, int RH, int RW, int TH,
                              int TW, int align, const int* op_i, const float* op_f, int n_ops,
                              int out_slot, int store, float time, int row0, int Hg, int smem,
                              void* stream) {
  if (out_slot < 0 || out_slot >= rf::kMaxSlots || n_ops < 0 || n_ops > rf::kMaxOps ||
      n_plans < 1 || n_plans > rf::kMaxPlans || TH % rf::kConvRun != 0 ||
      rf::kThreads % TH != 0 || TW % rf::kConvRun != 0 ||
      TH * TW > rf::kMaxRuns * rf::kThreads * rf::kConvRun ||
      (align != rf::kAlign && align != 1))
    return (int)cudaErrorInvalidValue;
  rf::StripOps ops{};
  ops.n = n_ops;
  for (int j = 0; j < n_ops; ++j) {
    const int* v = op_i + 5 * j;
    ops.op[j] = rf::StripOp{v[0], v[1], v[2], v[3], v[4], {}};
    for (int k = 0; k < rf::kOpFloats; ++k) ops.op[j].p[k] = op_f[rf::kOpFloats * j + k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto launcher) {
    return launcher(channel_ops, n_plans, x, out, aux, C, H, W, taps, meta, n_taps, RH, RW, TH,
                    TW, align, out_slot, store, time, row0, Hg, smem, s, ops);
  };
  return bf16 ? go(rf::launch_strip_bf16) : go(rf::launch_strip_f32);
}

// 0: value slots, 1: conv plans, 2: ops (cuda_ops.MAX_SLOTS, MAX_PLANS,
// MAX_OPS).
extern "C" int rf_strip_limits(int which) {
  return which == 0 ? rf::kMaxSlots : which == 1 ? rf::kMaxPlans : rf::kMaxOps;
}
