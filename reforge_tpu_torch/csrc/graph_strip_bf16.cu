// graph_strip's bf16 forms (graph_strip.cuh), compiled beside the f32
// forms of graph_strip.cu.

#include "graph_strip.cuh"

namespace rf {

int launch_strip_bf16(int channel_ops, int n_plans, const void* x, void* out, const float* aux,
                      int C, int H, int W, const float* taps, const int* meta, int n_taps, int RH,
                      int RW, int TH, int TW, int align, int out_slot, int store, float time,
                      int row0, int Hg, int smem, cudaStream_t s, const StripOps& ops) {
  return launch_strip<__nv_bfloat16>(channel_ops, n_plans, x, out, aux, C, H, W, taps, meta,
                                     n_taps, RH, RW, TH, TW, align, out_slot, store, time, row0,
                                     Hg, smem, s, ops);
}

}  // namespace rf
