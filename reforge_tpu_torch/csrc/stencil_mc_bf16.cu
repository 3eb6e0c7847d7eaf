// stencil_apply_mc's bf16 run forms (stencil_mc.cuh), compiled beside the
// f32 forms of stencil_mc.cu.

#include "stencil_mc.cuh"

namespace rf {

int launch_mc_run_bf16(const void* x, void* out, int C_in, int CO, int H, int W, int RH, int RW,
                       int zero, int vec, int masked, const float* w, const int* mask,
                       int nonempty, int smem, cudaStream_t s) {
  return launch_mc_run<__nv_bfloat16>(x, out, C_in, CO, H, W, RH, RW, zero, vec, masked, w, mask,
                                      nonempty, smem, s);
}

}  // namespace rf
