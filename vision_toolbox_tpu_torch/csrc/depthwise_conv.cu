// Depthwise k×k convolution, forward (K9): y = x ⊛ w, stride 1, SAME, NHWC
// x (B, H, W, C) in f32 or bf16, weights (k, k, C) in the compute type, y in
// x's type. Replaces vision_toolbox_tpu/ops/depthwise_conv.py `_dw_fwd`
// (`_fwd_kernel`); the design, the rounding points and what bounds it are in
// depthwise_conv.cuh.
#include "depthwise_conv.cuh"

using namespace vtt;

extern "C" int vtt_dw_fwd(const void* x, const void* w, void* y, int x_bf16, int w_bf16, int B,
                          int H, int W, int C, int k, void* stream) {
  if (!dw::shape_ok(B, H, W, C, k)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dw::launch_conv_typed(x, w, y, x_bf16, w_bf16, B, H, W, C, k, 0,
                                                static_cast<cudaStream_t>(stream)));
}
