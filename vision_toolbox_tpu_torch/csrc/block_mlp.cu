// Fused transformer MLP half-block, forward:
//   out = res + dp·γ_ls·(gelu_AS(LN(x)·W1ᵀ + b1)·W2ᵀ + b2),  res = residual or x.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/block_mlp.py `_run_mlp`
// (`_fwd_kernel`), reached through `fused_mlp_block`: inference (save=False)
// when the caller passes null save pointers, and the backward-save variant
// (save=True), which also writes xhat (bf16), rstd (f32), h (bf16) and, with
// γ_ls, the pre-scale projection mlpout (bf16) for block_mlp_bwd.cu; g, the
// other save, is the hidden activation both variants write anyway.
//
// The TPU design keeps W1ᵀ and W2 resident in VMEM for the whole grid and
// never writes the hidden activation. On Hopper the weights (2·D·Dh bf16 =
// 9.4 MB at D=768) cannot sit in one block's 227 KB of shared memory, so
// they are streamed in tiles and the half-block runs as two launches of the
// shared GEMM template (gemm.cuh):
//   (i)  per 64-row tile: LN statistics → y2 = bf16(LN(x)) staged in shared
//        memory → h = bf16(y2·W1ᵀ + b1) → g = bf16(gelu_AS(h)), written to
//        device memory;
//   (ii) g·W2ᵀ + b2 with the dp·γ_ls scale and the residual add in the
//        epilogue.
// What bounds it: at vit_b_16 shapes both products are compute-bound; the
// hidden activation g (B·T·Dh bf16, 9.7 MB at batch 8) makes one round trip
// through device memory that the TPU kernel kept on chip. Keeping g on chip
// (a persistent block that walks the hidden dimension, as the TPU grid did)
// is the first target for later work.
#include "gemm.cuh"

using namespace vtt;

extern "C" const char* vtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int vtt_block_mlp_fwd(
    const void* x, const void* res, void* out, void* g, int x_bf16,
    const void* ln_scale, int ln_scale_bf16, const void* ln_bias, int ln_bias_bf16,
    const void* w1, const void* b1, int b1_bf16,
    const void* w2, const void* b2, int b2_bf16,
    const void* ls, int ls_bf16, const float* dp,
    void* xhat, float* rstd, void* h, void* mlpout,
    int M, int T, int D, int Dh, float eps, void* stream) {
  if (!gemm_shape_ok(M, Dh, D) || !gemm_shape_ok(M, D, Dh) || T <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  GemmArgs up{};
  up.a = x;
  up.M = M;
  up.N = Dh;
  up.K = D;
  up.w[0] = static_cast<const bf16*>(w1);
  up.bias[0] = vec(b1, b1_bf16);
  up.out[0] = g;
  up.ln_scale = vec(ln_scale, ln_scale_bf16);
  up.ln_bias = vec(ln_bias, ln_bias_bf16);
  up.eps = eps;
  up.aux = h;
  up.xhat = static_cast<bf16*>(xhat);
  up.rstd = rstd;

  GemmArgs down{};
  down.a = g;
  down.M = M;
  down.N = D;
  down.K = Dh;
  down.w[0] = static_cast<const bf16*>(w2);
  down.bias[0] = vec(b2, b2_bf16);
  down.out[0] = out;
  down.res = res;
  down.ls = vec(ls, ls_bf16);
  down.dp = dp;
  down.rows_per_image = T;
  down.aux = mlpout;

  const bool save = xhat != nullptr;  // the caller passes all of xhat, rstd, h or none
  cudaError_t err =
      x_bf16 ? launch_forward_gemm<A_LAYERNORM, EPI_BIAS_GELU, bf16>(up, 1, save, st)
             : launch_forward_gemm<A_LAYERNORM, EPI_BIAS_GELU, float>(up, 1, save, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = x_bf16 ? launch_forward_gemm<A_BF16, EPI_RESIDUAL, bf16>(down, 1, save, st)
               : launch_forward_gemm<A_BF16, EPI_RESIDUAL, float>(down, 1, save, st);
  return static_cast<int>(err);
}
