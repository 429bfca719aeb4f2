// Fused transformer MLP half-block, backward: from the forward's saves
// (xhat, rstd, h, mlpout with γ_ls) and the output cotangent dout,
//   douts = bf16(dout·dp·γ_ls),        db2 = Σ dout·dp·γ_ls,  dγ_ls = Σ dout·dp·mlpout,
//   dh    = bf16(douts·W2 ⊙ gelu'(h)), db1 = Σ douts·W2 ⊙ gelu'(h)   (f32 sums),
//   dy2   = dh·W1 (f32),
//   dx    = LN_bwd(dy2) (+ dout unless the residual is separate), dγ_ln, dβ_ln.
// The weight gradients dW1 = dhᵀ·y2 and dW2 = doutsᵀ·g stay plain products
// in the caller, as the JAX package leaves them to XLA.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/block_mlp.py
// `_fused_mlp_bwd` (`_bwd_kernel`).
//
// The TPU kernel keeps W1ᵀ and W2 resident in VMEM, carries dy2 and the
// column sums along its sequential grid, and never writes douts or dy2. On
// Hopper the weights stream in tiles and blocks run in no order, so the
// backward is four launches:
//   (i)   douts and the db2/dγ_ls column sums, a row kernel (block_bwd.cuh);
//   (ii)  dg = douts·W2 with the gelu' epilogue reading the saved h: dh in
//         bf16 and db1 from the f32 values (GEMM template, W2 read (K, N));
//   (iii) dy2 = dh·W1 in f32 (GEMM template, W1 read (K, N));
//   (iv)  the LayerNorm backward over whole rows (block_bwd.cuh), shared
//         with the attention backward.
// Column sums are per-block partials added with atomics (their f32 order
// varies from run to run).
// What bounds it: at vit_b_16 batch 128 the two products are 238 GFLOP
// against ≈ 0.4 GB of operands, compute-bound (≈ 0.24 ms at the bf16 peak);
// douts and dy2 (M·D bf16 and f32) make a device-memory round trip the TPU
// kernel kept on chip, and (i)/(iv) are bound by bytes.
#include "block_bwd.cuh"

using namespace vtt;

namespace {

template <typename TX>
cudaError_t mlp_bwd(const void* dout, const void* xhat, const float* rstd, const void* h,
                    const void* mlpout, const void* w1, const void* w2, Vec lns, Vec ls,
                    const float* dp, void* dx, void* dh, void* douts, float* dy2, float* db1,
                    float* db2, float* dlns, float* dlnb, float* dls, int has_res, int M, int T,
                    int D, int Dh, cudaStream_t st) {
  cudaError_t err = launch_douts<TX>(dout, dp, ls, mlpout, douts, db2, dls, M, D, T, st);
  if (err != cudaSuccess) return err;

  GemmArgs dg{};  // dh = bf16(douts·W2 ⊙ gelu'(h)), db1
  dg.a = douts;
  dg.M = M;
  dg.N = Dh;
  dg.K = D;
  dg.w[0] = static_cast<const bf16*>(w2);  // (D, Dh) = (K, N)
  dg.out[0] = dh;
  dg.aux_in = static_cast<const bf16*>(h);
  dg.colsum = db1;
  err = launch_gemm<A_BF16, EPI_GELU_GRAD, bf16, B_KN>(dg, 1, st);
  if (err != cudaSuccess) return err;

  GemmArgs dy{};  // dy2 = dh·W1 (f32)
  dy.a = dh;
  dy.M = M;
  dy.N = D;
  dy.K = Dh;
  dy.w[0] = static_cast<const bf16*>(w1);  // (Dh, D) = (K, N)
  dy.out[0] = dy2;
  err = launch_gemm<A_BF16, EPI_F32, bf16, B_KN>(dy, 1, st);
  if (err != cudaSuccess) return err;

  return launch_ln_bwd<TX>(dy2, xhat, rstd, lns, has_res ? nullptr : dout, dx, dlns, dlnb, M, D,
                           st);
}

}  // namespace

extern "C" int vtt_block_mlp_bwd(
    const void* dout, int x_bf16, const void* xhat, const float* rstd, const void* h,
    const void* mlpout, const void* w1, const void* w2,
    const void* ln_scale, int ln_scale_bf16, const void* ls, int ls_bf16, const float* dp,
    void* dx, void* dh, void* douts, float* dy2, float* db1, float* db2, float* dlns,
    float* dlnb, float* dls, int has_res, int M, int T, int D, int Dh, void* stream) {
  if (!gemm_shape_ok(M, Dh, D) || !gemm_shape_ok(M, D, Dh) || T <= 0 ||
      (M + DOUTS_ROWS - 1) / DOUTS_ROWS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Vec lns = vec(ln_scale, ln_scale_bf16), lsv = vec(ls, ls_bf16);
  const cudaError_t err =
      x_bf16 ? mlp_bwd<bf16>(dout, xhat, rstd, h, mlpout, w1, w2, lns, lsv, dp, dx, dh, douts,
                             dy2, db1, db2, dlns, dlnb, dls, has_res, M, T, D, Dh, st)
             : mlp_bwd<float>(dout, xhat, rstd, h, mlpout, w1, w2, lns, lsv, dp, dx, dh, douts,
                              dy2, db1, db2, dlns, dlnb, dls, has_res, M, T, D, Dh, st);
  return static_cast<int>(err);
}
