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
// backward is five launches:
//   (i)   douts and the db2/dγ_ls partial rows, a row kernel (block_bwd.cuh);
//   (ii)  dg = douts·W2 with the gelu' epilogue reading the saved h: dh in
//         bf16 and db1's partial rows from the f32 values (GEMM template,
//         W2 read (K, N) as wgmma's MN-major B);
//   (iii) dy2 = dh·W1 in f32 (GEMM template, W1 read (K, N));
//   (iv)  the LayerNorm backward over whole rows and the dγ_ln/dβ_ln
//         partial rows (block_bwd.cuh), shared with the attention backward;
//   (v)   the five column sums from their partial rows, in a fixed order.
// The partial rows live in one f32 scratch the wrapper allocates
// (vtt_block_mlp_bwd_partial_floats); no atomics, so a second backward is bit-equal.
// What bounds it: at vit_b_16 batch 128 the two products are 238 GFLOP
// against ≈ 0.4 GB of operands, compute-bound (≈ 0.24 ms at the bf16 peak);
// douts and dy2 (M·D bf16 and f32) make a device-memory round trip the TPU
// kernel kept on chip, and (i)/(iv) are bound by bytes.
#include "block_bwd.cuh"

using namespace vtt;

namespace {

// Floats of the partial-row scratch: db2 and dγ_ls (a row per DOUTS_ROWS
// rows), db1 (a row per 128-row GEMM tile), dγ_ln and dβ_ln (a row per
// LN_ROWS rows); ops/block_mlp.py `_bwd_partial_floats` mirrors it.
long long partial_floats(int M, int D, int Dh) {
  const long long pd = (M + DOUTS_ROWS - 1) / DOUTS_ROWS, pg = (M + BM - 1) / BM,
                  pl = (M + LN_ROWS - 1) / LN_ROWS;
  return 2 * pd * D + pg * Dh + 2 * pl * D;
}

template <typename TX>
cudaError_t mlp_bwd(const void* dout, const void* xhat, const float* rstd, const void* h,
                    const void* mlpout, const void* w1, const void* w2, Vec lns, Vec ls,
                    const float* dp, void* dx, void* dh, void* douts, float* dy2, float* db1,
                    float* db2, float* dlns, float* dlnb, float* dls, float* part, int has_res,
                    int M, int T, int D, int Dh, cudaStream_t st) {
  const int pd = (M + DOUTS_ROWS - 1) / DOUTS_ROWS, pg = (M + BM - 1) / BM,
            pl = (M + LN_ROWS - 1) / LN_ROWS;
  float* db2_part = part;
  float* dls_part = db2_part + static_cast<size_t>(pd) * D;
  float* db1_part = dls_part + static_cast<size_t>(pd) * D;
  float* dlns_part = db1_part + static_cast<size_t>(pg) * Dh;
  float* dlnb_part = dlns_part + static_cast<size_t>(pl) * D;
  cudaError_t err = launch_douts<TX>(dout, dp, ls, mlpout, douts, db2_part, dls_part, M, D, T, st);
  if (err != cudaSuccess) return err;

  GemmArgs dg{};  // dh = bf16(douts·W2 ⊙ gelu'(h)), db1's partial rows
  dg.a = douts;
  dg.M = M;
  dg.N = Dh;
  dg.K = D;
  dg.w[0] = static_cast<const bf16*>(w2);  // (D, Dh) = (K, N)
  dg.out[0] = dh;
  dg.aux_in = static_cast<const bf16*>(h);
  dg.colsum_part = db1_part;
  err = launch_gemm<EPI_GELU_GRAD, bf16, B_KN>(dg, 1, st);
  if (err != cudaSuccess) return err;

  GemmArgs dy{};  // dy2 = dh·W1 (f32)
  dy.a = dh;
  dy.M = M;
  dy.N = D;
  dy.K = Dh;
  dy.w[0] = static_cast<const bf16*>(w1);  // (Dh, D) = (K, N)
  dy.out[0] = dy2;
  err = launch_gemm<EPI_F32, bf16, B_KN>(dy, 1, st);
  if (err != cudaSuccess) return err;

  err = launch_ln_bwd<TX>(dy2, xhat, rstd, lns, has_res ? nullptr : dout, dx, dlns_part,
                          dlnb_part, M, D, st);
  if (err != cudaSuccess) return err;
  const ColSum sums[] = {{db2_part, db2, pd, D}, {dls_part, mlpout ? dls : nullptr, pd, D},
                         {db1_part, db1, pg, Dh}, {dlns_part, dlns, pl, D},
                         {dlnb_part, dlnb, pl, D}};
  return launch_colsums(sums, 5, st);
}

}  // namespace

extern "C" long long vtt_block_mlp_bwd_partial_floats(int M, int D, int Dh) {
  return partial_floats(M, D, Dh);
}

extern "C" int vtt_block_mlp_bwd(
    const void* dout, int x_bf16, const void* xhat, const float* rstd, const void* h,
    const void* mlpout, const void* w1, const void* w2,
    const void* ln_scale, int ln_scale_bf16, const void* ls, int ls_bf16, const float* dp,
    void* dx, void* dh, void* douts, float* dy2, float* db1, float* db2, float* dlns,
    float* dlnb, float* dls, float* partials, long long partial_count, int has_res, int M, int T,
    int D, int Dh, void* stream) {
  if (!gemm_shape_ok(M, Dh, D) || !gemm_shape_ok(M, D, Dh) || T <= 0 ||
      (M + DOUTS_ROWS - 1) / DOUTS_ROWS > 65535 || partial_count < partial_floats(M, D, Dh) ||
      !row_kernels_take(D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16({dout, xhat, rstd, h, mlpout, w1, w2, ln_scale, ls, dp, dx, dh, douts, dy2,
                  partials})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Vec lns = vec(ln_scale, ln_scale_bf16), lsv = vec(ls, ls_bf16);
  const cudaError_t err =
      x_bf16 ? mlp_bwd<bf16>(dout, xhat, rstd, h, mlpout, w1, w2, lns, lsv, dp, dx, dh, douts,
                             dy2, db1, db2, dlns, dlnb, dls, partials, has_res, M, T, D, Dh, st)
             : mlp_bwd<float>(dout, xhat, rstd, h, mlpout, w1, w2, lns, lsv, dp, dx, dh, douts,
                              dy2, db1, db2, dlns, dlnb, dls, partials, has_res, M, T, D, Dh, st);
  return static_cast<int>(err);
}
