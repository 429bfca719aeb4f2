// Fused transformer self-attention half-block, backward: from the forward's
// saves (xhat, rstd, q, k, v, the softmax probabilities p (B, H, T, Tp), proj
// with γ_ls) and the output cotangent dout,
//   douts = bf16(dout·dp·γ_ls),  dbo = Σ dout·dp·γ_ls,  dγ_ls = Σ dout·dp·proj,
//   do    = bf16(douts·Wo),
//   per image and head, from the saved p with no softmax recompute:
//     dv = pᵀ·do,  dp = do·vᵀ,  ds = bf16(p ⊙ (dp − rowsum(dp ⊙ p))),
//     dq = ds·k·scale,  dk = dsᵀ·bf16(q·scale),   dbq/dbk/dbv = f32 sums,
//   dy    = dq·Wq + dk·Wk + dv·Wv (f32; one product over the 3·D depth),
//   dx    = dout + LN_bwd(dy), dγ_ln, dβ_ln.
// The weight gradients dWq/k/v = d{q,k,v}ᵀ·y and dWo = doutsᵀ·o stay plain
// products in the caller, as the JAX package leaves them to XLA.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/block_attention.py
// `_fused_attn_bwd` (`_bwd_kernel`).
//
// The TPU kernel runs one grid program per image with all four weights
// resident in VMEM and the whole (T, T) probabilities of every head on chip.
// On Hopper that does not fit a block, so the attention part is
// FlashAttention-2's split into a rows pass and a keys pass, on the register
// tiles of block_attention.cuh (mma.sync, every operand one bf16 plane):
//   (a) rows (attn_bwd_rows_kernel): per 16 query rows, dp = do·vᵀ in
//       registers, δ = rowsum(dp ⊙ p) over the whole row (the row's key
//       runs traded between warps), ds = bf16(p ⊙ (dp − δ)) written once to
//       a (B, H, T, Tp) scratch for (b), dq = ds·k·scale;
//   (b) keys (attn_bwd_keys_kernel): per 16 key rows, tiles of p, ds, do
//       and bf16(q·scale) streamed through a cp.async ring, dv = pᵀ·do and
//       dk = dsᵀ·bf16(q·scale) accumulated in registers.
// Around them: a row kernel for douts (block_bwd.cuh), the
// GEMM template (gemm.cuh: wgmma tiles, TMA loads) for do = douts·Wo and
// dy = [dq|dk|dv]·[Wq;Wk;Wv] (weights read (K, N) as wgmma's MN-major B),
// the LayerNorm row backward shared with the MLP backward, and the seven
// column sums from their partial rows in a fixed order: seven launches. The
// partial rows live in one f32 scratch the wrapper allocates
// (vtt_block_attention_bwd_partial_floats); no atomics, so a second backward is bit-equal.
// What bounds it: at vit_b_16 batch 128 the products are ≈ 149 GFLOP and
// the operands ≈ 0.47 GB (p alone is 119 MB), close to balanced on an H100
// (≈ 0.15 ms at the bf16 peak); ds, douts, do and dy make device-memory round
// trips the TPU kernel kept on chip. The attention part alone reads do, q,
// k, v and p and writes dq, dk and dv: 390 MB, 0.117 ms at 3.35 TB/s (the ds
// round trip adds 238 MB), against 30.5 GFLOP.
#include "block_attention.cuh"
#include "block_bwd.cuh"

using namespace vtt;

namespace {

constexpr int MAX_SEQ = 512;
constexpr int PARTIAL_ROWS = 16;  // dbq/dbk/dbv: a partial row per image and 16-row tile

// (a) then (b) on the current stream, heads ≤ 64 or ≤ 128 wide.
template <int HD>
cudaError_t launch_core(const void* dO, const void* q, const void* k, const void* v,
                        const void* p, void* ds, void* dqkv, float* part, int B, int T, int D,
                        int H, float scale, cudaStream_t st) {
  constexpr int KG = vtt_k4::Groups<HD>::KG;
  const int hd = D / H;
  const vtt_k4::Geometry geo = vtt_k4::rows_geometry(T, KG);
  const vtt_k4::RowsSmem rows(geo, hd, KG, false, false);
  const long long row_blocks = static_cast<long long>(B) * H * geo.row_blocks;
  const vtt_k4::KeyGeometry kgeo = vtt_k4::key_geometry(T);
  const int key_blocks = kgeo.blocks, key_warps = kgeo.warps;
  const vtt_k4::KeysSmem keys(key_warps, hd);
  const long long key_grid = static_cast<long long>(B) * H * key_blocks;
  if (vtt_k4::core_smem_bytes(T, hd) > vtt_k4::kMaxSmem || row_blocks > 0x7fffffffLL ||
      key_grid > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  auto* rows_kernel = vtt_k4::attn_bwd_rows_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(rows.total));
  if (err != cudaSuccess) return err;
  rows_kernel<<<static_cast<unsigned>(row_blocks), geo.rows * geo.splits * 32, rows.total, st>>>(
      static_cast<const bf16*>(dO), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(p), static_cast<bf16*>(ds), static_cast<bf16*>(dqkv), part, T, D,
      H, hd, scale, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* keys_kernel = vtt_k4::attn_bwd_keys_kernel<HD>;
  err = cudaFuncSetAttribute(keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(keys.total));
  if (err != cudaSuccess) return err;
  keys_kernel<<<static_cast<unsigned>(key_grid), key_warps * 32, keys.total, st>>>(
      static_cast<const bf16*>(dO), static_cast<const bf16*>(q), static_cast<const bf16*>(p),
      static_cast<const bf16*>(ds), static_cast<bf16*>(dqkv), part, T, D, H, hd, scale,
      key_blocks);
  return cudaGetLastError();
}

// Floats of the partial-row scratch: dbo and dγ_ls (a row per DOUTS_ROWS
// rows), dbq/dbk/dbv (a row per image and PARTIAL_ROWS-row tile, 3·D wide),
// dγ_ln and dβ_ln (a row per LN_ROWS rows); ops/block_attention.py
// `_bwd_partial_floats` mirrors it.
long long partial_floats(int B, int T, int D) {
  const long long M = static_cast<long long>(B) * T, pd = (M + DOUTS_ROWS - 1) / DOUTS_ROWS,
                  pa = static_cast<long long>(B) * ((T + PARTIAL_ROWS - 1) / PARTIAL_ROWS),
                  pl = (M + LN_ROWS - 1) / LN_ROWS;
  return 2 * pd * D + pa * 3 * D + 2 * pl * D;
}

}  // namespace

extern "C" long long vtt_block_attention_bwd_partial_floats(int B, int T, int D) {
  return partial_floats(B, T, D);
}

extern "C" int vtt_block_attention_bwd(
    const void* dout, int x_bf16, const void* xhat, const float* rstd,
    const void* q, const void* k, const void* v, const void* p, const void* proj,
    const void* wo, const void* wqkv,
    const void* ln_scale, int ln_scale_bf16, const void* ls, int ls_bf16, const float* dp,
    void* dx, void* dqkv, void* douts, void* dO, void* ds, float* dy,
    float* dbqkv, float* dbo, float* dlns, float* dlnb, float* dls,
    float* partials, long long partial_count,
    int B, int T, int D, int H, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int hd = D / H, M = B * T;
  if (hd % 16 != 0 || hd > 128 || T > MAX_SEQ || !gemm_shape_ok(M, D, D) ||
      !gemm_shape_ok(M, D, 3 * D) || B > 65535 || (M + DOUTS_ROWS - 1) / DOUTS_ROWS > 65535 ||
      partial_count < partial_floats(B, T, D) || !row_kernels_take(D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16({dout, xhat, rstd, q, k, v, p, proj, wo, wqkv, ln_scale, ls, dp, dx, dqkv, douts,
                  dO, ds, dy, partials})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Vec lns = vec(ln_scale, ln_scale_bf16), lsv = vec(ls, ls_bf16);
  const int pd = (M + DOUTS_ROWS - 1) / DOUTS_ROWS,
            pa = B * ((T + PARTIAL_ROWS - 1) / PARTIAL_ROWS),
            pl = (M + LN_ROWS - 1) / LN_ROWS;
  float* dbo_part = partials;
  float* dls_part = dbo_part + static_cast<size_t>(pd) * D;
  float* dbqkv_part = dls_part + static_cast<size_t>(pd) * D;
  float* dlns_part = dbqkv_part + static_cast<size_t>(pa) * 3 * D;
  float* dlnb_part = dlns_part + static_cast<size_t>(pl) * D;

  cudaError_t err =
      x_bf16 ? launch_douts<bf16>(dout, dp, lsv, proj, douts, dbo_part, dls_part, M, D, T, st)
             : launch_douts<float>(dout, dp, lsv, proj, douts, dbo_part, dls_part, M, D, T, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs dg{};  // do = bf16(douts·Wo)
  dg.a = douts;
  dg.M = M;
  dg.N = D;
  dg.K = D;
  dg.w[0] = static_cast<const bf16*>(wo);  // (D_out, D_in) = (K, N)
  dg.out[0] = dO;
  err = launch_gemm<EPI_BIAS, bf16, B_KN>(dg, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = hd <= 64 ? launch_core<64>(dO, q, k, v, p, ds, dqkv, dbqkv_part, B, T, D, H, scale, st)
                 : launch_core<128>(dO, q, k, v, p, ds, dqkv, dbqkv_part, B, T, D, H, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs dyg{};  // dy = [dq|dk|dv]·[Wq;Wk;Wv] (f32)
  dyg.a = dqkv;
  dyg.M = M;
  dyg.N = D;
  dyg.K = 3 * D;
  dyg.w[0] = static_cast<const bf16*>(wqkv);  // (3·D_out, D_in) = (K, N)
  dyg.out[0] = dy;
  err = launch_gemm<EPI_F32, bf16, B_KN>(dyg, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = x_bf16 ? launch_ln_bwd<bf16>(dy, xhat, rstd, lns, dout, dx, dlns_part, dlnb_part, M, D, st)
               : launch_ln_bwd<float>(dy, xhat, rstd, lns, dout, dx, dlns_part, dlnb_part, M, D,
                                      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ColSum sums[] = {{dbo_part, dbo, pd, D}, {dls_part, proj ? dls : nullptr, pd, D},
                         {dbqkv_part, dbqkv, pa, 3 * D}, {dlns_part, dlns, pl, D},
                         {dlnb_part, dlnb, pl, D}};
  return static_cast<int>(launch_colsums(sums, 5, st));
}
