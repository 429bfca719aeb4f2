// Fused transformer self-attention half-block, forward:
//   out = x + dp·γ_ls·(MHA(LN(x))·Woᵀ + bo),
// q/k/v projected from the LayerNorm output, unbiased softmax attention per
// image and head.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/block_attention.py
// `_run_attn` (`_fwd_kernel`), reached through `fused_attention_block`:
// inference (save=False) when the caller passes null save pointers, and the
// backward-save variant (save=True), which also writes xhat (bf16), rstd
// (f32), the softmax probabilities p (B, H, T, Tp) bf16 (rows of Tp = T
// rounded up to 8 elements, the last Tp − T zero) and, with γ_ls, the
// pre-scale projection (bf16) for block_attention_bwd.cu; q/k/v/o, the
// other saves, go through device memory in both variants.
//
// The TPU design runs one grid program per image with Wq/k/v/o (4·D² bf16 =
// 4.7 MB at D=768) resident in VMEM and y/q/k/v/o never leaving the chip.
// On Hopper the weights do not fit a block's 227 KB of shared memory, so the
// half-block is four launches:
//   (i)   the LayerNorm row pass, once per row (gemm.cuh ln_rows_kernel):
//         y = bf16(LN(x)·γ + β) to a scratch the wrapper allocates (and,
//         saving, xhat and rstd);
//   (ii)  the q/k/v projections of y: one launch of the GEMM template
//         (gemm.cuh: wgmma tiles, TMA loads), the three products' column
//         tiles side by side; q/k/v (bf16) go to device memory;
//   (iii) the attention core (block_attention.cuh: mma.sync register tiles,
//         p and o out with 16-byte stores): per (image, head) all T keys,
//         logits and softmax in f32, p rounded to bf16 (saved, save
//         variant), o = p·v rounded to bf16 to device memory. Attention
//         never crosses images;
//   (iv)  o·Woᵀ + bo with the dp·γ_ls scale and the residual add in the
//         epilogue (the GEMM template again).
// What bounds it: the projections are compute-bound; the attention core at
// vit_b_16 b128 moves q, k, v in and o and the saved p (B·H·T² bf16, 119 MB)
// out: 274 MB, 0.082 ms at 3.35 TB/s, against 15.3 GFLOP of products
// (0.015 ms), so its bytes bound it (block_attention.cuh says how it keeps
// the scores in registers). y/q/k/v/o (5·B·T·D bf16, 12 MB at batch 8)
// make a round trip through device memory that the TPU kernel kept on chip.
#include "block_attention.cuh"
#include "gemm.cuh"

using namespace vtt;

namespace {

constexpr int MAX_SEQ = 512;

// The core on the current stream: heads ≤ 64 or ≤ 128 wide, p written
// (B, H, T, Tp) where `p` is not null.
template <int HD>
cudaError_t launch_core(const void* q, const void* k, const void* v, void* o, void* p, int B,
                        int T, int D, int H, float scale, cudaStream_t st) {
  constexpr int KG = vtt_k4::Groups<HD>::KG;
  const vtt_k4::Geometry geo = vtt_k4::rows_geometry(T, KG);
  const bool save = p != nullptr;
  const vtt_k4::RowsSmem L(geo, D / H, KG, true, save);
  auto* kernel = save ? vtt_k4::attn_kernel<true, HD> : vtt_k4::attn_kernel<false, HD>;
  const long long blocks = static_cast<long long>(B) * H * geo.row_blocks;
  if (vtt_k4::core_smem_bytes(T, D / H) > vtt_k4::kMaxSmem || blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), geo.rows * geo.splits * 32, L.total, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<bf16*>(p), T, D, H, D / H, scale, geo);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_block_attention_fwd(
    const void* x, void* out, void* q, void* k, void* v, void* o, int x_bf16,
    const void* ln_scale, int ln_scale_bf16, const void* ln_bias, int ln_bias_bf16,
    const void* wq, const void* bq, int bq_bf16,
    const void* wk, const void* bk, int bk_bf16,
    const void* wv, const void* bv, int bv_bf16,
    const void* wo, const void* bo, int bo_bf16,
    const void* ls, int ls_bf16, const float* dp,
    void* xhat, float* rstd, void* p, void* proj_out, void* y,
    int B, int T, int D, int H, float scale, float eps, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int hd = D / H;
  const int M = B * T;
  if (hd % 16 != 0 || hd > 128 || T > MAX_SEQ || !gemm_shape_ok(M, D, D) || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16({x, out, q, k, v, o, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, ls, dp,
                  xhat, rstd, p, proj_out, y})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool save = xhat != nullptr;  // the caller passes all of xhat, rstd, p or none
  const Vec lns = vec(ln_scale, ln_scale_bf16), lnb = vec(ln_bias, ln_bias_bf16);
  cudaError_t err = x_bf16 ? launch_ln_rows<bf16>(x, lns, lnb, eps, y, xhat, rstd, M, D, save, st)
                           : launch_ln_rows<float>(x, lns, lnb, eps, y, xhat, rstd, M, D, save, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs qkv{};
  qkv.a = y;
  qkv.M = M;
  qkv.N = D;
  qkv.K = D;
  qkv.w[0] = static_cast<const bf16*>(wq);
  qkv.w[1] = static_cast<const bf16*>(wk);
  qkv.w[2] = static_cast<const bf16*>(wv);
  qkv.bias[0] = vec(bq, bq_bf16);
  qkv.bias[1] = vec(bk, bk_bf16);
  qkv.bias[2] = vec(bv, bv_bf16);
  qkv.out[0] = q;
  qkv.out[1] = k;
  qkv.out[2] = v;

  GemmArgs proj{};
  proj.a = o;
  proj.M = M;
  proj.N = D;
  proj.K = D;
  proj.w[0] = static_cast<const bf16*>(wo);
  proj.bias[0] = vec(bo, bo_bf16);
  proj.out[0] = out;
  proj.res = x;
  proj.ls = vec(ls, ls_bf16);
  proj.dp = dp;
  proj.rows_per_image = T;
  proj.aux = proj_out;

  err = launch_gemm<EPI_BIAS, bf16>(qkv, 3, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hd <= 64 ? launch_core<64>(q, k, v, o, p, B, T, D, H, scale, st)
                 : launch_core<128>(q, k, v, o, p, B, T, D, H, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = x_bf16 ? launch_forward_gemm<EPI_RESIDUAL, bf16>(proj, 1, save, st)
               : launch_forward_gemm<EPI_RESIDUAL, float>(proj, 1, save, st);
  return static_cast<int>(err);
}
