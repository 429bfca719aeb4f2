// Fused transformer self-attention half-block, forward:
//   out = x + dp·γ_ls·(MHA(LN(x))·Woᵀ + bo),
// q/k/v projected from the LayerNorm output, unbiased softmax attention per
// image and head.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/block_attention.py
// `_run_attn` (`_fwd_kernel`), reached through `fused_attention_block`:
// inference (save=False) when the caller passes null save pointers, and the
// backward-save variant (save=True), which also writes xhat (bf16), rstd
// (f32), the softmax probabilities p (B, H, T, T) bf16 and, with γ_ls, the
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
//   (iii) attention, this file: one block per (query tile of 32 rows, head,
//         image); all S keys of the image sit in shared memory, logits and
//         softmax in f32, p rounded to bf16, o = p·v rounded to bf16 and
//         written to device memory (wmma tiles; the first design's, not yet
//         moved to the register tiles). Attention never crosses images;
//   (iv)  o·Woᵀ + bo with the dp·γ_ls scale and the residual add in the
//         epilogue (the GEMM template again).
// What bounds it: the projections are compute-bound; the attention step at
// T=197, head_dim 64 is small (≈ 2·2·T²·D flop per image) and bound by its
// shared-memory traffic and the serial softmax. y/q/k/v/o (5·B·T·D bf16,
// 12 MB at batch 8) make a round trip through device memory that the TPU
// kernel kept on chip.
#include <math.h>
#include <mma.h>

#include "gemm.cuh"

using namespace vtt;

namespace {

constexpr int BQ = 32;            // query rows per block
constexpr int ATTN_THREADS = 128;  // four warps

__host__ __device__ inline int padded_keys(int t) { return (t + 15) / 16 * 16; }
__host__ __device__ inline int logit_pitch(int sp, int hd) { return (sp > hd ? sp : hd) + 4; }

// Shared memory of one attention block; ops/block_attention.py
// `_attn_smem_bytes` mirrors this formula for the dispatch gate.
size_t attn_smem_bytes(int t, int hd) {
  const int sp = padded_keys(t);
  return static_cast<size_t>(sp) * (hd + 8) * 2       // K, then V
         + static_cast<size_t>(BQ) * (hd + 8) * 2      // Q tile
         + static_cast<size_t>(BQ) * logit_pitch(sp, hd) * 4  // f32 logits, then o
         + static_cast<size_t>(BQ) * (sp + 8) * 2;     // bf16 probabilities
}

constexpr size_t kMaxSmem = 227 * 1024;

// SAVE also writes the probabilities p (B, H, T, T) for the backward.
template <bool SAVE>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            bf16* __restrict__ o, bf16* __restrict__ p_out, int T, int D, int hd, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded_keys(T), lw = logit_pitch(sp, hd);
  const int ldh = hd + 8, ldp = sp + 8;
  bf16* kv = reinterpret_cast<bf16*>(smem);
  bf16* qs = kv + sp * ldh;
  float* ls = reinterpret_cast<float*>(qs + BQ * ldh);
  bf16* ps = reinterpret_cast<bf16*>(ls + BQ * lw);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t base = static_cast<size_t>(b) * T * D + static_cast<size_t>(h) * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_head_rows<ATTN_THREADS>(q + base, q0, BQ, T, D, hd, qs, ldh);
  load_head_rows<ATTN_THREADS>(k + base, 0, sp, T, D, hd, kv, ldh);
  __syncthreads();

  // logits = q·kᵀ (f32), tiles of 16×16 spread over the warps
  const int row_tiles = BQ / 16;
  for (int t = warp; t < row_tiles * (sp / 16); t += ATTN_THREADS / 32) {
    const int i = t % row_tiles, j = t / row_tiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < hd; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, qs + i * 16 * ldh + kk, ldh);
      wmma::load_matrix_sync(fb, kv + j * 16 * ldh + kk, ldh);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(ls + i * 16 * lw + j * 16, acc, lw, wmma::mem_row_major);
  }
  __syncthreads();

  load_head_rows<ATTN_THREADS>(v + base, 0, sp, T, D, hd, kv, ldh);  // V replaces K

  // softmax over the T valid keys, one warp per query row; p rounded to bf16
  // (and saved, (B, H, T, T), in the backward-save variant)
  for (int r = warp; r < BQ; r += ATTN_THREADS / 32) {
    float* row = ls + r * lw;
    float mx = -INFINITY;
    for (int c = lane; c < T; c += 32) mx = fmaxf(mx, __fmul_rn(row[c], scale));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int c = lane; c < T; c += 32) {
      const float e = expf(__fsub_rn(__fmul_rn(row[c], scale), mx));
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    bf16* prow = ps + r * ldp;
    for (int c = lane; c < sp; c += 32) prow[c] = __float2bfloat16(c < T ? row[c] / sum : 0.0f);
    if constexpr (SAVE) {
      if (q0 + r < T) {
        bf16* psave = p_out + ((static_cast<size_t>(b) * gridDim.y + h) * T + q0 + r) * T;
        for (int c = lane; c < T; c += 32) psave[c] = prow[c];
      }
    }
  }
  __syncthreads();

  // o = p·v (f32 accumulation), staged in the logits buffer
  for (int t = warp; t < row_tiles * (hd / 16); t += ATTN_THREADS / 32) {
    const int i = t % row_tiles, j = t / row_tiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < sp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, ps + i * 16 * ldp + kk, ldp);
      wmma::load_matrix_sync(fb, kv + kk * ldh + j * 16, ldh);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(ls + i * 16 * lw + j * 16, acc, lw, wmma::mem_row_major);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * hd; i += ATTN_THREADS) {
    const int r = i / hd, c = i % hd;
    if (q0 + r < T) o[base + static_cast<size_t>(q0 + r) * D + c] = __float2bfloat16(ls[r * lw + c]);
  }
}

}  // namespace

extern "C" long long vtt_attn_smem_bytes(int t, int hd) {
  return static_cast<long long>(attn_smem_bytes(t, hd));
}

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
  const size_t smem = attn_smem_bytes(T, hd);
  if (hd % 16 != 0 || hd > 128 || smem > kMaxSmem || !gemm_shape_ok(M, D, D) || B > 65535) {
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
  auto* kernel = save ? attn_kernel<true> : attn_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  kernel<<<grid, ATTN_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<bf16*>(p), T, D, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = x_bf16 ? launch_forward_gemm<EPI_RESIDUAL, bf16>(proj, 1, save, st)
               : launch_forward_gemm<EPI_RESIDUAL, float>(proj, 1, save, st);
  return static_cast<int>(err);
}
