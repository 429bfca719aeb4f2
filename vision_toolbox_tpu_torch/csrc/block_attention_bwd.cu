// Fused transformer self-attention half-block, backward: from the forward's
// saves (xhat, rstd, q, k, v, the softmax probabilities p, proj with γ_ls)
// and the output cotangent dout,
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
// On Hopper that does not fit a block: at T = 512, head_dim 128 the K and V
// of one head alone take 147 KB of the 227 KB. So the attention part is
// FlashAttention-2's split, over tiles:
//   (a) dq per (32-query tile, head, image): the tile's rows of p (≤ 32 KB)
//       and an f32 row block of dp (≤ 64 KB) stay in shared memory while V
//       and then K stream through in 64-key tiles; rowsum(dp ⊙ p) is exact
//       over the whole row before ds is formed; ds is written to device
//       memory for (b);
//   (b) dk and dv per (32-key tile, head, image), streaming 64-query tiles of
//       p, ds, do and bf16(q·scale), accumulating in registers.
// (a) and (b) are the first design's wmma tiles, not yet moved to the
// register tiles. Around them: a row kernel for douts (block_bwd.cuh), the
// GEMM template (gemm.cuh: wgmma tiles, TMA loads) for do = douts·Wo and
// dy = [dq|dk|dv]·[Wq;Wk;Wv] (weights read (K, N) as wgmma's MN-major B),
// the LayerNorm row backward shared with the MLP backward, and the seven
// column sums from their partial rows in a fixed order: seven launches. The
// partial rows live in one f32 scratch the wrapper allocates
// (vtt_block_attention_bwd_partial_floats); no atomics, so a second backward is bit-equal.
// What bounds it: at vit_b_16 batch 128 the products are ≈ 149 GFLOP and
// the operands ≈ 0.47 GB (p alone is 119 MB), close to balanced on an H100
// (≈ 0.15 ms at the bf16 peak); ds, douts, do and dy make device-memory round
// trips the TPU kernel kept on chip.
#include <math.h>
#include <mma.h>

#include "block_bwd.cuh"

using namespace vtt;

namespace {

constexpr int BQ = 32;    // (a): query rows per block
constexpr int BKV = 64;   // (a): keys per streamed tile
constexpr int BK2 = 32;   // (b): key rows per block
constexpr int BQ2 = 64;   // (b): queries per streamed tile
constexpr int NT = 128;   // four warps
static_assert(BQ == BK2, "(a) and (b) write dbq/dbk/dbv partial rows of one (image, 32-row tile)");
constexpr int NW = NT / 32;

__host__ __device__ inline int keys64(int t) { return (t + BKV - 1) / BKV * BKV; }
__host__ __device__ inline int dp_pitch(int sp, int hd) { return (sp > hd ? sp : hd) + 4; }

// (a): do tile, one K/V tile, the f32 dp row block (then the dq tile), p/ds rows.
size_t dq_smem_bytes(int t, int hd) {
  const int sp = keys64(t);
  return static_cast<size_t>(BQ) * (hd + 8) * 2 + static_cast<size_t>(BKV) * (hd + 8) * 2 +
         static_cast<size_t>(BQ) * dp_pitch(sp, hd) * 4 + static_cast<size_t>(BQ) * (sp + 8) * 2;
}

// (b): p and ds tiles, do and q·scale tiles; then the f32 dv/dk tiles.
size_t dkv_smem_bytes(int hd) {
  const size_t stream = 2 * static_cast<size_t>(BQ2) * (BK2 + 8) * 2 +
                        2 * static_cast<size_t>(BQ2) * (hd + 8) * 2;
  const size_t out = 2 * static_cast<size_t>(BK2) * (hd + 4) * 4;
  return stream > out ? stream : out;
}

using namespace nvcuda;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(NT)
attn_bwd_dq_kernel(const bf16* __restrict__ dO, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ p, bf16* __restrict__ ds,
                   bf16* __restrict__ dqkv, float* __restrict__ dbqkv_part, int T, int D, int hd,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = keys64(T), lw = dp_pitch(sp, hd);
  const int ldh = hd + 8, ldp = sp + 8;
  bf16* dos = reinterpret_cast<bf16*>(smem);
  bf16* kv = dos + BQ * ldh;
  float* dpf = reinterpret_cast<float*>(kv + BKV * ldh);
  bf16* ps = reinterpret_cast<bf16*>(dpf + BQ * lw);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t base = static_cast<size_t>(b) * T * D + static_cast<size_t>(h) * hd;
  const size_t pbase = (static_cast<size_t>(b) * H + h) * T * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_head_rows<NT>(dO + base, q0, BQ, T, D, hd, dos, ldh);
  for (int i = threadIdx.x; i < BQ * sp; i += NT) {  // p rows, zero past T
    const int r = i / sp, c = i % sp;
    ps[r * ldp + c] = q0 + r < T && c < T ? p[pbase + static_cast<size_t>(q0 + r) * T + c]
                                          : __float2bfloat16(0.0f);
  }

  // dp = do·vᵀ (f32) over 64-key tiles of V
  for (int kt = 0; kt < sp; kt += BKV) {
    __syncthreads();
    load_head_rows<NT>(v + base, kt, BKV, T, D, hd, kv, ldh);
    __syncthreads();
    for (int t = warp; t < (BQ / 16) * (BKV / 16); t += NW) {
      const int i = t % (BQ / 16), j = t / (BQ / 16);
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < hd; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, dos + i * 16 * ldh + kk, ldh);
        wmma::load_matrix_sync(fb, kv + j * 16 * ldh + kk, ldh);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(dpf + i * 16 * lw + kt + j * 16, acc, lw, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // ds = bf16(p·(dp − Σ_keys dp·p)), one warp per query row; p is replaced by ds
  for (int r = warp; r < BQ; r += NW) {
    const float* row = dpf + r * lw;
    bf16* prow = ps + r * ldp;
    float s = 0.0f;
    for (int c = lane; c < T; c += 32) {
      s = __fadd_rn(s, __fmul_rn(row[c], __bfloat162float(prow[c])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    for (int c = lane; c < sp; c += 32) {
      const float pv = __bfloat162float(prow[c]);
      prow[c] = __float2bfloat16(__fmul_rn(pv, __fsub_rn(row[c], s)));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * T; i += NT) {
    const int r = i / T, c = i % T;
    if (q0 + r < T) ds[pbase + static_cast<size_t>(q0 + r) * T + c] = ps[r * ldp + c];
  }

  // dq = ds·k over 64-key tiles of K, accumulated in registers
  const int n_tiles = (BQ / 16) * (hd / 16);  // ≤ 16: ≤ 4 per warp
  Acc acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);
  for (int kt = 0; kt < sp; kt += BKV) {
    __syncthreads();
    load_head_rows<NT>(k + base, kt, BKV, T, D, hd, kv, ldh);
    __syncthreads();
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int t = warp + f * NW;
      if (t >= n_tiles) continue;
      const int i = t % (BQ / 16), j = t / (BQ / 16);
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, ps + i * 16 * ldp + kt + kk, ldp);
        wmma::load_matrix_sync(fb, kv + kk * ldh + j * 16, ldh);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int t = warp + f * NW;
    if (t >= n_tiles) continue;
    const int i = t % (BQ / 16), j = t / (BQ / 16);
    wmma::store_matrix_sync(dpf + i * 16 * lw + j * 16, acc[f], lw, wmma::mem_row_major);
  }
  __syncthreads();

  // dq·scale → bf16 into dqkv[:, h·hd : (h+1)·hd]; dbq's partial row (b, query
  // tile) from the f32 values
  const int ldq = 3 * D;
  float* part = dbqkv_part + static_cast<size_t>(b * gridDim.x + blockIdx.x) * ldq;
  for (int c = threadIdx.x; c < hd; c += NT) {
    float s = 0.0f;
    for (int r = 0; r < BQ && q0 + r < T; ++r) {
      const float val = __fmul_rn(dpf[r * lw + c], scale);
      s += val;
      dqkv[static_cast<size_t>(b * T + q0 + r) * ldq + h * hd + c] = __float2bfloat16(val);
    }
    part[h * hd + c] = s;
  }
}

__global__ void __launch_bounds__(NT)
attn_bwd_dkv_kernel(const bf16* __restrict__ dO, const bf16* __restrict__ q,
                    const bf16* __restrict__ p, const bf16* __restrict__ ds,
                    bf16* __restrict__ dqkv, float* __restrict__ dbqkv_part, int T, int D, int hd,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = BK2 + 8, ldh = hd + 8, lo = hd + 4;
  bf16* pt = reinterpret_cast<bf16*>(smem);  // [query][key]
  bf16* dst = pt + BQ2 * ldt;
  bf16* dos = dst + BQ2 * ldt;  // [query][hd]
  bf16* qs = dos + BQ2 * ldh;
  float* outf = reinterpret_cast<float*>(smem);  // after the loop: [dv | dk][key][hd]

  const int k0 = blockIdx.x * BK2, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t base = static_cast<size_t>(b) * T * D + static_cast<size_t>(h) * hd;
  const size_t pbase = (static_cast<size_t>(b) * H + h) * T * T;
  const int warp = threadIdx.x >> 5;

  // tiles of [dv; dk] (2 × BK2 × hd): t → (which, key tile i, column tile j)
  const int per = (BK2 / 16) * (hd / 16);
  const int n_tiles = 2 * per;  // ≤ 32: ≤ 8 per warp
  Acc acc[8];
#pragma unroll
  for (int f = 0; f < 8; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int q0 = 0; q0 < T; q0 += BQ2) {
    __syncthreads();
    for (int e = threadIdx.x; e < BQ2 * BK2; e += NT) {  // p, ds tiles; zero outside T × T
      const int r = e / BK2, c = e % BK2;
      const bool ok = q0 + r < T && k0 + c < T;
      const size_t o = pbase + static_cast<size_t>(q0 + r) * T + k0 + c;
      pt[r * ldt + c] = ok ? p[o] : __float2bfloat16(0.0f);
      dst[r * ldt + c] = ok ? ds[o] : __float2bfloat16(0.0f);
    }
    load_head_rows<NT>(dO + base, q0, BQ2, T, D, hd, dos, ldh);
    for (int e = threadIdx.x; e < BQ2 * (hd / 8); e += NT) {  // bf16(q·scale)
      const int r = e / (hd / 8), c = (e % (hd / 8)) * 8;
      Pack8 in, out;
      in.u = make_uint4(0, 0, 0, 0);
      if (q0 + r < T) {
        in.u = *reinterpret_cast<const uint4*>(q + base + static_cast<size_t>(q0 + r) * D + c);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out.h[j] = __float2bfloat16(__fmul_rn(__bfloat162float(in.h[j]), scale));
      }
      *reinterpret_cast<uint4*>(qs + r * ldh + c) = out.u;
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int t = warp + f * NW;
      if (t >= n_tiles) continue;
      const int which = t / per, rem = t % per;  // 0: dv = pᵀ·do, 1: dk = dsᵀ·(q·scale)
      const int i = rem % (BK2 / 16), j = rem / (BK2 / 16);
      const bf16* a = which ? dst : pt;
      const bf16* bm = which ? qs : dos;
      for (int kk = 0; kk < BQ2; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;  // (p or ds)ᵀ
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a + kk * ldt + i * 16, ldt);
        wmma::load_matrix_sync(fb, bm + kk * ldh + j * 16, ldh);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int t = warp + f * NW;
    if (t >= n_tiles) continue;
    const int which = t / per, rem = t % per;
    const int i = rem % (BK2 / 16), j = rem / (BK2 / 16);
    wmma::store_matrix_sync(outf + (which * BK2 + i * 16) * lo + j * 16, acc[f], lo,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // dv → dqkv[:, 2D + h·hd ...], dk → dqkv[:, D + h·hd ...]; dbv's and dbk's
  // partial row (b, key tile) from the f32 values
  const int ldq = 3 * D;
  float* part = dbqkv_part + static_cast<size_t>(b * gridDim.x + blockIdx.x) * ldq;
  for (int e = threadIdx.x; e < 2 * hd; e += NT) {
    const int which = e / hd, c = e % hd;
    const int col = (which ? D : 2 * D) + h * hd + c;
    float s = 0.0f;
    for (int r = 0; r < BK2 && k0 + r < T; ++r) {
      const float val = outf[(which * BK2 + r) * lo + c];
      s += val;
      dqkv[static_cast<size_t>(b * T + k0 + r) * ldq + col] = __float2bfloat16(val);
    }
    part[col] = s;
  }
}

// Floats of the partial-row scratch: dbo and dγ_ls (a row per DOUTS_ROWS
// rows), dbq/dbk/dbv (a row per image and 32-row tile, 3·D wide), dγ_ln and
// dβ_ln (a row per LN_ROWS rows); ops/block_attention.py
// `_bwd_partial_floats` mirrors it.
long long partial_floats(int B, int T, int D) {
  const long long M = static_cast<long long>(B) * T, pd = (M + DOUTS_ROWS - 1) / DOUTS_ROWS,
                  pa = static_cast<long long>(B) * ((T + BQ - 1) / BQ),
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
  const size_t smem_a = dq_smem_bytes(T, hd), smem_b = dkv_smem_bytes(hd);
  if (hd % 16 != 0 || hd > 128 || smem_a > 227 * 1024 || !gemm_shape_ok(M, D, D) ||
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
  const int pd = (M + DOUTS_ROWS - 1) / DOUTS_ROWS, pa = B * ((T + BQ - 1) / BQ),
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

  if (smem_a > 48 * 1024) {
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_a));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attn_bwd_dq_kernel<<<dim3((T + BQ - 1) / BQ, H, B), NT, smem_a, st>>>(
      static_cast<const bf16*>(dO), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(p), static_cast<bf16*>(ds), static_cast<bf16*>(dqkv), dbqkv_part,
      T, D, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (smem_b > 48 * 1024) {
    err = cudaFuncSetAttribute(attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_b));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attn_bwd_dkv_kernel<<<dim3((T + BK2 - 1) / BK2, H, B), NT, smem_b, st>>>(
      static_cast<const bf16*>(dO), static_cast<const bf16*>(q), static_cast<const bf16*>(p),
      static_cast<const bf16*>(ds), static_cast<bf16*>(dqkv), dbqkv_part, T, D, hd, scale);
  err = cudaGetLastError();
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
