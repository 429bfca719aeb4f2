// Tiled bf16 GEMM shared by the fused half-block kernels (block_mlp.cu,
// block_attention.cu and their backward files): out = epilogue(A · B + bias),
// bf16 × bf16 products with f32 accumulation on the tensor cores
// (nvcuda::wmma m16n16k16).
//
// A is either a bf16 activation (A_BF16) or the LayerNorm of the f32/bf16
// block input computed on the fly (A_LAYERNORM: per-row fast-variance
// statistics at block start, then each A tile is normalised, scaled and
// rounded to bf16 as it is staged into shared memory, so the normalised
// activation never goes through device memory; the backward-save variant,
// SAVE, also writes bf16(xhat) and rstd once, from the blocks of the first
// column tile). B is a weight W in one of two layouts: B_NK, W (N, K)
// row-major, the nn.Linear layout read as a column-major K×N operand
// (out = A·Wᵀ, the forward products); or B_KN, W (K, N) row-major (out = A·W:
// the backward products dg = douts·W2, dy2 = dh·W1, do = douts·Wo and
// dy = dqkv·Wqkv contract the weight's out dimension).
//
// Rounding points follow the TPU kernels (vision_toolbox_tpu/ops/block_mlp.py
// _fwd_kernel/_bwd_kernel, block_attention.py _fwd_kernel/_bwd_kernel): LN in
// f32 with var = mean(x²) − μ², y rounded to bf16, bias added in f32 before
// any bf16 rounding, residual epilogue (res + dp·γ_ls·proj) in f32, cast once
// to the output type; in the backward dh = bf16(dg·gelu'(h)) with the bias
// gradient summed from the f32 values before that rounding.
//
// What bounds it on an H100: at vit_b_16 shapes (M = B·197 rows, K, N ∈
// {768, 2304, 3072}) the products are compute-bound (≥ 100 flop/byte), so
// the limit is tensor-core issue rate. This first version uses 64×64×32
// tiles, four warps of 32×32, register-staged double buffering and
// mma.sync-class wmma. Measured at vit_b_16 batch 128 on an H100 SXM at
// 700 W: ~110 TFLOP/s with a bf16 A operand and ~44 TFLOP/s with the LN
// prologue, whose per-block row statistics (every block re-reads its 64
// full rows) and per-element LN arithmetic cost more than the products;
// both far below the card's 989 TFLOP/s bf16 peak. A cheaper LN prologue
// and wgmma/TMA pipelines are the next steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace vtt {

using bf16 = __nv_bfloat16;

// A per-channel parameter vector (LN scale/bias, linear bias, layer-scale
// gamma), stored as f32 or bf16. A null pointer reads as the default value.
struct Vec {
  const void* p;
  int is_bf16;
};

__device__ __forceinline__ float ldv(const Vec& v, int i, float dflt) {
  if (v.p == nullptr) return dflt;
  return v.is_bf16 ? __bfloat162float(static_cast<const bf16*>(v.p)[i])
                   : static_cast<const float*>(v.p)[i];
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

constexpr float kAS1 = 0.254829592f, kAS2 = -0.284496736f, kAS3 = 1.421413741f;
constexpr float kAS4 = -1.453152027f, kAS5 = 1.061405429f, kASP = 0.3275911f;

// erf by Abramowitz–Stegun 7.1.26, the polynomial the TPU kernel uses
// (block_mlp.py _erf_f32), so the GELU matches it rather than erff.
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + kASP * ax);
  const float y = 1.0f - ((((kAS5 * t + kAS4) * t + kAS3) * t + kAS2) * t + kAS1) * t * expf(-ax * ax);
  return x < 0.0f ? -y : y;
}

__device__ __forceinline__ float gelu_as(float h) {
  return 0.5f * h * (1.0f + erf_as(h / 1.41421356237309515f));
}

// gelu'(h) = Φ(h) + h·φ(h) with the same polynomial (block_mlp.py
// _gelu_grad_f32): exp(−x²) at x = h/√2 serves both terms.
__device__ __forceinline__ float gelu_grad_as(float h) {
  const float x = h * 0.70710678118654746f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + kASP * ax);
  const float e = expf(-x * x);
  const float y = 1.0f - ((((kAS5 * t + kAS4) * t + kAS3) * t + kAS2) * t + kAS1) * t * e;
  const float erf = x < 0.0f ? -y : y;
  return 0.5f * (1.0f + erf) + h * e * 0.3989422804014327f;
}

enum AMode { A_BF16 = 0, A_LAYERNORM = 1 };
enum BLayout { B_NK = 0, B_KN = 1 };
enum Epilogue {
  EPI_BIAS = 0,       // out (bf16) = bf16(acc + bias)
  EPI_BIAS_GELU = 1,  // out (bf16) = bf16(gelu_as(h)), h = bf16(acc + bias); aux ← h
  EPI_RESIDUAL = 2,   // out (TX)   = TX(res + dp[row / T]·ls·(acc + bias)); aux ← bf16(acc + bias)
  EPI_F32 = 3,        // out (f32)  = acc + bias
  EPI_GELU_GRAD = 4,  // out (bf16) = bf16(acc·gelu'(aux_in)); colsum += acc·gelu'(aux_in) in f32
};

constexpr int BM = 64, BN = 64, BK = 32, NTHREADS = 128;
constexpr int SA = BK + 8;  // smem pitch of A and B_NK tiles in bf16 (80 B: 16-B rows, 32-B fragments)
constexpr int SB = BN + 8;  // smem pitch of B_KN tiles in bf16 (144 B)
constexpr int SC = BN + 4;  // smem pitch of the f32 output tile

// Up to three products that share A and the shape run in one launch,
// selected by blockIdx.z (the q/k/v projections).
struct GemmArgs {
  const void* a;  // A_BF16: (M, K) bf16; A_LAYERNORM: block input (M, K) of type TX
  int M, N, K;
  const bf16* w[3];  // B_NK: (N, K) row-major; B_KN: (K, N) row-major
  Vec bias[3];
  void* out[3];  // (M, N): f32 for EPI_F32, TX for EPI_RESIDUAL, else bf16
  Vec ln_scale, ln_bias;
  float eps;
  const void* res;  // EPI_RESIDUAL: (M, N) of type TX
  Vec ls;           // EPI_RESIDUAL: layer-scale gamma (N,) or null
  const float* dp;  // EPI_RESIDUAL: drop-path scale per image or null
  int rows_per_image;
  void* aux;           // SAVE, EPI_BIAS_GELU / EPI_RESIDUAL: bf16 (M, N) acc + bias, or null
  const bf16* aux_in;  // EPI_GELU_GRAD: the saved h (M, N)
  float* colsum;       // EPI_GELU_GRAD: (N,) f32 column sums, accumulated with atomics
  bf16* xhat;          // SAVE, A_LAYERNORM: bf16 (M, K) normalised input
  float* rstd;         // SAVE, A_LAYERNORM: (M,) 1/σ
};

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// The blocks that write the LN saves: one column tile of the first product
// covers every (row, k) of its rows exactly once.
__device__ __forceinline__ bool writes_ln_saves() { return blockIdx.x == 0 && blockIdx.z == 0; }

// Per-row LN statistics of the BM rows of this tile, one warp per row.
template <typename TX, bool SAVE>
__device__ void row_stats(const GemmArgs& g, int m0, float* s_mu, float* s_rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += NTHREADS / 32) {
    const int m = m0 + r;
    float s = 0.0f, ss = 0.0f;
    if (m < g.M) {
      const TX* row = static_cast<const TX*>(g.a) + static_cast<size_t>(m) * g.K;
      for (int k = lane; k < g.K; k += 32) {
        const float v = to_f32(row[k]);
        s += v;
        ss = __fadd_rn(ss, __fmul_rn(v, v));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane == 0) {
      const float mu = s / g.K;
      const float var = __fsub_rn(ss / g.K, __fmul_rn(mu, mu));
      const float rs = rsqrtf(var + g.eps);
      s_mu[r] = m < g.M ? mu : 0.0f;
      s_rs[r] = m < g.M ? rs : 0.0f;
      if constexpr (SAVE) {
        if (m < g.M && writes_ln_saves()) g.rstd[m] = rs;
      }
    }
  }
}

// Global → registers: each thread owns two 8-element groups of the BM×BK
// A tile (raw bytes; f32 input needs two uint4 per group).
template <int AM, typename TX>
__device__ __forceinline__ void load_a(const GemmArgs& g, int m0, int k0, uint4 (&raw)[2][2]) {
  constexpr bool kWide = AM == A_LAYERNORM && sizeof(TX) == 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int r = idx >> 2, c = (idx & 3) * 8;
    const int m = m0 + r;
    raw[i][0] = raw[i][1] = make_uint4(0, 0, 0, 0);
    if (m < g.M) {
      const size_t off = static_cast<size_t>(m) * g.K + k0 + c;
      if constexpr (kWide) {
        const uint4* src = reinterpret_cast<const uint4*>(static_cast<const float*>(g.a) + off);
        raw[i][0] = __ldg(src);
        raw[i][1] = __ldg(src + 1);
      } else {
        raw[i][0] = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.a) + off));
      }
    }
  }
}

// Registers → shared memory, applying the LN prologue in A_LAYERNORM mode.
template <int AM, typename TX, bool SAVE>
__device__ __forceinline__ void store_a(const GemmArgs& g, int m0, int k0, const uint4 (&raw)[2][2],
                                        bf16* as, const float* s_mu, const float* s_rs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int r = idx >> 2, c = (idx & 3) * 8;
    Pack8 out;
    if constexpr (AM == A_BF16) {
      out.u = raw[i][0];
    } else {
      float v[8];
      if constexpr (sizeof(TX) == 4) {
        const float* f0 = reinterpret_cast<const float*>(&raw[i][0]);
        const float* f1 = reinterpret_cast<const float*>(&raw[i][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = f0[j];
          v[j + 4] = f1[j];
        }
      } else {
        Pack8 in;
        in.u = raw[i][0];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(in.h[j]);
      }
      const float mu = s_mu[r], rs = s_rs[r];
      Pack8 xh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + c + j;
        const float xhat = __fmul_rn(__fsub_rn(v[j], mu), rs);
        xh.h[j] = __float2bfloat16(xhat);
        out.h[j] = __float2bfloat16(
            __fadd_rn(__fmul_rn(xhat, ldv(g.ln_scale, k, 1.0f)), ldv(g.ln_bias, k, 0.0f)));
      }
      if constexpr (SAVE) {
        if (m0 + r < g.M && writes_ln_saves()) {
          *reinterpret_cast<uint4*>(g.xhat + static_cast<size_t>(m0 + r) * g.K + k0 + c) = xh.u;
        }
      }
    }
    *reinterpret_cast<uint4*>(as + r * SA + c) = out.u;
  }
}

template <int BL>
__device__ __forceinline__ void load_b(const GemmArgs& g, const bf16* w, int n0, int k0,
                                       uint4 (&rb)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    if constexpr (BL == B_NK) {  // BN rows of W, BK columns each
      const int r = idx >> 2, c = (idx & 3) * 8;
      rb[i] = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * g.K + k0 + c));
    } else {  // BK rows of W, BN columns each
      const int r = idx >> 3, c = (idx & 7) * 8;
      rb[i] = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(k0 + r) * g.N + n0 + c));
    }
  }
}

template <int BL>
__device__ __forceinline__ void store_b(const uint4 (&rb)[2], bf16* bs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    if constexpr (BL == B_NK) {
      *reinterpret_cast<uint4*>(bs + (idx >> 2) * SA + (idx & 3) * 8) = rb[i];
    } else {
      *reinterpret_cast<uint4*>(bs + (idx >> 3) * SB + (idx & 7) * 8) = rb[i];
    }
  }
}

// One BK-deep step of this warp's 32×32 sub-tile.
template <int BL>
__device__ __forceinline__ void mma_step(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&acc)[2][2],
    const bf16* as, const bf16* bs, int wm, int wn) {
  using namespace nvcuda;
  using BLay = typename std::conditional<BL == B_NK, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLay> fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], as + (wm + i * 16) * SA + kk, SA);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if constexpr (BL == B_NK) {
        wmma::load_matrix_sync(fb[j], bs + (wn + j * 16) * SA + kk, SA);
      } else {
        wmma::load_matrix_sync(fb[j], bs + kk * SB + wn + j * 16, SB);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// Grid (N / BN, ceil(M / BM), number of products). Requires N % BN == 0 and
// K % BK == 0 (the wrappers check); rows past M are masked. SAVE compiles in
// the backward saves (xhat, rstd, aux): the inference kernels write none.
template <int AM, int EPI, typename TX, int BL = B_NK, bool SAVE = false>
__global__ void __launch_bounds__(NTHREADS) gemm_kernel(const GemmArgs g) {
  using namespace nvcuda;
  static_assert(BK * SB <= BN * SA, "a B_KN tile fits the B_NK tile's buffer");
  __shared__ __align__(128) bf16 as[2][BM * SA];
  __shared__ __align__(128) bf16 bs[2][BN * SA];
  __shared__ __align__(128) float cs[BM * SC];
  __shared__ float s_mu[BM], s_rs[BM];

  const int z = blockIdx.z;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const bf16* w = g.w[z];

  if constexpr (AM == A_LAYERNORM) {
    row_stats<TX, SAVE>(g, m0, s_mu, s_rs);
    __syncthreads();
  }

  uint4 ra[2][2], rb[2];
  load_a<AM, TX>(g, m0, 0, ra);
  load_b<BL>(g, w, n0, 0, rb);
  store_a<AM, TX, SAVE>(g, m0, 0, ra, as[0], s_mu, s_rs);
  store_b<BL>(rb, bs[0]);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int kt_end = g.K / BK;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < kt_end;
    if (more) {  // next tile's loads are in flight while this one computes
      load_a<AM, TX>(g, m0, (kt + 1) * BK, ra);
      load_b<BL>(g, w, n0, (kt + 1) * BK, rb);
    }
    mma_step<BL>(acc, as[s], bs[s], wm, wn);
    if (more) {
      store_a<AM, TX, SAVE>(g, m0, (kt + 1) * BK, ra, as[s ^ 1], s_mu, s_rs);
      store_b<BL>(rb, bs[s ^ 1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + i * 16) * SC + wn + j * 16, acc[i][j], SC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r;
    if (m >= g.M) {
      if constexpr (EPI == EPI_GELU_GRAD) cs[r * SC + c] = 0.0f;
      continue;
    }
    const int n = n0 + c;
    const float v = cs[r * SC + c] + ldv(g.bias[z], n, 0.0f);
    const size_t o = static_cast<size_t>(m) * g.N + n;
    if constexpr (EPI == EPI_BIAS) {
      static_cast<bf16*>(g.out[z])[o] = __float2bfloat16(v);
    } else if constexpr (EPI == EPI_BIAS_GELU) {
      if constexpr (SAVE) static_cast<bf16*>(g.aux)[o] = __float2bfloat16(v);
      static_cast<bf16*>(g.out[z])[o] = __float2bfloat16(gelu_as(round_bf16(v)));
    } else if constexpr (EPI == EPI_RESIDUAL) {
      if constexpr (SAVE) {
        if (g.aux != nullptr) static_cast<bf16*>(g.aux)[o] = __float2bfloat16(v);
      }
      const float dp = g.dp != nullptr ? g.dp[m / g.rows_per_image] : 1.0f;
      const float scale = __fmul_rn(dp, ldv(g.ls, n, 1.0f));
      const float res = to_f32(static_cast<const TX*>(g.res)[o]);
      static_cast<TX*>(g.out[z])[o] = from_f32<TX>(__fadd_rn(res, __fmul_rn(scale, v)));
    } else if constexpr (EPI == EPI_F32) {
      static_cast<float*>(g.out[z])[o] = v;
    } else {
      const float d = __fmul_rn(v, gelu_grad_as(__bfloat162float(g.aux_in[o])));
      static_cast<bf16*>(g.out[z])[o] = __float2bfloat16(d);
      cs[r * SC + c] = d;
    }
  }
  if constexpr (EPI == EPI_GELU_GRAD) {  // column sums of the f32 values of this tile
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += NTHREADS) {
      float s = 0.0f;
      for (int r = 0; r < BM; ++r) s += cs[r * SC + c];
      atomicAdd(g.colsum + n0 + c, s);
    }
  }
}

// Launches and returns the launch's error (cudaGetLastError).
template <int AM, int EPI, typename TX, int BL = B_NK, bool SAVE = false>
inline cudaError_t launch_gemm(const GemmArgs& g, int n_products, cudaStream_t stream) {
  const dim3 grid(g.N / BN, (g.M + BM - 1) / BM, n_products);
  gemm_kernel<AM, EPI, TX, BL, SAVE><<<grid, NTHREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

// The inference or the backward-save variant of a forward product.
template <int AM, int EPI, typename TX>
inline cudaError_t launch_forward_gemm(const GemmArgs& g, int n_products, bool save,
                                       cudaStream_t stream) {
  return save ? launch_gemm<AM, EPI, TX, B_NK, true>(g, n_products, stream)
              : launch_gemm<AM, EPI, TX, B_NK, false>(g, n_products, stream);
}

inline bool gemm_shape_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && N % BN == 0 && K % BK == 0 && (M + BM - 1) / BM <= 65535;
}

inline Vec vec(const void* p, int is_bf16) { return Vec{p, is_bf16}; }

// Rows [row0, row0 + n_rows) of one head of a (rows, ld_src) bf16 buffer →
// shared memory with pitch ld; rows at or past `valid` are zero-filled. The
// attention kernels load q/k/v/o head tiles with it (hd % 8 == 0).
template <int NT>
__device__ __forceinline__ void load_head_rows(const bf16* src, int row0, int n_rows, int valid,
                                               int ld_src, int hd, bf16* dst, int ld) {
  const int vecs = hd / 8;
  for (int i = threadIdx.x; i < n_rows * vecs; i += NT) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) {
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * ld_src + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

}  // namespace vtt
