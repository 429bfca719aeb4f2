// The GEMM template shared by the fused half-block kernels (block_mlp.cu,
// block_attention.cu and their backward files): out = epilogue(A · B + bias),
// bf16 × bf16 products with f32 accumulation on Hopper's warpgroup tensor
// cores (wgmma.mma_async, wgmma.cuh), and the LayerNorm row pass that makes
// the forward products' A operand.
//
// A is always a bf16 (M, K) activation. The forward's LayerNorm is taken
// once per row by ln_rows_kernel (a warp a row, two rows interleaved):
// y = bf16(LN(x)·γ + β) goes through device memory (2·M·K bytes) and, in the
// backward-save variant, bf16(xhat) and rstd beside it. B is a weight W in
// one of two layouts: B_NK, W (N, K) row-major, the nn.Linear layout, a
// K-major wgmma operand (out =
// A·Wᵀ, the forward products); or B_KN, W (K, N) row-major, read as wgmma's
// MN-major B (transpose flag 1) with no transposed copy (out = A·W: the
// backward products dg = douts·W2, dy2 = dh·W1, do = douts·Wo and
// dy = dqkv·Wqkv contract the weight's out dimension).
//
// Rounding points follow the TPU kernels (vision_toolbox_tpu/ops/block_mlp.py
// _fwd_kernel/_bwd_kernel, block_attention.py _fwd_kernel/_bwd_kernel): LN in
// f32 with var = mean(x²) − μ², the statistics summed in the first design's
// order (lane-strided, then the xor tree), y rounded to bf16, bias added in
// f32 before any bf16 rounding, residual epilogue (res + dp·γ_ls·proj) in
// f32, cast once to the output type; in the backward dh = bf16(dg·gelu'(h))
// with the bias gradient summed from the f32 values before that rounding.
// Only the order of the products' sums inside the tensor cores differs from
// the first design's.
//
// What bounds it on an H100: at vit_b_16 shapes (M = B·197 rows, K, N ∈
// {768, 2304, 3072}) the products are compute-bound (≥ 100 flop/byte), so
// the limit is the tensor cores' issue rate, reachable only through wgmma.
// The design: persistent blocks (two an SM: one block's epilogue runs
// beside the other's products) of two consumer warpgroups and a producer
// warp walk the 128 × BN output tiles, column tiles fastest so that a row
// tile of A is reused from L2 across W's (W stays in L2: ≤ 9.4 MB); a
// producer thread keeps TMA loads (cp.async.bulk.tensor, 128-byte swizzle, the M and K tails
// zero-filled) in flight through a ring of GEMM_STAGES stages guarded by
// mbarrier full/empty pairs; two consumer warpgroups each own 64 rows of the
// tile and issue four k16 wgmma a 64-deep stage, one stage in flight behind
// the wait; the epilogue works on the accumulator registers (bias, γ_ls and
// dp read as pairs, bf16 pairs or f32 pairs stored, no f32 tile in shared
// memory). EPI_GELU_GRAD's column sums leave each tile as one partial row
// (a fixed shuffle tree, then a fixed eight-row sum) for a fixed-order sum
// (block_bwd.cuh colsum_kernel): no atomics, so a backward repeats bit for
// bit. The column tile BN is 128 where it divides N, else 96 (ConvNeXt and
// Swin stage 1, D = 96 / 192; cait_xs, 288), else 32: every N % 32 == 0.
// Tensor maps are encoded on the host per launch (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links without
// -lcuda) and passed as __grid_constant__ parameters; every base pointer and
// row pitch TMA reads must be 16-byte aligned, and a launch that gets one
// that is not returns cudaErrorMisalignedAddress.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "wgmma.cuh"

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

// Elements i and i + 1 (i even): one 4- or 8-byte load.
__device__ __forceinline__ float2 ldv2(const Vec& v, int i, float dflt) {
  if (v.p == nullptr) return make_float2(dflt, dflt);
  if (v.is_bf16) {
    const bf16* b = static_cast<const bf16*>(v.p) + i;
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b));
  }
  return *reinterpret_cast<const float2*>(static_cast<const float*>(v.p) + i);
}

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// Elements i … i + 7 (i % 8 == 0): 16-byte loads.
__device__ __forceinline__ void ldv8(const Vec& v, int i, float dflt, float (&o)[8]) {
  if (v.p == nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = dflt;
  } else if (v.is_bf16) {
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(v.p) + i);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __bfloat162float(p.h[j]);
  } else {
    const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(v.p) + i);
    const float4 a = f[0], b = f[1];
    o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

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

// ---------------------------------------------------------------------------
// The LayerNorm row pass: y = bf16(LN(x)·γ + β), once per row.

constexpr int LN_ROW_WARPS = 8;  // warps a block, a row each at a time
constexpr int LN_ROW_BLOCKS_PER_SM = 8;

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// One warp two rows at a time, interleaved (each row's loads and xor tree
// overlap the other's latency; at D = 96 a row is three values a lane), rows
// gridDim.x · LN_ROW_WARPS apart (a few resident blocks an SM walk all rows):
// the statistics from lane-strided reads in the first design's order (its
// per-tile row_stats: each lane's sequential sum, then the xor tree, all
// lanes ending with the same bits), then y (and, with SAVE, bf16(xhat) and
// rstd) eight elements a lane at a time with 16-byte loads and stores.
// Requires D % 8 == 0 and 16-byte-aligned rows.
template <typename TX, bool SAVE>
__global__ void __launch_bounds__(LN_ROW_WARPS * 32)
ln_rows_kernel(const TX* __restrict__ x, Vec lns, Vec lnb, float eps, bf16* __restrict__ y,
               bf16* __restrict__ xhat, float* __restrict__ rstd, int M, int D) {
  constexpr int R = 2;  // rows a warp takes at a time
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * LN_ROW_WARPS;
  for (int m0 = blockIdx.x * LN_ROW_WARPS + (threadIdx.x >> 5); m0 < M; m0 += R * stride) {
    bool ok[R];
    const TX* row[R];
    float s[R], ss[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ok[r] = m0 + r * stride < M;
      row[r] = x + static_cast<size_t>(ok[r] ? m0 + r * stride : m0) * D;
      s[r] = ss[r] = 0.0f;
    }
    for (int k = lane; k < D; k += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = to_f32(row[r][k]);
        s[r] += v;
        ss[r] = __fadd_rn(ss[r], __fmul_rn(v, v));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
        ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], off);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!ok[r]) continue;
      const int m = m0 + r * stride;
      const float mu = s[r] / D;
      const float var = __fsub_rn(ss[r] / D, __fmul_rn(mu, mu));
      const float rs = rsqrtf(var + eps);
      if constexpr (SAVE) {
        if (lane == 0) rstd[m] = rs;
      }
      for (int k0 = lane * 8; k0 < D; k0 += 256) {
        float v[8], gm[8], bt[8];
        if constexpr (sizeof(TX) == 4) {
          const float4* f = reinterpret_cast<const float4*>(row[r] + k0);
          const float4 a = f[0], b = f[1];
          v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
          v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
        } else {
          Pack8 in;
          in.u = *reinterpret_cast<const uint4*>(row[r] + k0);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(in.h[j]);
        }
        ldv8(lns, k0, 1.0f, gm);
        ldv8(lnb, k0, 0.0f, bt);
        Pack8 yo, xo;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = __fmul_rn(__fsub_rn(v[j], mu), rs);
          xo.h[j] = __float2bfloat16(xh);
          yo.h[j] = __float2bfloat16(__fadd_rn(__fmul_rn(xh, gm[j]), bt[j]));
        }
        const size_t o = static_cast<size_t>(m) * D + k0;
        *reinterpret_cast<uint4*>(y + o) = yo.u;
        if constexpr (SAVE) *reinterpret_cast<uint4*>(xhat + o) = xo.u;
      }
    }
  }
}

template <typename TX, bool SAVE>
inline cudaError_t launch_ln_rows(const void* x, Vec lns, Vec lnb, float eps, void* y, void* xhat,
                                  float* rstd, int M, int D, cudaStream_t st) {
  const int blocks = (M + 2 * LN_ROW_WARPS - 1) / (2 * LN_ROW_WARPS);  // two rows a warp
  const int resident = LN_ROW_BLOCKS_PER_SM * sm_count();
  ln_rows_kernel<TX, SAVE><<<blocks < resident ? blocks : resident, LN_ROW_WARPS * 32, 0, st>>>(
      static_cast<const TX*>(x), lns, lnb, eps, static_cast<bf16*>(y), static_cast<bf16*>(xhat),
      rstd, M, D);
  return cudaGetLastError();
}

// The backward-save or the inference variant of the row pass.
template <typename TX>
inline cudaError_t launch_ln_rows(const void* x, Vec lns, Vec lnb, float eps, void* y, void* xhat,
                                  float* rstd, int M, int D, bool save, cudaStream_t st) {
  return save ? launch_ln_rows<TX, true>(x, lns, lnb, eps, y, xhat, rstd, M, D, st)
              : launch_ln_rows<TX, false>(x, lns, lnb, eps, y, xhat, rstd, M, D, st);
}

// ---------------------------------------------------------------------------
// The GEMM.

enum BLayout { B_NK = 0, B_KN = 1 };
enum Epilogue {
  EPI_BIAS = 0,       // out (bf16) = bf16(acc + bias)
  EPI_BIAS_GELU = 1,  // out (bf16) = bf16(gelu_as(h)), h = bf16(acc + bias); aux ← h
  EPI_RESIDUAL = 2,   // out (TX)   = TX(res + dp[row / T]·ls·(acc + bias)); aux ← bf16(acc + bias)
  EPI_F32 = 3,        // out (f32)  = acc + bias
  EPI_GELU_GRAD = 4,  // out (bf16) = bf16(acc·gelu'(aux_in)); a partial row of the f32 column sums
};

constexpr int BM = 128;  // rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;   // depth a stage: one 128-byte swizzle row of bf16
constexpr int GEMM_STAGES = 3;
constexpr int GEMM_THREADS = 288;  // two consumer warpgroups, then a producer warp
constexpr int GEMM_BLOCKS_PER_SM = 2;  // one block's epilogue runs beside the other's products

// Shared memory of one block: GEMM_STAGES stages of an A tile (BM × BK,
// K-major) and a B tile (BN × BK K-major for B_NK; for B_KN BN / CW chunks
// of BK × CW, MN-major, CW = 64 with the 128-byte swizzle or 32 with the
// 64-byte one), the column-sum exchange and the barriers.
template <int BN, int BL>
struct Tile {
  static constexpr int CW = BN % 64 == 0 ? 64 : 32;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = (A_BYTES + B_BYTES + 1023) / 1024 * 1024;
  static constexpr int RED = 8 * BN * 4;
  static constexpr int SMEM = 1024 + GEMM_STAGES * STAGE + RED + 2 * GEMM_STAGES * 8;
};

// Up to three products that share A and the shape run in one launch, their
// column tiles side by side (the q/k/v projections).
struct GemmArgs {
  const void* a;  // (M, K) bf16
  int M, N, K;
  const bf16* w[3];  // B_NK: (N, K) row-major; B_KN: (K, N) row-major
  Vec bias[3];
  void* out[3];  // (M, N): f32 for EPI_F32, TX for EPI_RESIDUAL, else bf16
  const void* res;  // EPI_RESIDUAL: (M, N) of type TX
  Vec ls;           // EPI_RESIDUAL: layer-scale gamma (N,) or null
  const float* dp;  // EPI_RESIDUAL: drop-path scale per image or null
  int rows_per_image;
  void* aux;           // SAVE, EPI_BIAS_GELU / EPI_RESIDUAL: bf16 (M, N) acc + bias, or null
  const bf16* aux_in;  // EPI_GELU_GRAD: the saved h (M, N)
  float* colsum_part;  // EPI_GELU_GRAD: (ceil(M / BM), N) f32 partial column sums
};

struct GemmParams {
  CUtensorMap a;
  CUtensorMap b[3];
  GemmArgs g;
  int col_tiles;  // of one product: N / BN
  int row_cols;   // column tiles of a row tile: col_tiles × products
  int n_tiles;    // row tiles × row_cols
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads across a wgmma wait.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void consumer_sync() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// Within each quad of lanes (lanes 4q … 4q + 3), a 4 × 4 transpose of
// 32-bit words: lane t's word c goes to lane c's word t. wgmma leaves lane t
// of a quad the column pair 2t, 2t + 1 of every 8-column chunk of a row; the
// transpose gives each lane all eight columns of one chunk (of four) for
// one 16-byte store, and turns 16-byte loads the other way. Two xor
// exchanges and lane-bit selects; every lane of the warp takes part.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4]) {
  const bool b0 = threadIdx.x & 1, b1 = threadIdx.x & 2;
  // with lane t ^ 1: the two chunks whose bit 0 is not t's
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, b0 ? w[0] : w[1], 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, b0 ? w[2] : w[3], 1);
  const uint32_t a0 = b0 ? w[1] : w[0], a1 = b0 ? w[3] : w[2];
  // with lane t ^ 2: the chunk whose bit 1 is not t's
  const uint32_t q0 = __shfl_xor_sync(0xffffffffu, b1 ? a0 : a1, 2);
  const uint32_t q1 = __shfl_xor_sync(0xffffffffu, b1 ? r0 : r1, 2);
  const uint32_t k0 = b1 ? a1 : a0, k1 = b1 ? r1 : r0;
  // chunk t from lanes t, t ^ 1, t ^ 2, t ^ 3: word p is lane p's
  const uint32_t x0 = b0 ? k1 : k0, x1 = b0 ? k0 : k1, x2 = b0 ? q1 : q0, x3 = b0 ? q0 : q1;
  w[0] = b1 ? x2 : x0;
  w[1] = b1 ? x3 : x1;
  w[2] = b1 ? x0 : x2;
  w[3] = b1 ? x1 : x3;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ void store16(void* p, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void load16(const void* p, bool ok, uint32_t (&w)[4]) {
  const uint4 v = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

// The epilogue of one consumer thread: rows r0 and r0 + 8, columns
// n0 + 8j + 2·(lane % 4) + {0, 1} (wgmma's accumulator layout), taken four
// chunks (32 columns) at a time; bf16 tensors move 16 bytes a lane through
// quad_transpose, f32 ones as 8-byte pairs (a quad's four pairs fill a
// 32-byte sector).
template <int EPI, typename TX, bool SAVE, int BN>
__device__ __forceinline__ void epilogue(const GemmArgs& g, float (&acc)[BN / 2], int m_tile,
                                         int n0, int z, float* red) {
  const int tw = threadIdx.x & 127, w = tw >> 5, l = tw & 31, t = l & 3, cw = threadIdx.x >> 7;
  const int r0 = m_tile * BM + cw * 64 + w * 16 + (l >> 2);
  const Vec bias = g.bias[z];
#pragma unroll
  for (int jj = 0; jj < BN / 32; ++jj) {
    float cs[4][2] = {};  // EPI_GELU_GRAD: this lane's column pairs over its two rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      const bool ok = row < g.M;
      const size_t rbase = static_cast<size_t>(row) * g.N + n0;
      const size_t o16 = rbase + (jj * 4 + t) * 8;  // this lane's 16-byte chunk
      float v[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jj * 4 + c;
        const float2 b = ldv2(bias, n0 + j * 8 + 2 * t, 0.0f);
        v[c][0] = acc[j * 4 + i * 2] + b.x;
        v[c][1] = acc[j * 4 + i * 2 + 1] + b.y;
      }
      uint32_t ow[4];
      if constexpr (EPI == EPI_BIAS) {
#pragma unroll
        for (int c = 0; c < 4; ++c) ow[c] = pack_bf16(v[c][0], v[c][1]);
      } else if constexpr (EPI == EPI_BIAS_GELU) {
        uint32_t hw[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          hw[c] = pack_bf16(v[c][0], v[c][1]);
          const float2 hf = unpack_bf16(hw[c]);
          ow[c] = pack_bf16(gelu_as(hf.x), gelu_as(hf.y));
        }
        if constexpr (SAVE) {
          quad_transpose(hw);
          if (ok) store16(static_cast<bf16*>(g.aux) + o16, hw);
        }
      } else if constexpr (EPI == EPI_RESIDUAL) {
        if constexpr (SAVE) {
          if (g.aux != nullptr) {
            uint32_t aw[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) aw[c] = pack_bf16(v[c][0], v[c][1]);
            quad_transpose(aw);
            if (ok) store16(static_cast<bf16*>(g.aux) + o16, aw);
          }
        }
        const float dp = g.dp != nullptr && ok ? g.dp[row / g.rows_per_image] : 1.0f;
        float2 rv[4];
        if constexpr (sizeof(TX) == 4) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float* res = static_cast<const float*>(g.res) + rbase + (jj * 4 + c) * 8 + 2 * t;
            rv[c] = ok ? *reinterpret_cast<const float2*>(res) : make_float2(0.0f, 0.0f);
          }
        } else {
          uint32_t rw[4];
          load16(static_cast<const bf16*>(g.res) + o16, ok, rw);
          quad_transpose(rw);
#pragma unroll
          for (int c = 0; c < 4; ++c) rv[c] = unpack_bf16(rw[c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 ls = ldv2(g.ls, n0 + (jj * 4 + c) * 8 + 2 * t, 1.0f);
          v[c][0] = __fadd_rn(rv[c].x, __fmul_rn(__fmul_rn(dp, ls.x), v[c][0]));
          v[c][1] = __fadd_rn(rv[c].y, __fmul_rn(__fmul_rn(dp, ls.y), v[c][1]));
          ow[c] = pack_bf16(v[c][0], v[c][1]);
        }
      } else if constexpr (EPI == EPI_GELU_GRAD) {
        uint32_t hw[4];
        load16(g.aux_in + o16, ok, hw);
        quad_transpose(hw);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 h = unpack_bf16(hw[c]);
          v[c][0] = __fmul_rn(v[c][0], gelu_grad_as(h.x));
          v[c][1] = __fmul_rn(v[c][1], gelu_grad_as(h.y));
          ow[c] = pack_bf16(v[c][0], v[c][1]);
          if (ok) {
            cs[c][0] += v[c][0];
            cs[c][1] += v[c][1];
          }
        }
      }
      constexpr bool kF32Out = EPI == EPI_F32 || (EPI == EPI_RESIDUAL && sizeof(TX) == 4);
      if constexpr (kF32Out) {
        if (ok) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float* out = static_cast<float*>(g.out[z]) + rbase + (jj * 4 + c) * 8 + 2 * t;
            *reinterpret_cast<float2*>(out) = make_float2(v[c][0], v[c][1]);
          }
        }
      } else {
        quad_transpose(ow);
        if (ok) store16(static_cast<bf16*>(g.out[z]) + o16, ow);
      }
    }
    if constexpr (EPI == EPI_GELU_GRAD) {  // 16 rows of this warp, a fixed tree
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cs[c][0] += __shfl_xor_sync(0xffffffffu, cs[c][0], off);
          cs[c][1] += __shfl_xor_sync(0xffffffffu, cs[c][1], off);
        }
        if (l < 4) {
          red[(cw * 4 + w) * BN + (jj * 4 + c) * 8 + l * 2] = cs[c][0];
          red[(cw * 4 + w) * BN + (jj * 4 + c) * 8 + l * 2 + 1] = cs[c][1];
        }
      }
    }
  }
  if constexpr (EPI == EPI_GELU_GRAD) {  // the tile's partial row: eight warps' sums in order
    consumer_sync();
    const int c = threadIdx.x;
    if (c < BN) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) s += red[r * BN + c];
      g.colsum_part[static_cast<size_t>(m_tile) * g.N + n0 + c] = s;
    }
    consumer_sync();
  }
}

// Persistent: gridDim.x ≤ two blocks an SM, each block walks tiles
// blockIdx.x, blockIdx.x + gridDim.x, …; tile t is row tile t / (col_tiles ·
// products) and, within it, column tile t % (col_tiles · products) (the
// products' column tiles side by side). SAVE compiles in the backward
// saves (aux): the inference kernels write none.
template <int EPI, typename TX, int BL, bool SAVE, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, GEMM_BLOCKS_PER_SM)
gemm_kernel(const __grid_constant__ GemmParams p) {
  using TL = Tile<BN, BL>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-aligned
  float* red = reinterpret_cast<float*>(smem + GEMM_STAGES * TL::STAGE);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = smem_u32(red + 8 * BN), empty0 = full0 + 8 * GEMM_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrival and the stage's bytes
      mbar_init(empty0 + 8 * s, 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const GemmArgs& g = p.g;
  const int nk = (g.K + BK - 1) / BK;
  const int row_cols = p.row_cols;
  if (threadIdx.x >= 256) {  // the producer warp: one thread issues every load
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
        const int m0 = t / row_cols * BM, ct = t % row_cols;
        const int z = ct / p.col_tiles, n0 = ct % p.col_tiles * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty0 + 8 * s, ph ^ 1);
          const uint32_t full = full0 + 8 * s, a_dst = base + s * TL::STAGE;
          const uint32_t b_dst = a_dst + TL::A_BYTES;
          mbar_expect_tx(full, TL::A_BYTES + TL::B_BYTES);
          tma_load(a_dst, &p.a, full, kb * BK, m0);
          if constexpr (BL == B_NK) {
            tma_load(b_dst, &p.b[z], full, kb * BK, n0);
          } else {
#pragma unroll
            for (int c = 0; c < BN / TL::CW; ++c) {
              tma_load(b_dst + c * BK * TL::CW * 2, &p.b[z], full, n0 + c * TL::CW, kb * BK);
            }
          }
          if (++s == GEMM_STAGES) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  const int cw = threadIdx.x >> 7;  // this warpgroup's 64 rows of the tile
  const bool signals = (threadIdx.x & 127) == 0;
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const int m_tile = t / row_cols, ct = t % row_cols;
    const int z = ct / p.col_tiles, n0 = ct % p.col_tiles * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(full0 + 8 * s, ph);
      const uint32_t a_tile = base + s * TL::STAGE + cw * 64 * BK * 2;
      const uint32_t b_tile = base + s * TL::STAGE + TL::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = gmma_desc(a_tile + kk * 32, 16, 1024, 1);
        uint64_t db;
        if constexpr (BL == B_NK) {
          db = gmma_desc(b_tile + kk * 32, 16, 1024, 1);
        } else if constexpr (TL::CW == 64) {  // 16 rows of 128 bytes a step; chunks 64 rows apart
          db = gmma_desc(b_tile + kk * 16 * 128, BK * 128, 1024, 1);
        } else {  // 64-byte rows, the 64-byte swizzle
          db = gmma_desc(b_tile + kk * 16 * 64, BK * 64, 512, 2);
        }
        wgmma<BN, BL == B_KN ? 1 : 0>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (prev >= 0 && signals) mbar_arrive(empty0 + 8 * prev);
      prev = s;
      if (++s == GEMM_STAGES) s = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    if (signals) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    epilogue<EPI, TX, SAVE, BN>(g, acc, m_tile, n0, z, red);
  }
}

// ---------------------------------------------------------------------------
// Host side.

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Every pointer an entry hands to TMA or to 16-byte loads (null passes).
inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps) {
    if (!aligned16(p)) return false;
  }
  return true;
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiledFn>(nullptr);
    }
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// A 2-D bf16 tensor map: `inner` contiguous elements a row, `outer` rows
// `pitch` elements apart, boxes of box_inner × box_outer; elements outside
// the tensor read as zero.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int inner, int outer, int pitch,
                            int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  if (!aligned16(base) || (static_cast<size_t>(pitch) * 2) % 16) return cudaErrorMisalignedAddress;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Static: its per-kernel flag must stay this library's (a function-local
// static of an inline function is one object across every library loaded
// into the process, as the A/B scripts load several builds).
template <int EPI, typename TX, int BL, bool SAVE, int BN>
static cudaError_t launch_tiles(const GemmArgs& g, int n_products, cudaStream_t stream) {
  using TL = Tile<BN, BL>;
  GemmParams p;
  p.g = g;
  cudaError_t err = make_map(&p.a, g.a, g.K, g.M, g.K, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  for (int z = 0; z < n_products && err == cudaSuccess; ++z) {
    err = BL == B_NK
              ? make_map(&p.b[z], g.w[z], g.K, g.N, g.K, BK, BN, CU_TENSOR_MAP_SWIZZLE_128B)
              : make_map(&p.b[z], g.w[z], g.N, g.K, g.N, TL::CW, BK,
                         TL::CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err != cudaSuccess) return err;
  p.col_tiles = g.N / BN;
  p.row_cols = p.col_tiles * n_products;
  p.n_tiles = (g.M + BM - 1) / BM * p.row_cols;
  auto* kernel = gemm_kernel<EPI, TX, BL, SAVE, BN>;
  static unsigned attr_set = 0;  // a bit per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (err != cudaSuccess) return err;
    attr_set |= 1u << dev;
  }
  const int slots = GEMM_BLOCKS_PER_SM * sm_count();
  const int grid = p.n_tiles < slots ? p.n_tiles : slots;
  kernel<<<grid, GEMM_THREADS, TL::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// Launches one GEMM and returns the launch's error: 128-column tiles where
// N allows them, else 96, else 32.
template <int EPI, typename TX, int BL = B_NK, bool SAVE = false>
inline cudaError_t launch_gemm(const GemmArgs& g, int n_products, cudaStream_t stream) {
  if (g.N % 128 == 0) return launch_tiles<EPI, TX, BL, SAVE, 128>(g, n_products, stream);
  if (g.N % 96 == 0) return launch_tiles<EPI, TX, BL, SAVE, 96>(g, n_products, stream);
  return launch_tiles<EPI, TX, BL, SAVE, 32>(g, n_products, stream);
}

// The inference or the backward-save variant of a forward product.
template <int EPI, typename TX>
inline cudaError_t launch_forward_gemm(const GemmArgs& g, int n_products, bool save,
                                       cudaStream_t stream) {
  return save ? launch_gemm<EPI, TX, B_NK, true>(g, n_products, stream)
              : launch_gemm<EPI, TX, B_NK, false>(g, n_products, stream);
}

inline bool gemm_shape_ok(int M, int N, int K) {
  // tile indices are ints: row tiles × the narrowest column tiles × 3 products
  return M > 0 && N > 0 && K > 0 && N % 32 == 0 && K % 32 == 0 &&
         (static_cast<long long>(M) + BM - 1) / BM * (N / 32) * 3 < (1LL << 31);
}

inline Vec vec(const void* p, int is_bf16) { return Vec{p, is_bf16}; }

}  // namespace vtt
