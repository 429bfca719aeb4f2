// Register-tile attention machinery for Hopper (sm_90a), used by the
// flash-attention kernels (K6: flash_attention.cu, flash_attention_bwd.cu)
// and the short-attention kernels (K2: short_attention{,_bwd}.cu).
//
// Products run as mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with
// their f32 accumulators in registers. One warp owns a 16-row tile of the
// product; a thread of lane l = 4g + t holds, of each 16 × 8 accumulator
// tile, rows g and g + 8 at columns 2t and 2t + 1 (c[0..1] row g, c[2..3]
// row g + 8). Two neighbouring accumulator tiles (16 × 16) are exactly the
// A-operand fragment of a 16 × 16 bf16 tile (FlashAttention-2), so a score
// tile that was an accumulator feeds the next product from registers: p·v,
// pᵀ·g, ds·k never pass through shared memory.
//
// Exact operands: an operand is a sum of bf16 planes. A bf16 input is one
// plane; an f32 value x is split into x0 = bf16(x), x1 = bf16(x − x0),
// x2 = bf16(x − x0 − x1), so two planes hold x to 2⁻¹⁶ of its value and
// three to 2⁻²⁴, f32's own rounding. A product sums the plane products
// (i, j) with i + j below the larger plane count; bf16 × bf16 products are
// exact in f32. Operands in shared memory are stored as planes (one for a
// bf16 input, three for an f32 one, split at load time); intermediates
// that live in registers (p, ds) are split in registers.
//
// Shared-memory tiles are row-major bf16 with a pitch of (width + 8)
// elements: (width + 8) / 8 is odd for any width that is a multiple of 16,
// so the eight 16-byte rows an ldmatrix phase reads fall in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace vtt_mma {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2⁻²²): exp(y) is
// computed as 2^(y·log2 e) with the product folded into one fma, as
// FlashAttention-2 does; an f32 rounding apart from expf.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }
__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Lane coordinates in an accumulator tile: row g (and g + 8), columns 2t, 2t + 1.
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A (batch·head) pair's matrix of a (B, L, N, H) tensor with element
// strides (sb, sl, sn) and a unit last stride: row r at p + r·sl. The flat
// (B·N, L, H) layout is N = 1.
template <typename T>
struct Mat {
  T* p;
  long long sb, sl, sn;
  __device__ __forceinline__ T* pair(int pair, int N) const {
    return p + static_cast<long long>(pair / N) * sb + static_cast<long long>(pair % N) * sn;
  }
};

// ---- asynchronous copies ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; `bytes` < 16 fills the rest with zeros (0: all).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The head of one iteration of a loop over streamed tiles with an ST-stage
// ring (tile i in stage i % ST; the caller loaded tiles 0..ST − 2 before
// the loop, each committed as its own group): waits for tile `it`, makes
// it visible to the block, and starts the copy of tile it + ST − 1 into the
// stage tile it − 1 used, which every warp has left at the barrier. One
// barrier a tile. With one stage the tile is loaded here, and the caller
// ends the iteration with a barrier before the stage is refilled.
template <int ST, typename Load>
__device__ __forceinline__ void ring_step(int it, int ntiles, Load&& load) {
  if constexpr (ST == 1) {
    load(it);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  } else {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (it + ST - 1 < ntiles) load(it + ST - 1);
    cp_async_commit();
  }
}

// x as NP bf16 planes at dst, dst + plane, ...
template <int NP>
__device__ __forceinline__ void split_store(float x, bf16* dst, int plane) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const bf16 h = __float2bfloat16(x);
    dst[i * plane] = h;
    x -= __bfloat162float(h);  // exact: the low bits h did not keep
  }
}

// Rows [r0, r0 + rows) of one pair's (n × H) matrix (row pitch `pitch`)
// into NP bf16 planes of `width` columns (pitch ld, plane stride `plane`);
// columns H..width and rows at or past n are zero. A bf16 matrix whose rows
// are 16-byte aligned (`vec`) goes through cp.async (the caller commits and
// waits); anything else is read and split here, synchronously.
template <typename T, int NP>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, int plane, const T* src,
                                          long long pitch, int r0, int rows, int n, int H,
                                          int width, bool vec, int tid, int nthreads) {
  if constexpr (NP == 1 && std::is_same<T, bf16>::value) {
    if (vec) {
      const int per = width / 8;  // 16-byte pieces of a row
      for (int e = tid; e < rows * per; e += nthreads) {
        const int r = e / per, c = (e % per) * 8;
        const bool ok = r0 + r < n && c < H;
        cp_async16(dst + r * ld + c, ok ? src + (r0 + r) * pitch + c : src, ok ? 16 : 0);
      }
      return;
    }
  }
  for (int e = tid; e < rows * width; e += nthreads) {
    const int r = e / width, c = e % width;
    const float x = r0 + r < n && c < H ? to_f32(src[(r0 + r) * pitch + c]) : 0.0f;
    split_store<NP>(x, dst + r * ld + c, plane);
  }
}

// ---- fragments and products -------------------------------------------------

// Four 8 × 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8. The pattern below reads, from a row-major tile
// at (r0, c0): as A, the 16 × 16 operand fragment (a0..a3); transposed
// (`trans`), the B fragments of a [k][n] tile for n-tiles c0 and c0 + 8
// (b0, b1 each).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* tile, int ld, int r0, int c0) {
  const int l = threadIdx.x & 31;
  const bf16* p = tile + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + c0 + (l >> 4) * 8;
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  }
}

// The B fragments of n-tiles n0 and n0 + 8 at depth k0..k0 + 15 from a
// row-major [n][k] tile (k's rows for q·kᵀ): r[0..1] n-tile n0, r[2..3]
// n-tile n0 + 8.
__device__ __forceinline__ void ldsm_b_nk(uint32_t r[4], const bf16* tile, int ld, int n0, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* p = tile + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a·b for one 16 × 8 × 16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The exact-operand product over planes: c0 += Σ a[i]·b[j][0..1] and
// c1 += Σ a[i]·b[j][2..3] for i + j below the larger plane count, with a
// NA planes of an A fragment and b NB planes of a two-n-tile B fragment.
template <int NA, int NB>
__device__ __forceinline__ void mma_planes2(float c0[4], float c1[4], const uint32_t (*a)[4],
                                            const uint32_t (*b)[4]) {
  constexpr int N = NA > NB ? NA : NB;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (i + j < N) {
        mma16816(c0, a[i], b[j]);
        mma16816(c1, a[i], b[j] + 2);
      }
    }
  }
}

// Two f32 values as NP planes of a bf16x2 register (x0 in the low half).
template <int NP>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t* out) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    out[i] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// The A fragment (NP planes) of the 16 × 16 tile formed by the accumulator
// tiles c0 (columns 0..7) and c1 (columns 8..15): the FlashAttention-2
// identity of the two layouts.
template <int NP>
__device__ __forceinline__ void acc_to_a(const float c0[4], const float c1[4], uint32_t (*a)[4]) {
  uint32_t r0[NP], r1[NP], r2[NP], r3[NP];
  split_pair<NP>(c0[0], c0[1], r0);
  split_pair<NP>(c0[2], c0[3], r1);
  split_pair<NP>(c1[0], c1[1], r2);
  split_pair<NP>(c1[2], c1[3], r3);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    a[i][0] = r0[i];
    a[i][1] = r1[i];
    a[i][2] = r2[i];
    a[i][3] = r3[i];
  }
}

// ---- the two products of an attention tile --------------------------------

// acc (16 rows × NC columns) = a·bᵀ over the whole head: the warp's 16
// rows of the [row][h] tile `a` (plane stride a_plane) against the NC rows
// of the [col][h] tile `b` (plane stride b_plane), both of pitch ld. Only
// the first `ncg` 16-wide column groups are formed (the rest stay as they
// were): a caller whose last tile is ragged stops at the next multiple of
// 16 past its end.
template <int IN, int NC, int HD>
__device__ __forceinline__ void scores_t(float (*acc)[4], const bf16* a, const bf16* b,
                                         int a_plane, int b_plane, int ld, int warp, int nkh,
                                         int ncg = NC / 16) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if (kk >= nkh) break;
    uint32_t af[IN][4];
#pragma unroll
    for (int i = 0; i < IN; ++i) ldsm_x4<false>(af[i], a + i * a_plane, ld, warp * 16, kk * 16);
#pragma unroll
    for (int jj = 0; jj < NC / 16; ++jj) {
      if (jj >= ncg) break;
      uint32_t bfr[IN][4];
#pragma unroll
      for (int i = 0; i < IN; ++i) ldsm_b_nk(bfr[i], b + i * b_plane, ld, jj * 16, kk * 16);
      mma_planes2<IN, IN>(acc[2 * jj], acc[2 * jj + 1], af, bfr);
    }
  }
}

// acc (16 rows × the chunk's columns) += x·b: x (16 × NK) the warp's f32
// accumulator tiles as MID-plane A fragments, b the [k][h] tile (NK rows,
// plane stride b_plane, pitch ld) at columns c0.. c0 + hc. Only the first
// `nkg` 16-deep steps are taken (x is zero past them).
template <int MID, int IN, int NK, int HC>
__device__ __forceinline__ void grad_step(float (*acc)[4], float (*x)[4], const bf16* b,
                                          int b_plane, int ld, int c0, int hc,
                                          int nkg = NK / 16) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    if (kk >= nkg) break;
    uint32_t xa[MID][4];
    acc_to_a<MID>(x[2 * kk], x[2 * kk + 1], xa);
#pragma unroll
    for (int nn = 0; nn < HC / 16; ++nn) {
      if (nn * 16 >= hc) break;
      uint32_t bfr[IN][4];
#pragma unroll
      for (int i = 0; i < IN; ++i) {
        ldsm_x4<true>(bfr[i], b + i * b_plane, ld, kk * 16, c0 + nn * 16);
      }
      mma_planes2<MID, IN>(acc[2 * nn], acc[2 * nn + 1], xa, bfr);
    }
  }
}

// Max and sum over the four threads that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores one accumulator tile's values c (rows row0 and row0 + 8 of `dst`,
// pitch `pitch`, columns col and col + 1), rounded once; rows at or past n
// and columns at or past H are skipped.
template <typename T>
__device__ __forceinline__ void store_acc(T* dst, long long pitch, int row0, int n, int col, int H,
                                          const float c[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= n || col >= H) continue;
    T* p = dst + r * pitch + col;
    if (col + 1 < H) {
      if constexpr (std::is_same<T, bf16>::value) {
        if ((reinterpret_cast<uintptr_t>(p) & 3) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(c[2 * h], c[2 * h + 1]);
          continue;
        }
      } else {
        if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
          *reinterpret_cast<float2*>(p) = make_float2(c[2 * h], c[2 * h + 1]);
          continue;
        }
      }
      p[1] = from_f32<T>(c[2 * h + 1]);
    }
    p[0] = from_f32<T>(c[2 * h]);
  }
}

}  // namespace vtt_mma
