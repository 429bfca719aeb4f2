// Shared pieces of the CaiT talking-head attention kernels (talking_head.cu,
// talking_head_bwd.cu): the row-tile layout, the shared-memory budget that
// picks it, and the per-phase device functions both directions run.
//
// A block owns BQ query rows of one image for ALL heads, because the two
// (H, H) head mixes join the heads at each (t, s). Its score buffer holds
// the block's rows of every head, buf[h][t][s] in f32 with a row pitch SP =
// S rounded up to 4 (float4 reads); entries s ≥ S are kept at 0. Every
// phase is plain f32 arithmetic on the CUDA cores, the values the TPU kernel
// holds in f32 (vision_toolbox_tpu/ops/cait_attention.py `_fwd_core`,
// `_mix`, `_bwd_kernel`), with f32 sums taken in another order.
//
// Head widths: the wrapper zero-pads a head to a multiple of 16 (zero columns
// add nothing to q·kᵀ and give zero output columns, which it drops). The
// logits q·kᵀ are summed over chunks of CH columns of the head (`head_chunk`:
// 64 or 48 where they divide it, else 16; CaiT's 48-wide heads are one
// chunk), the block's q (or dout) rows staged one chunk at a time, so no
// thread keeps more than 64 key values in registers; the chunks of one logit
// are summed in order into the score buffer. Three chunk widths are compiled,
// not one a width: each is a set of row-pass kernels, and the build time
// grows with them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vtt_th {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;          // threads of a row-tile block (eight warps)
constexpr int MAX_SEQ = 512;     // T and S, as the JAX gate
constexpr int MAX_HEADS = 16;
constexpr int ROWS_PER_PASS = 4;  // independent accumulators per thread in the products
constexpr int CHUNKS[3] = {64, 48, 16};  // the compiled logit-chunk widths
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kHalfSmem = 113 * 1024;  // two blocks on one SM

__host__ __device__ inline int pad4(int s) { return (s + 3) / 4 * 4; }

// Columns of a logit chunk for a (padded) head width hd, a multiple of 16: the
// widest of CHUNKS that divides it.
inline int head_chunk(int hd) {
  for (int ch : CHUNKS)
    if (hd % ch == 0) return ch;
  return 0;
}

// Shared memory of a row-tile block: `planes` score buffers of H·BQ·SP f32,
// one row tile of BQ·H·CH f32 (a chunk of q, or of dout in the backward) and
// the mix parameters (2H² + 2H f32). The forward keeps one plane; the backward
// three (raw logits, probabilities, the gradient being worked on).
// ops/cait_attention.py `_smem_bytes` mirrors this.
inline size_t row_tile_smem(bool bwd, int bq, int S, int H, int ch) {
  const size_t planes = bwd ? 3 : 1;
  return (planes * H * bq * pad4(S) + static_cast<size_t>(bq) * H * ch + 2 * H * H + 2 * H) * 4;
}

// Query rows per block: the largest of 16, 8, 4, 2, 1 that lets two blocks
// share an SM, else the largest that fits one; 0 when none does.
inline int rows_per_block(bool bwd, int S, int H, int ch) {
  const size_t budgets[2] = {kHalfSmem, kMaxSmem};
  const int rows[5] = {16, 8, 4, 2, 1};
  for (size_t budget : budgets)
    for (int bq : rows)
      if (row_tile_smem(bwd, bq, S, H, ch) <= budget) return bq;
  return 0;
}

__device__ __forceinline__ float ld(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, size_t i, float v, int is_bf16) {
  if (is_bf16) {
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// HD consecutive elements at p + i (16-byte aligned) as f32 registers.
template <int HD>
__device__ __forceinline__ void ld_row(const void* p, size_t i, int is_bf16, float (&r)[HD]) {
  if (is_bf16) {
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + i);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const uint4 u = src[j];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        r[8 * j + 2 * e] = f.x;
        r[8 * j + 2 * e + 1] = f.y;
      }
    }
  } else {
    const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) {
      const float4 f = src[j];
      r[4 * j] = f.x;
      r[4 * j + 1] = f.y;
      r[4 * j + 2] = f.z;
      r[4 * j + 3] = f.w;
    }
  }
}

// dst[t][h·CH + c] = alpha · x[t0 + t][h·HD + c0 + c] in f32 for the block's
// BQ rows of one image (x at element offset `base`, row length D = H·HD) and
// columns c0 ≤ c0 + c < c0 + CH of every head, 0 past row T.
__device__ __forceinline__ void load_chunk(const void* x, int is_bf16, size_t base, int t0,
                                           int T, int D, int HD, int c0, int CH, int H, int BQ,
                                           float alpha, float* dst) {
  const int W = H * CH;
  for (int i = threadIdx.x; i < BQ * W; i += blockDim.x) {
    const int t = i / W, c = i % W, col = (c / CH) * HD + c0 + c % CH;
    dst[i] = t0 + t < T ? ld(x, base + static_cast<size_t>(t0 + t) * D + col, is_bf16) * alpha
                        : 0.0f;
  }
}

// buf[h][t][s] (+)= Σ_{c < CH} a[t][h·CH + c] · x[s][h·HD + c0 + c] for s < S
// (0 for S ≤ s < SP), adding to the earlier chunks' sum when c0 > 0: the
// per-head logits q·kᵀ (a = a chunk of q·scale) and, in the backward, dmixw
// = dout·vᵀ. One thread per (head, key) keeps the chunk of its key row in
// registers and runs RPP query rows at a time (`row_dots` picks four, or one
// for row tiles of one or two rows).
template <int CH, int RPP>
__device__ __forceinline__ void row_dots_by(const float* a, const void* x, int is_bf16,
                                            size_t base, int S, int SP, int D, int HD, int c0,
                                            int H, int BQ, float* buf) {
  const int W = H * CH;
  for (int pair = threadIdx.x; pair < H * SP; pair += NT) {
    const int h = pair / SP, s = pair % SP;
    float* out = buf + static_cast<size_t>(h) * BQ * SP + s;
    if (s >= S) {
      for (int t = 0; t < BQ; ++t) out[t * SP] = 0.0f;
      continue;
    }
    float kr[CH];
    ld_row<CH>(x, base + static_cast<size_t>(s) * D + h * HD + c0, is_bf16, kr);
    for (int t = 0; t < BQ; t += RPP) {
      float acc[RPP];
#pragma unroll
      for (int r = 0; r < RPP; ++r) acc[r] = c0 > 0 ? out[(t + r) * SP] : 0.0f;
#pragma unroll
      for (int j = 0; j < CH / 4; ++j) {
#pragma unroll
        for (int r = 0; r < RPP; ++r) {
          const float4 f = reinterpret_cast<const float4*>(a + (t + r) * W + h * CH)[j];
          acc[r] = fmaf(f.x, kr[4 * j], acc[r]);
          acc[r] = fmaf(f.y, kr[4 * j + 1], acc[r]);
          acc[r] = fmaf(f.z, kr[4 * j + 2], acc[r]);
          acc[r] = fmaf(f.w, kr[4 * j + 3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPP; ++r) out[(t + r) * SP] = acc[r];
    }
  }
}

template <int CH>
__device__ __forceinline__ void row_dots(const float* a, const void* x, int is_bf16, size_t base,
                                         int S, int SP, int D, int HD, int c0, int H, int BQ,
                                         float* buf) {
  if (BQ >= ROWS_PER_PASS) {
    row_dots_by<CH, ROWS_PER_PASS>(a, x, is_bf16, base, S, SP, D, HD, c0, H, BQ, buf);
  } else {
    row_dots_by<CH, 1>(a, x, is_bf16, base, S, SP, D, HD, c0, H, BQ, buf);
  }
}

// The block's logits of one kind over all chunks of the head: buf = a·xᵀ per
// head, with the a rows (x's partner: q·scale or dout) staged a chunk at a
// time in `tile`. Starts and ends synchronised.
template <int CH>
__device__ __forceinline__ void chunked_dots(const void* a, float alpha, const void* x,
                                             int is_bf16, size_t rows_base, size_t keys_base,
                                             int t0, int T, int S, int SP, int D, int HD, int H,
                                             int BQ, float* tile, float* buf) {
  for (int c0 = 0; c0 < HD; c0 += CH) {
    load_chunk(a, is_bf16, rows_base, t0, T, D, HD, c0, CH, H, BQ, alpha, tile);
    __syncthreads();
    row_dots<CH>(tile, x, is_bf16, keys_base, S, SP, D, HD, c0, H, BQ, buf);
    __syncthreads();
  }
}

// The head mix at every position p = t·SP + s of the block:
//   !TRANS: m[g] = bias[g] + Σ_h w[g][h]·src[h]   (the forward mixes),
//    TRANS: m[h] = Σ_g w[g][h]·src[g]             (their input gradients),
// written to dst (may be src: each position is read whole before it is
// written) and, where gdst is given, to device memory at
// gdst[g][t][s] (plane stride T·S, rows past `t_valid` left out). Entries
// s ≥ S are written as 0. MH ≥ H is the register width.
template <int MH, bool TRANS>
__device__ __forceinline__ void mix_heads(const float* src, float* dst, const float* w,
                                          const float* bias, int H, int BQ, int S, int SP,
                                          float* gdst, int t_valid, int T) {
  const int plane = BQ * SP;
  for (int p = threadIdx.x; p < plane; p += NT) {
    const int t = p / SP, s = p % SP;
    const bool live = s < S;
    float r[MH];
#pragma unroll
    for (int h = 0; h < MH; ++h) r[h] = h < H ? src[h * plane + p] : 0.0f;
#pragma unroll
    for (int g = 0; g < MH; ++g) {
      if (g < H) {
        float acc = bias != nullptr ? bias[g] : 0.0f;
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          if (h < H) acc = fmaf(TRANS ? w[h * H + g] : w[g * H + h], r[h], acc);
        }
        if (dst != nullptr) dst[g * plane + p] = live ? acc : 0.0f;
        if (gdst != nullptr && live && t < t_valid) {
          gdst[(static_cast<size_t>(g) * T + t) * S + s] = acc;
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Softmax over the S valid keys of each of the `rows` rows (pitch SP), in
// place, one warp per row: max subtracted, e / Σe.
__device__ __forceinline__ void softmax_rows(float* buf, int rows, int S, int SP) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += NT / 32) {
    float* row = buf + static_cast<size_t>(r) * SP;
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(row[s] - mx);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) row[s] = row[s] / sum;
  }
}

// out[t0 + t][c] = alpha · Σ_s buf[c / HD][t][s] · x[s][c] for the block's
// rows below T, in x's type: o = pw·v (alpha 1) and dq = draw·k·scale.
// Work items are (column, RPP query rows: `scores_times_rows` picks four, or
// one for row tiles of one or two rows); x is read along a column, so a warp
// reads consecutive addresses.
template <int RPP>
__device__ __forceinline__ void scores_times_rows_by(const float* buf, const void* x,
                                                     int is_bf16, size_t xbase, void* out,
                                                     size_t obase, int t0, int T, int S, int SP,
                                                     int D, int HD, int BQ, float alpha) {
  const int plane = BQ * SP;
  const int items = D * (BQ / RPP);
  for (int item = threadIdx.x; item < items; item += NT) {
    const int c = item % D, tr = item / D * RPP;
    const float* p = buf + (c / HD) * plane + tr * SP;
    float acc[RPP] = {};
    for (int s = 0; s < S; s += 4) {
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xv[j] = s + j < S ? ld(x, xbase + static_cast<size_t>(s + j) * D + c, is_bf16) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RPP; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(p + r * SP + s);
        acc[r] = fmaf(pv.x, xv[0], acc[r]);
        acc[r] = fmaf(pv.y, xv[1], acc[r]);
        acc[r] = fmaf(pv.z, xv[2], acc[r]);
        acc[r] = fmaf(pv.w, xv[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPP; ++r) {
      const int t = t0 + tr + r;
      if (t < T) st(out, obase + static_cast<size_t>(t) * D + c, acc[r] * alpha, is_bf16);
    }
  }
}

__device__ __forceinline__ void scores_times_rows(const float* buf, const void* x, int is_bf16,
                                                  size_t xbase, void* out, size_t obase, int t0,
                                                  int T, int S, int SP, int D, int HD, int BQ,
                                                  float alpha) {
  if (BQ >= ROWS_PER_PASS) {
    scores_times_rows_by<ROWS_PER_PASS>(buf, x, is_bf16, xbase, out, obase, t0, T, S, SP, D, HD,
                                        BQ, alpha);
  } else {
    scores_times_rows_by<1>(buf, x, is_bf16, xbase, out, obase, t0, T, S, SP, D, HD, BQ, alpha);
  }
}

}  // namespace vtt_th
