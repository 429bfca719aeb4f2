// Shared pieces of Swin's window-attention kernels (K7): swin_attention.cu (the
// forward) and swin_attention_bwd.cu (the backward and the dPE sum).
//
// Operands are the projections' packed layout, q/k/v (B, nW, T, N·hd), T = S = w²
// tokens a window. Every kernel's block owns one head h, one window index w and a
// run of `per_block` consecutive images (ops/swin_attention.py
// `windows_per_block`): it takes window w of those images one at a time, so its
// head's bias pe[h] and, on shifted blocks, the mask mask[w] are the same for the
// whole run. Two families of kernels:
//
// The register-tile kernels (bf16 windows of up to 208 tokens whose tiles fit
// shared memory: every window up to 64 tokens, and window 14 at head 32; heads
// padded to 16 columns)
// run on attention_mma.cuh's tiles, as the short-attention kernels (K2) do: each
// warp owns 16 rows (query rows, or keys in the backward's keys pass) of the
// window-head, so a window pads to 16 rows (49 → 64, 196 → 208) and its products
// stop at the 16-key group past T; the scores sit in mma.sync accumulators and the
// softmax runs in registers; p (and ds) go to the next product as two bf16 planes,
// never rounded to bf16 once. The window-head's q, k, v (and g) tiles go through
// a cp.async ring over the block's images (two stages in the forward, one in the
// backward), one barrier a window-head. Blocks are numbered head-fastest
// (`BlockJob`), so the N blocks of a window read its packed rows together. Windows
// of up to 64 tokens (`Small`) take all keys in one tile, the block stages pe[h]
// and mask[w] in shared memory once, in their own types (`Table`), and the
// backward exchanges p's and ds's planes through shared memory once a
// window-head; larger windows (window 14, T = 196) sweep key tiles with K2's
// running softmax (its rows and keys passes in the backward) and read the tables
// from device memory, which the caches hold for the block's run.
//
// The CUDA-core kernels (f32 operands) stage the window-head's (T, hd) operands in
// shared memory in their own type (when they fit: row pitches odd in 32-bit words,
// so 32 lanes reading 32 rows hit 32 banks; else the same code reads them from
// device memory) and give each query row (and, in the backward, each key) to one
// warp: row t always to warp t mod 8. The warp copies its q·scale row to its own
// row of shared memory, and lane j sums the logits of keys j + 32i (T ≤ 256: at
// most 8 each) over the head, reading that row as a broadcast; the scores stay in
// registers and the softmax runs there. For the products with v (and k, q, g in the
// backward) the probabilities go to another row of the warp's, read back as a
// broadcast while lane j sums head columns j + 32i: the TPU kernels' f32 arithmetic
// (vision_toolbox_tpu/ops/swin_attention.py `_fwd_kernel`, `_bwd_kernel`) in their
// order: the logits (q·scale)·kᵀ summed over the head in order, then + pe, then +
// mask, each an f32 add; p = e / Σe with e = exp(logit − max).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "attention_mma.cuh"

namespace vtt_swin {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // eight warps
constexpr int NW = NT / 32;
constexpr int MAX_SEQ = 256;  // T = S = w², the JAX package's MAX_WINDOW_SEQ
constexpr int MAX_HEAD = 128;
constexpr int SLOTS = MAX_SEQ / 32;   // keys (or query rows) a lane holds
constexpr int DSLOTS = MAX_HEAD / 32;  // head columns a lane holds
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float ld(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row pitch, in elements, of a staged (T, hd) operand: an odd number of 32-bit words.
template <typename T>
__host__ __device__ inline int stage_pitch(int hd) {
  if (sizeof(T) == 4) return hd % 2 ? hd : hd + 1;
  const int words = (hd + 1) / 2;
  return 2 * (words % 2 ? words : words + 1);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// Floats of one warp's scratch rows: `seq` rows of T (a row of probabilities or
// score gradients) and `head` rows of hd (a query, key, value or cotangent row).
__host__ __device__ inline int warp_row_floats(int seq, int head, int T_, int hd) {
  return seq * pad4(T_) + head * pad4(hd);
}

// Bytes of every warp's scratch rows.
__host__ __device__ inline size_t warp_rows_bytes(int seq, int head, int T_, int hd) {
  return static_cast<size_t>(NW) * warp_row_floats(seq, head, T_, hd) * sizeof(float);
}

// Bytes of `n_ops` staged (T, hd) operands.
template <typename T>
__host__ __device__ inline size_t staged_bytes(int n_ops, int T_, int hd) {
  return n_ops * align16(static_cast<size_t>(T_) * stage_pitch<T>(hd) * sizeof(T));
}

// One window-head operand: element (t, d) at p[t·pitch + d], in shared or device memory.
template <typename T>
struct View {
  const T* p;
  int pitch;
  __device__ __forceinline__ const T* row(int t) const { return p + static_cast<size_t>(t) * pitch; }
  __device__ __forceinline__ float operator()(int t, int d) const { return to_f32(row(t)[d]); }
};

// Copy the window-head's (T, hd) rows of a packed operand (row stride D) to `dst`,
// a warp a row.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int T_, int D, int hd, T* dst,
                                      int pitch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < T_; t += NW) {
    const T* s = src + static_cast<size_t>(t) * D;
    T* d = dst + t * pitch;
    for (int c = lane; c < hd; c += 32) d[c] = s[c];
  }
}

// The warp's row `dst` ← x[t][:]·xs in f32 (q·scale, or a key, value or cotangent row).
template <typename T>
__device__ __forceinline__ void head_row(const View<T>& x, int t, int hd, float xs, float* dst) {
  const int lane = threadIdx.x & 31;
  const T* r = x.row(t);
  __syncwarp();  // the warp's last products are done with the row
  for (int d = lane; d < hd; d += 32) dst[d] = to_f32(r[d]) * xs;
  __syncwarp();
}

// acc[i] = Σ_d (x[u][d]·xs)·a[d], d in order, for u = lane + 32i < n (0 elsewhere): one
// row `a` (in the warp's shared row) against n rows of x, lane j the rows j + 32i. With
// a = q·scale and x = k (xs = 1) these are a query row's logits; with a = k and x = q
// (xs = scale) a key's column of them, the same f32 values (an FMA's two factors
// commute, x·1 is x); likewise dp = g·vᵀ by rows and by columns.
template <typename T>
__device__ __forceinline__ void dots(const float* a, const View<T>& x, int n, int hd, float xs,
                                     float (&acc)[SLOTS]) {
  const int lane = threadIdx.x & 31;
  const T* rows[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    acc[i] = 0.0f;
    rows[i] = x.row(min(lane + 32 * i, n - 1));  // past n: a valid row, the sum dropped
  }
  for (int d = 0; d < hd; ++d) {
    const float ad = a[d];
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      if (32 * i < n) acc[i] = fmaf(to_f32(rows[i][d]) * xs, ad, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (lane + 32 * i >= n) acc[i] = 0.0f;
  }
}

// logit += pe[at] (+ mask[at]): the bias, added to the f32 product in this order.
__device__ __forceinline__ float add_bias(float logit, const void* pe, int pe_bf16,
                                          const void* mask, int mask_bf16, size_t pe_at,
                                          size_t mask_at) {
  logit += ld(pe, pe_at, pe_bf16);
  if (mask != nullptr) logit += ld(mask, mask_at, mask_bf16);
  return logit;
}

// Query row t's probabilities from its logits in p (lane j holding keys j + 32i),
// in place, 0 at s ≥ S: e = exp(logit − max), p = e / Σe; m and l return the
// row's max and Σe.
__device__ __forceinline__ void softmax_row(float (&p)[SLOTS], int S, float& m, float& l) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (lane + 32 * i < S) mx = fmaxf(mx, p[i]);
  }
  mx = warp_max(mx);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    p[i] = lane + 32 * i < S ? expf(p[i] - mx) : 0.0f;
    sum += p[i];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) p[i] = p[i] / sum;
  m = mx;
  l = sum;
}

// Query row t's logits ((q·scale)·kᵀ + pe + mask) into p, `qrow` holding q·scale.
template <typename T>
__device__ __forceinline__ void logits_row(const float* qrow, const View<T>& k, int t, int S,
                                           int hd, const void* pe, int pe_bf16, size_t pe_base,
                                           const void* mask, int mask_bf16, size_t mask_base,
                                           float (&p)[SLOTS]) {
  const int lane = threadIdx.x & 31;
  dots(qrow, k, S, hd, 1.0f, p);
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const size_t at = static_cast<size_t>(t) * S + lane + 32 * i;
    if (lane + 32 * i < S) p[i] = add_bias(p[i], pe, pe_bf16, mask, mask_bf16, pe_base + at,
                                           mask_base + at);
  }
}

// Lane u mod 32's values w[u / 32], u < n, into the warp's row `row` of shared
// memory, for a product that reads them all.
__device__ __forceinline__ void put_row(const float (&w)[SLOTS], int n, float* row) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the warp's last product is done with the row
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (lane + 32 * i < n) row[lane + 32 * i] = w[i];
  }
  __syncwarp();
}

// acc[j] += Σ_u row[u] · (x[u][lane + 32j]·xs) over u < n in order: a row of
// probabilities or score gradients (put_row) times a window-head operand.
template <typename T>
__device__ __forceinline__ void weighted_rows(const float* row, const View<T>& x, int n, int hd,
                                              float xs, float (&acc)[DSLOTS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int u = 0; u < n; ++u) {
    const float wu = row[u];
    const T* r = x.row(u);
#pragma unroll
    for (int j = 0; j < DSLOTS; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) acc[j] = fmaf(wu, to_f32(r[d]) * xs, acc[j]);
    }
  }
}

// ---- the register-tile kernels (bf16) ----------------------------------------

constexpr int SMALL_SEQ = 64;   // windows that take all keys in one tile and stage the tables
constexpr int LARGE_SEQ = 208;  // the largest window on the register tiles: 13 warps a block
constexpr int BK = 64;          // keys a tile of Small windows (all of them)
constexpr int TAB_PITCH = 72;  // staged table row pitch in elements (below)
// The cp.async ring's stages over the block's window-heads: two in the forward;
// one in the backward, whose shared memory then takes three blocks an SM (two
// stages: two blocks, 23% slower at swin_t stage 1, scripts/ab_swin_attention.py)
constexpr int FWD_STAGES = 2, BWD_STAGES = 1;

// Threads of a register-tile block: a warp for each 16 rows of the window (Small
// windows: at most 4, Large ones at most 13).
template <bool SMALL>
__host__ __device__ constexpr int rt_threads() {
  return SMALL ? SMALL_SEQ / 16 * 32 : LARGE_SEQ / 16 * 32;
}

// The fewest blocks an SM that __launch_bounds__ promises, per kernel: the
// Small forward five 128-thread blocks (102 registers a thread; four ran 12%
// slower at swin_t stage 1), the Small backward three (170 registers; two
// blocks without spills ran 10% slower), head 128 what it needs; Large
// kernels at head 32 two 416-thread blocks (78 registers, with the forward's
// 32-key and the backward's 16-row tiles; one block ran 26% slower forward
// and 18% slower forward + backward at window 14), wider heads one.
template <bool SMALL, int HD, bool BWD>
__host__ __device__ constexpr int rt_min_blocks() {
  return !SMALL ? (HD <= 32 ? 2 : 1) : HD > 64 ? 2 : BWD ? 3 : 5;
}

// pe[h] or mask[w] (T × T, f32 or bf16), read at (row, column) pairs of an
// accumulator tile. Staged (`Small` windows): rows of TAB_PITCH elements in
// shared memory, zero past T, so the pair (c, c + 1) (c even) is one aligned
// 4- or 8-byte read, and the eight rows × four pairs a warp reads fall in 32
// distinct banks (pitch/2 ≡ 4 mod 32 words for bf16, 64-bit reads of a pitch ≡ 8
// mod 32 for f32). Not staged: device memory, pitch T, one element at a time.
struct Table {
  const void* p;
  int bf16_, pitch;

  __device__ __forceinline__ float at(int r, int c) const {
    const size_t i = static_cast<size_t>(r) * pitch + c;
    return bf16_ ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
  }
  // elements (r, c) and (r, c + 1) of a staged table (c even)
  __device__ __forceinline__ float2 pair(int r, int c) const {
    const size_t i = static_cast<size_t>(r) * pitch + c;
    if (bf16_) {
      return __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p) + i));
    }
    return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
  }
};

// Copies the T × T table at src (its own type) to `dst` with rows of TAB_PITCH,
// zero at columns ≥ T; returns the staged Table.
__device__ __forceinline__ Table stage_table(const void* src, int is_bf16, int T_, void* dst) {
  for (int e = threadIdx.x; e < T_ * TAB_PITCH; e += blockDim.x) {
    const int r = e / TAB_PITCH, c = e % TAB_PITCH;
    const float x = c < T_ ? ld(src, static_cast<size_t>(r) * T_ + c, is_bf16) : 0.0f;
    if (is_bf16) {
      static_cast<bf16*>(dst)[e] = __float2bfloat16(x);  // exact: x is a bf16 value
    } else {
      static_cast<float*>(dst)[e] = x;
    }
  }
  return Table{dst, is_bf16, TAB_PITCH};
}

// 16-wide groups of the key (or query) tile from c0 that reach a token < T: the
// products stop at the next multiple of 16 past T.
__device__ __forceinline__ int groups16(int c0, int tile, int T_) {
  return min(tile, T_ - c0 + 15) / 16;
}

// The logits of a warp's 16 query rows (this thread's rows row0 and row0 + 8)
// against the key tile from c0, in place of s = q·kᵀ: s·scale + pe + mask, each an
// f32 add in this order; −1e30 at keys ≥ T. Rows ≥ T (zero q rows) keep s·scale.
template <bool SMALL, int NJ>
__device__ __forceinline__ void logits(float (&s)[NJ][4], int c0, int row0, int T_, float scale,
                                       const Table& pe, const Table& mask, bool masked) {
  const int t = vtt_mma::lane_t();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = c0 + j * 8 + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      float2 b = make_float2(0.0f, 0.0f), mk = make_float2(0.0f, 0.0f);
      if (r < T_) {
        if constexpr (SMALL) {  // staged: columns up to TAB_PITCH hold zeros past T
          b = pe.pair(r, c);
          if (masked) mk = mask.pair(r, c);
        } else {
          if (c < T_) b.x = pe.at(r, c);
          if (c + 1 < T_) b.y = pe.at(r, c + 1);
          if (masked && c < T_) mk.x = mask.at(r, c);
          if (masked && c + 1 < T_) mk.y = mask.at(r, c + 1);
        }
      }
      float* x = s[j] + 2 * hh;
      x[0] = c < T_ ? (x[0] * scale + b.x) + mk.x : vtt_mma::kNegInf;
      x[1] = c + 1 < T_ ? (x[1] * scale + b.y) + mk.y : vtt_mma::kNegInf;
    }
  }
}

// The same logits transposed, for the backward's keys pass: a warp's 16 key rows
// (this thread's keys row0 and row0 + 8) against the query tile from c0, in place
// of sᵀ = k·qᵀ; pe and mask read at (query, key). Queries ≥ T are left as they
// are (their statistics make p zero there), and so are keys ≥ T (zero k rows,
// whose gradients are not stored).
template <int NJ>
__device__ __forceinline__ void logits_t(float (&s)[NJ][4], int c0, int row0, int T_, float scale,
                                         const Table& pe, const Table& mask, bool masked) {
  const int t = vtt_mma::lane_t();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = c0 + j * 8 + 2 * t + (e & 1), kr = row0 + 8 * (e >> 1);
      float x = s[j][e] * scale;
      if (qc < T_ && kr < T_) {
        x += pe.at(qc, kr);
        if (masked) x += mask.at(qc, kr);
      }
      s[j][e] = x;
    }
  }
}

// Query rows of the backward's statistics: T rounded up to 64, so that every
// query tile of the keys pass reads within them.
__host__ __device__ inline int stat_rows(int T_) { return (T_ + 63) / 64 * 64; }

// The Small backward's exchange: p and ds of the window-head as [query][key]
// bf16 planes (hi, lo: 2⁻¹⁶ of the value, never rounded to bf16 once) with a
// pitch of XP elements, (XP / 8) odd, so the rows ldmatrix reads fall in distinct
// banks and the rows pass's bf16x2 stores in 32.
constexpr int XP = SMALL_SEQ + 8;

// The A fragment of the 16 × 16 tile xᵀ at (key0, q0) from a [query][key] plane
// x: ldmatrix .trans of its four 8 × 8 blocks.
__device__ __forceinline__ void ldsm_a_trans(uint32_t r[4], const bf16* x, int q0, int key0) {
  const int l = threadIdx.x & 31;
  const bf16* p = x + (q0 + (l & 7) + (l >> 4) * 8) * XP + key0 + ((l >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(vtt_mma::smem_addr(p)));
}

// acc (the warp's 16 keys from key0 × the head) += xᵀ·b over the window's first
// nqg 16-query groups: x two [query][key] planes (stride `plane`), b the
// [query][h] tile (pitch ldb) at columns up to hc.
template <int HD>
__device__ __forceinline__ void exchange_step(float (*acc)[4], const bf16* x, int plane, int key0,
                                              const bf16* b, int ldb, int hc, int nqg) {
#pragma unroll
  for (int kk = 0; kk < SMALL_SEQ / 16; ++kk) {
    if (kk >= nqg) break;
    uint32_t a[2][4];
    ldsm_a_trans(a[0], x, kk * 16, key0);
    ldsm_a_trans(a[1], x + plane, kk * 16, key0);
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      if (nn * 16 >= hc) break;
      uint32_t bfr[1][4];
      vtt_mma::ldsm_x4<true>(bfr[0], b, ldb, kk * 16, nn * 16);
      vtt_mma::mma_planes2<2, 1>(acc[2 * nn], acc[2 * nn + 1], a, bfr);
    }
  }
}

// Byte offsets of a register-tile kernel's shared memory: per ring stage the
// window-head's tiles (q, k, v; and g in the backward: tp = T rounded up to 16
// rows, pitch Hp + 8 bf16);
// then, for Small windows, the staged pe and mask tables (T rows each); then in
// the backward, for Small windows the exchange (p's and ds's planes, tp rows of
// XP each), for Large ones the rows' statistics (lse·log2 e and delta,
// `stat_rows` each).
struct RtSmem {
  int tp, ldh;
  size_t tile, ring, pe, mask, extra, total;
  __host__ __device__ RtSmem(int T_, int Hp, bool small, int pe_bf16, bool masked, int mask_bf16,
                             bool bwd) {
    tp = (T_ + 15) / 16 * 16;
    ldh = Hp + 8;
    tile = vtt_mma::align128(static_cast<size_t>(tp) * ldh * 2);
    ring = bwd ? BWD_STAGES * 4 * tile : FWD_STAGES * 3 * tile;
    const size_t rows = static_cast<size_t>(T_) * TAB_PITCH;
    pe = ring;
    mask = pe + (small ? vtt_mma::align128(rows * (pe_bf16 ? 2 : 4)) : 0);
    extra = mask + (small && masked ? vtt_mma::align128(rows * (mask_bf16 ? 2 : 4)) : 0);
    const size_t x = small ? static_cast<size_t>(4) * tp * XP * 2
                           : static_cast<size_t>(2) * stat_rows(T_) * 4;
    total = extra + (bwd ? vtt_mma::align128(x) : 0);
  }
};

// The kernels a call runs (the launchers' one rule; ops/swin_attention.py sizes
// the grid by it): ROUTE_CORES the CUDA-core kernels (f32, or a bf16 window whose
// tiles overflow shared memory), ROUTE_SMALL / ROUTE_LARGE the register tiles for
// windows of at most SMALL_SEQ / LARGE_SEQ tokens.
enum Route { ROUTE_CORES = 0, ROUTE_SMALL = 1, ROUTE_LARGE = 2 };

inline Route swin_route(int T_, int hd, int is_bf16, int pe_bf16, bool masked, int mask_bf16,
                        bool bwd) {
  const RtSmem L(T_, vtt_mma::round_up(hd, 16), T_ <= SMALL_SEQ, pe_bf16, masked, mask_bf16, bwd);
  if (!is_bf16 || T_ > LARGE_SEQ || L.total > kMaxSmem) return ROUTE_CORES;
  return T_ <= SMALL_SEQ ? ROUTE_SMALL : ROUTE_LARGE;
}

// The window-head (b, w, h) of a packed (B, nW, T, N·hd) operand.
__device__ __forceinline__ size_t window_head(int b, int w, int h, int nW, int T_, int D, int hd) {
  return (static_cast<size_t>(b) * nW + w) * T_ * D + static_cast<size_t>(h) * hd;
}

// The (head, window index, run) of a register-tile block: blocks are numbered
// (w·runs + run)·N + h, so the N blocks of a window and run are dispatched
// together and read whole packed rows between them.
struct BlockJob {
  int h, w, run;
  __device__ __forceinline__ BlockJob(int N, int runs) {
    const int rest = blockIdx.x / N;
    h = blockIdx.x % N;
    w = rest / runs;
    run = rest % runs;
  }
};

// Launches a register-tile kernel on nW·runs·N blocks of `warps` warps.
template <typename Kernel, typename... Args>
cudaError_t rt_launch(Kernel kernel, int blocks, int N, int warps, size_t smem, cudaStream_t st,
                      Args... args) {
  if (smem > kMaxSmem || static_cast<long long>(blocks) * N > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks * N, warps * 32, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace vtt_swin
