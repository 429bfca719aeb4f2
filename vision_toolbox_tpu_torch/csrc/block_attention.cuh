// The attention core of the fused half-block (K4) on Hopper's register
// tiles: block_attention.cu's forward (attn_kernel) and block_attention_bwd.cu's
// rows pass (attn_bwd_rows_kernel) and keys pass (attn_bwd_keys_kernel).
//
// What it computes, per image and head of the bf16 (B, T, D) q, k, v (head
// h: columns h·hd … h·hd + hd − 1), at the TPU kernel's rounding points
// (vision_toolbox_tpu/ops/block_attention.py `_attn_fwd_heads` and the
// attention part of `_bwd_kernel`):
//   logits = (q·kᵀ in f32)·scale, e = exp(logits − the row max),
//   p = bf16(e / Σe), max and Σe over the whole row; o = bf16(Σ p·v);
//   (e is formed as 2^((logit − max)·log2 e) on the special-function unit and
//   p as e·(1/Σe): each an f32 rounding from expf and a true division, which
//   left the bf16 rel L2 to the plain versions unchanged to three digits and
//   the forward 1.3× faster in an A/B on an H100)
//   dp = do·vᵀ, δ = Σ dp·p over the whole row, ds = bf16(p·(dp − δ)),
//   dq = (ds·k)·scale, dk = dsᵀ·bf16(q·scale), dv = pᵀ·do; f32 sums.
// Every operand of every product is bf16 at those points, so each product
// is one plane of mma.sync m16n8k16 tiles (attention_mma.cuh), exact in f32.
//
// Design. A warp owns 16 rows: queries in the forward and the rows pass,
// keys in the keys pass. The softmax and δ need whole rows; a warp holds at
// most KG 16-key groups of a row tile in registers (8 at heads ≤ 64: 64 f32
// a lane; 4 at heads ≤ 128), so a row tile is split over `splits` warps,
// each holding an equal run of groups (T = 197: two warps of 7 and 6
// groups), which trade their rows' partial max, Σe or δ through shared
// memory and combine them in a fixed order. No f32 score block passes
// through shared memory and no row is swept twice, at every T ≤ 512.
//  - forward: a block is `rows` row tiles × `splits` warps (≤ 8) of one
//    (image, head) with that head's K and V whole in shared memory
//    (cp.async; V's copy overlaps q·kᵀ, or follows K into its buffer where
//    the two do not fit side by side). s = q·kᵀ into registers; the max and
//    then Σe traded; p = e / Σe packed in registers as bf16 A fragments; in
//    the save variant p goes out through a per-warp staging tile with
//    16-byte stores; o += p·v; split 0's warp adds the other splits' f32 o
//    tiles in a fixed order, rounds once and writes through staging with
//    16-byte stores.
//  - rows pass: the forward's blocks, with the rows of do and of p, V and K
//    in shared memory: dp = do·vᵀ into registers, δ traded, ds = bf16(p·(dp
//    − δ)) in registers and out once to device memory for the keys pass
//    (staging, 16-byte stores), dq += ds·k with ds as the A fragment; the
//    splits' dq summed as the forward's o and scaled; dbq's partial row per
//    (image, 16-row tile) from the f32 values by a fixed shuffle tree.
//  - keys pass: blocks of up to 8 warps, each 16 key rows of one (image,
//    head); tiles of 64 queries of p, ds, do and q stream through a
//    two-stage cp.async ring, q·scale is rounded to bf16 in place, pᵀ and
//    dsᵀ come in as A fragments by transposed ldmatrix; dv += pᵀ·do and dk +=
//    dsᵀ·bf16(q·scale); dv and dk out through staging with 16-byte stores,
//    dbv's and dbk's partial rows from the f32 accumulators.
// p and the ds scratch are (B, H, T, Tp), Tp = T rounded up to 8 (16-byte
// rows; the saved p is handed on as its [..., :T] view), columns T … Tp − 1
// zero. Every partial row is summed later in a fixed order (no atomics).
#pragma once

#include <math.h>

#include "attention_mma.cuh"

namespace vtt_k4 {
namespace {  // internal linkage: several builds may be loaded into one process

using namespace vtt_mma;

constexpr int WMAX = 8;        // warps a forward or rows-pass block
// their blocks an SM, at most 128 registers a thread (three, at most 80,
// made the forward 1.3–1.4× slower; 6 warps a block 1.1×, 16 no faster)
constexpr int MIN_BLOCKS = 2;
constexpr int KEY_WARPS = 8;   // warps a keys-pass block
constexpr int KEY_BQ = 64;     // queries a keys-pass tile (32: 3–9% slower)
constexpr int KEY_STAGES = 2;  // the keys pass's ring
constexpr size_t kMaxSmem = 227 * 1024;

// 16-key groups of a row tile a warp holds in registers, by the head width
// the kernel is built for (heads ≤ 64 or ≤ 128). A whole row of 13 groups
// (T = 197) in one warp spilled 0.4–0.9 KB at 128 registers: the save
// forward 1.09× slower, the rows pass 1.6× (A/B on an H100).
template <int HD>
struct Groups;
template <>
struct Groups<64> {
  static constexpr int KG = 8;
};
template <>
struct Groups<128> {
  static constexpr int KG = 4;
};

// Elements a row of p and of the ds scratch: T rounded up to 8.
__host__ __device__ inline int p_pitch(int t) { return (t + 7) / 8 * 8; }

// How the row tiles of one (image, head) are laid out for the forward and
// the rows pass.
struct Geometry {
  int ng;          // 16-row (and 16-key) groups: T rounded up to 16, over 16
  int kgs;         // groups a split holds (the last may hold fewer)
  int splits;      // warps that share a row tile's keys
  int rows;        // row tiles a block
  int row_blocks;  // blocks an (image, head)
};

inline Geometry rows_geometry(int T, int kg) {
  Geometry g;
  g.ng = (T + 15) / 16;
  const int fewest = (g.ng + kg - 1) / kg;
  g.kgs = (g.ng + fewest - 1) / fewest;
  g.splits = (g.ng + g.kgs - 1) / g.kgs;
  const int per = WMAX / g.splits;
  g.row_blocks = (g.ng + per - 1) / per;
  g.rows = (g.ng + g.row_blocks - 1) / g.row_blocks;
  return g;
}

// Byte offsets of a forward or rows-pass block's shared memory: the block's
// q or do rows, the first and second head buffers (K then V in the forward,
// V then K in the rows pass; one buffer where both do not fit), the rows'
// partial statistics (two floats a warp row), and the forward's p staging
// (over the q rows and K where it fits) or the rows pass's p rows. The
// splits' f32 output tiles ([warp][16][hd + 4]) alias it all from 0 once the
// products are done.
struct RowsSmem {
  int ld, pld;  // bf16 pitches of head rows and of p rows, in elements
  size_t first, second, stats, p, total;
  bool apart;
  __host__ __device__ RowsSmem(const Geometry& g, int hd, int kg, bool fwd, bool save) {
    const int warps = g.rows * g.splits, sp = g.ng * 16;
    ld = hd + 8;
    pld = fwd ? kg * 16 + 8 : sp + 8;
    const size_t rows_bytes = align128(static_cast<size_t>(g.rows) * 16 * ld * 2);
    const size_t head_bytes = align128(static_cast<size_t>(sp) * ld * 2);
    const size_t stat_bytes = align128(static_cast<size_t>(2) * warps * 16 * 4);
    const size_t p_bytes = fwd ? (save ? align128(static_cast<size_t>(warps) * 16 * pld * 2) : 0)
                               : align128(static_cast<size_t>(g.rows) * 16 * pld * 2);
    const size_t out_bytes = static_cast<size_t>(warps) * 16 * (hd + 4) * 4;
    const size_t rest = rows_bytes + head_bytes + stat_bytes + p_bytes;
    apart = rest + head_bytes <= kMaxSmem;
    first = rows_bytes;
    second = apart ? first + head_bytes : first;
    stats = second + head_bytes;
    // the forward's staging over the q rows and K, which every warp has
    // left by then, where K and V lie apart and it fits
    const bool alias = fwd && apart && p_bytes <= second;
    p = alias ? 0 : stats + stat_bytes;
    total = stats + stat_bytes + (alias ? 0 : p_bytes);
    if (out_bytes > total) total = out_bytes;
  }
};

// The keys pass: per ring stage a p and a ds tile (KEY_BQ queries × the
// block's keys) and a do and a q tile (KEY_BQ × hd); the per-warp output
// staging aliases the ring once the products are done.
struct KeysSmem {
  int kld, ld;
  size_t ptile, htile, stage, total;
  __host__ __device__ KeysSmem(int warps, int hd) {
    kld = warps * 16 + 8;
    ld = hd + 8;
    ptile = align128(static_cast<size_t>(KEY_BQ) * kld * 2);
    htile = align128(static_cast<size_t>(KEY_BQ) * ld * 2);
    stage = 2 * ptile + 2 * htile;
    total = KEY_STAGES * stage;
  }
};

// The keys pass's blocks: the fewest of at most KEY_WARPS warps (16 keys
// each) that cover T's key groups, and the warps of each.
struct KeyGeometry {
  int blocks, warps;
};

inline KeyGeometry key_geometry(int T) {
  const int ng = (T + 15) / 16;
  const int blocks = (ng + KEY_WARPS - 1) / KEY_WARPS;
  return {blocks, (ng + blocks - 1) / blocks};
}

// The core's shared memory at (T, hd): the largest of its three layouts,
// the save forward's (the inference forward's is no larger), the rows
// pass's and the keys pass's. Both entries refuse a shape by this one term
// against kMaxSmem, and ops/block_attention.py `_core_smem_bytes` mirrors it
// for the gate, so the gate admits what the kernels run. Within hd ≤ 128 and
// T ≤ 512 it stays below kMaxSmem (163,072 bytes at head 128, T = 512).
inline size_t core_smem_bytes(int T, int hd) {
  const int kg = hd <= 64 ? Groups<64>::KG : Groups<128>::KG;
  const Geometry g = rows_geometry(T, kg);
  const size_t fwd = RowsSmem(g, hd, kg, true, true).total;
  const size_t rows = RowsSmem(g, hd, kg, false, false).total;
  const size_t keys = KeysSmem(key_geometry(T).warps, hd).total;
  return fwd > rows ? (fwd > keys ? fwd : keys) : (rows > keys ? rows : keys);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t pack(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The accumulator tile c (rows g and g + 8, columns 2t, 2t + 1) of a warp's
// 16 rows as bf16 pairs into a staging tile of pitch ld at column col.
__device__ __forceinline__ void stage_pair(bf16* tile, int ld, int col, const float c[4]) {
  const int g = lane_g(), t = lane_t();
  *reinterpret_cast<uint32_t*>(tile + g * ld + col + 2 * t) = pack(c[0], c[1]);
  *reinterpret_cast<uint32_t*>(tile + (g + 8) * ld + col + 2 * t) = pack(c[2], c[3]);
}

// The A fragment of the 16 × 16 tile Mᵀ from the row-major [r][c] tile M at
// (r0, c0): rows of the operand are M's columns (ldmatrix, transposed).
__device__ __forceinline__ void ldsm_a_trans(uint32_t a[4], const bf16* tile, int ld, int r0,
                                             int c0) {
  uint32_t x[4];
  ldsm_x4<true>(x, tile, ld, r0, c0);
  a[0] = x[0];
  a[1] = x[2];
  a[2] = x[1];
  a[3] = x[3];
}

// A warp's f32 accumulator tiles (16 rows × hd) into its slot of the
// output tiles [warp][16][hd + 4] at `tiles`.
template <int HD>
__device__ __forceinline__ void put_split(float* tiles, int warp, int hd, float (*acc)[4]) {
  const int ow = hd + 4, g = lane_g(), t = lane_t();
  float* w = tiles + warp * 16 * ow;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (j * 8 >= hd) break;
    *reinterpret_cast<float2*>(w + g * ow + j * 8 + 2 * t) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(w + (g + 8) * ow + j * 8 + 2 * t) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// acc += the f32 tiles of warp `from`'s slot (put_split's layout).
template <int HD>
__device__ __forceinline__ void add_split(float (*acc)[4], const float* tiles, int from, int hd) {
  const int ow = hd + 4, g = lane_g(), t = lane_t();
  const float* w = tiles + from * 16 * ow;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (j * 8 >= hd) break;
    const float2 lo = *reinterpret_cast<const float2*>(w + g * ow + j * 8 + 2 * t);
    const float2 hi = *reinterpret_cast<const float2*>(w + (g + 8) * ow + j * 8 + 2 * t);
    acc[j][0] += lo.x, acc[j][1] += lo.y, acc[j][2] += hi.x, acc[j][3] += hi.y;
  }
}

// A bf16 A fragment (a 16 × 16 tile: rows g and g + 8, columns 2t, 2t + 1
// and 2t + 8, 2t + 9) into a staging tile of pitch ld at column col.
__device__ __forceinline__ void stage_a(bf16* tile, int ld, int col, const uint32_t a[4]) {
  const int g = lane_g(), t = lane_t();
  *reinterpret_cast<uint32_t*>(tile + g * ld + col + 2 * t) = a[0];
  *reinterpret_cast<uint32_t*>(tile + (g + 8) * ld + col + 2 * t) = a[1];
  *reinterpret_cast<uint32_t*>(tile + g * ld + col + 8 + 2 * t) = a[2];
  *reinterpret_cast<uint32_t*>(tile + (g + 8) * ld + col + 8 + 2 * t) = a[3];
}

// dst[0 … hd) = the column sums of a warp's 16 rows of f32 accumulator
// tiles, the rows a lane holds counted where lo_ok (row g) and hi_ok (row g
// + 8); summed over the eight row pairs by a fixed shuffle tree.
template <int HD>
__device__ __forceinline__ void column_sums(float* dst, int hd, float (*acc)[4], bool lo_ok,
                                            bool hi_ok) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (j * 8 >= hd) break;
    float a0 = (lo_ok ? acc[j][0] : 0.0f) + (hi_ok ? acc[j][2] : 0.0f);
    float a1 = (lo_ok ? acc[j][1] : 0.0f) + (hi_ok ? acc[j][3] : 0.0f);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    }
    if (g == 0) *reinterpret_cast<float2*>(dst + j * 8 + 2 * t) = make_float2(a0, a1);
  }
}

// A warp's staged 16 rows (pitch ld, from column 0) out to rows row0 … of a
// matrix of pitch `pitch`, 16-byte pieces: `chunks` of them a row, those
// at or past `cols` elements and rows at or past `n` left out.
__device__ __forceinline__ void store_rows(bf16* dst, long long pitch, int row0, int n,
                                           const bf16* tile, int ld, int chunks, int cols) {
  for (int i = threadIdx.x & 31; i < 16 * chunks; i += 32) {
    const int rr = i / chunks, ch = i - rr * chunks;
    if (row0 + rr < n && ch * 8 < cols) {
      *reinterpret_cast<uint4*>(dst + (row0 + rr) * pitch + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + rr * ld + ch * 8);
    }
  }
}

// ---- forward ---------------------------------------------------------------

// SAVE also writes p (B, H, T, Tp) for the backward.
template <bool SAVE, int HD>
__global__ void __launch_bounds__(WMAX * 32, MIN_BLOCKS)
attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            bf16* __restrict__ o, bf16* __restrict__ p_out, int T, int D, int H, int hd,
            float scale, Geometry geo) {
  constexpr int KG = Groups<HD>::KG;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsSmem L(geo, hd, KG, true, SAVE);
  const int tid = threadIdx.x, nt = blockDim.x, warps = nt >> 5, warp = tid >> 5;
  const int g = lane_g(), t = lane_t();
  const int r = warp / geo.splits, c = warp - r * geo.splits;
  const int pair = blockIdx.x / geo.row_blocks, b = pair / H, h = pair - b * H;
  const int q0 = (blockIdx.x - pair * geo.row_blocks) * geo.rows * 16, row0 = q0 + r * 16;
  const int kbeg = c * geo.kgs * 16, kgs = min(geo.kgs, geo.ng - c * geo.kgs);
  const int sp = geo.ng * 16, nkh = hd / 16;
  const long long head = static_cast<long long>(b) * T * D + static_cast<long long>(h) * hd;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.first);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.second);
  float* pmax = reinterpret_cast<float*>(smem + L.stats);  // [warp][16], then Σe
  float* psum = pmax + warps * 16;

  const int qrows = min(geo.rows * 16, (T - q0 + 15) / 16 * 16);
  load_tile<bf16, 1>(qs, L.ld, 0, q + head, D, q0, qrows, T, hd, hd, true, tid, nt);
  load_tile<bf16, 1>(ks, L.ld, 0, k + head, D, 0, sp, T, hd, hd, true, tid, nt);
  cp_async_commit();
  if (L.apart) load_tile<bf16, 1>(vs, L.ld, 0, v + head, D, 0, sp, T, hd, hd, true, tid, nt);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // logits = (q·kᵀ)·scale over the split's keys; keys ≥ T and past the split −∞
  const bool active = row0 < T;
  const int nj = 2 * kgs;  // the split's 8-key n-tiles
  float s[2 * KG][4];
#pragma unroll
  for (int j = 0; j < 2 * KG; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  float mx[2] = {-INFINITY, -INFINITY};
  if (active) {
    scores_t<1, KG * 16, HD>(s, qs, ks + kbeg * L.ld, 0, 0, L.ld, r, nkh, kgs);
    const bool tail = kbeg + nj * 8 > T;  // keys ≥ T only in the last split's last group
#pragma unroll
    for (int j = 0; j < 2 * KG; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool out = tail && kbeg + j * 8 + 2 * t + (e & 1) >= T;
        s[j][e] = out ? -INFINITY : __fmul_rn(s[j][e], scale);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float m[2] = {mx[0], mx[1]};  // the row max: a lone split's own, else traded
  if (geo.splits > 1 || !L.apart) {
    if (t == 0) {
      pmax[warp * 16 + g] = mx[0];
      pmax[warp * 16 + g + 8] = mx[1];
    }
    __syncthreads();
    if (!L.apart) {  // V follows K into the buffer every warp has left
      load_tile<bf16, 1>(vs, L.ld, 0, v + head, D, 0, sp, T, hd, hd, true, tid, nt);
      cp_async_commit();
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = -INFINITY;
      for (int cc = 0; cc < geo.splits; ++cc) {
        m[hh] = fmaxf(m[hh], pmax[(r * geo.splits + cc) * 16 + g + 8 * hh]);
      }
    }
  }

  // e = exp(logit − max), Σe traded as the max
  float l[2] = {0.0f, 0.0f};
  if (active) {
#pragma unroll
    for (int j = 0; j < 2 * KG; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __fsub_rn(s[j][e], m[e >> 1]);
        s[j][e] = exp2_approx(__fmul_rn(x, kLog2e));
        l[e >> 1] += s[j][e];
      }
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (t == 0) {
    psum[warp * 16 + g] = l[0];
    psum[warp * 16 + g + 8] = l[1];
  }
  cp_async_wait<0>();
  __syncthreads();
  float lt[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    for (int cc = 0; cc < geo.splits; ++cc) lt[hh] += psum[(r * geo.splits + cc) * 16 + g + 8 * hh];
  }
  // p = bf16(e / Σe), packed as the A fragments of p·v (one bf16 plane)
  uint32_t pf[KG][4];
  if (active) {
    const float inv[2] = {1.0f / lt[0], 1.0f / lt[1]};
#pragma unroll
    for (int jj = 0; jj < KG; ++jj) {
      if (jj >= kgs) break;
      float p0[4], p1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        p0[e] = __fmul_rn(s[2 * jj][e], inv[hh]);
        p1[e] = __fmul_rn(s[2 * jj + 1][e], inv[hh]);
      }
      acc_to_a<1>(p0, p1, &pf[jj]);
    }
  }

  if constexpr (SAVE) {
    if (active) {  // out through the warp's staging rows, 16-byte stores
      bf16* stg = reinterpret_cast<bf16*>(smem + L.p) + warp * 16 * L.pld;
#pragma unroll
      for (int jj = 0; jj < KG; ++jj) {
        if (jj >= kgs) break;
        stage_a(stg, L.pld, jj * 16, pf[jj]);
      }
      __syncwarp();
      const int tp = p_pitch(T);
      store_rows(p_out + static_cast<long long>(pair) * T * tp + kbeg, tp, row0, T, stg, L.pld,
                 2 * kgs, tp - kbeg);
    }
  }

  // o = p·v over the split's keys
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  if (active) {
    const bf16* vb = vs + kbeg * L.ld;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (kk >= kgs) break;
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        if (nn * 16 >= hd) break;
        uint32_t bfr[4];
        ldsm_x4<true>(bfr, vb, L.ld, kk * 16, nn * 16);
        mma16816(acc[2 * nn], pf[kk], bfr);
        mma16816(acc[2 * nn + 1], pf[kk], bfr + 2);
      }
    }
  }

  // the splits' o summed in order by split 0's warp, rounded once, out
  // through its staging rows with 16-byte stores
  __syncthreads();  // every warp is done with K, V, the statistics and the staging
  float* tiles = reinterpret_cast<float*>(smem);
  if (c > 0) put_split<HD>(tiles, warp, hd, acc);
  __syncthreads();
  if (c == 0 && active) {
    for (int cc = 1; cc < geo.splits; ++cc) add_split<HD>(acc, tiles, warp + cc, hd);
    bf16* stg = reinterpret_cast<bf16*>(tiles + warp * 16 * (hd + 4));  // its own slot
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (j * 8 >= hd) break;
      stage_pair(stg, hd + 8, j * 8, acc[j]);
    }
    __syncwarp();
    store_rows(o + head, D, row0, T, stg, hd + 8, hd / 8, hd);
  }
}

// ---- backward: the rows pass -----------------------------------------------

// ds = bf16(p·(dp − δ)) to the (B, H, T, Tp) scratch, dq·scale (bf16) into
// dqkv's first D columns, dbq's partial rows ((B·ng) × 3·D, columns h·hd …).
template <int HD>
__global__ void __launch_bounds__(WMAX * 32, MIN_BLOCKS)
attn_bwd_rows_kernel(const bf16* __restrict__ dO, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ p,
                     bf16* __restrict__ ds, bf16* __restrict__ dqkv, float* __restrict__ part,
                     int T, int D, int H, int hd, float scale, Geometry geo) {
  constexpr int KG = Groups<HD>::KG;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsSmem L(geo, hd, KG, false, false);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const int g = lane_g(), t = lane_t();
  const int r = warp / geo.splits, c = warp - r * geo.splits;
  const int pair = blockIdx.x / geo.row_blocks, b = pair / H, h = pair - b * H;
  const int q0 = (blockIdx.x - pair * geo.row_blocks) * geo.rows * 16, row0 = q0 + r * 16;
  const int kbeg = c * geo.kgs * 16, kgs = min(geo.kgs, geo.ng - c * geo.kgs);
  const int sp = geo.ng * 16, nkh = hd / 16, tp = p_pitch(T);
  const long long head = static_cast<long long>(b) * T * D + static_cast<long long>(h) * hd;
  const long long prow = static_cast<long long>(pair) * T * tp;
  bf16* dos = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.first);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.second);
  float* pdel = reinterpret_cast<float*>(smem + L.stats);  // [warp][16]
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);         // [row][key], ds in place

  const int qrows = min(geo.rows * 16, (T - q0 + 15) / 16 * 16);
  load_tile<bf16, 1>(dos, L.ld, 0, dO + head, D, q0, qrows, T, hd, hd, true, tid, nt);
  load_tile<bf16, 1>(ps, L.pld, 0, p + prow, tp, q0, qrows, T, tp, sp, true, tid, nt);
  load_tile<bf16, 1>(vs, L.ld, 0, v + head, D, 0, sp, T, hd, hd, true, tid, nt);
  cp_async_commit();
  if (L.apart) load_tile<bf16, 1>(ks, L.ld, 0, k + head, D, 0, sp, T, hd, hd, true, tid, nt);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // dp = do·vᵀ over the split's keys; δ's part Σ dp·p over its keys < T
  const bool active = row0 < T;
  float dp[2 * KG][4];
#pragma unroll
  for (int j = 0; j < 2 * KG; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
  float d[2] = {0.0f, 0.0f};
  if (active) {
    scores_t<1, KG * 16, HD>(dp, dos, vs + kbeg * L.ld, 0, 0, L.ld, r, nkh, kgs);
#pragma unroll
    for (int jj = 0; jj < KG; ++jj) {
      if (jj >= kgs) break;
      uint32_t pa[4];  // p's 16 × 16 tile in the accumulator layout of n-tiles 2jj, 2jj + 1
      ldsm_x4<false>(pa, ps, L.pld, r * 16, kbeg + jj * 16);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = 2 * jj + (e >> 2), ee = e & 3;
        const float2 pv = unpack(pa[(e >> 2) * 2 + (ee >> 1)]);
        if (kbeg + j * 8 + 2 * t + (ee & 1) < T) {
          d[ee >> 1] = __fadd_rn(d[ee >> 1], __fmul_rn(dp[j][ee], ee & 1 ? pv.y : pv.x));
        }
      }
    }
  }
  d[0] = quad_sum(d[0]);
  d[1] = quad_sum(d[1]);
  if (t == 0) {
    pdel[warp * 16 + g] = d[0];
    pdel[warp * 16 + g + 8] = d[1];
  }
  if (!L.apart) {  // K follows V into the buffer every warp has left
    __syncthreads();
    load_tile<bf16, 1>(ks, L.ld, 0, k + head, D, 0, sp, T, hd, hd, true, tid, nt);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  float dl[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    for (int cc = 0; cc < geo.splits; ++cc) dl[hh] += pdel[(r * geo.splits + cc) * 16 + g + 8 * hh];
  }

  // ds = p·(dp − δ) in f32 (keys ≥ T zero), rounded to bf16 where it is
  // stored and where it enters ds·k; out once through its rows of p's tile
  if (active) {
#pragma unroll
    for (int jj = 0; jj < KG; ++jj) {
      if (jj >= kgs) break;
      uint32_t pa[4];
      ldsm_x4<false>(pa, ps, L.pld, r * 16, kbeg + jj * 16);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = 2 * jj + (e >> 2), ee = e & 3;
        const float2 pv = unpack(pa[(e >> 2) * 2 + (ee >> 1)]);
        const bool ok = kbeg + j * 8 + 2 * t + (ee & 1) < T;
        dp[j][ee] = ok ? __fmul_rn(ee & 1 ? pv.y : pv.x, __fsub_rn(dp[j][ee], dl[ee >> 1])) : 0.0f;
      }
    }
    __syncwarp();
    bf16* stg = ps + r * 16 * L.pld + kbeg;
#pragma unroll
    for (int j = 0; j < 2 * KG; ++j) {
      if (j >= 2 * kgs) break;
      stage_pair(stg, L.pld, j * 8, dp[j]);
    }
    __syncwarp();
    store_rows(ds + prow + kbeg, tp, row0, T, stg, L.pld, 2 * kgs, tp - kbeg);
  }

  // dq = ds·k over the split's keys, ds as the A fragment (one bf16 plane)
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  if (active) grad_step<1, 1, KG * 16, HD>(acc, dp, ks + kbeg * L.ld, 0, L.ld, 0, hd, kgs);

  // the splits' dq summed in order by split 0's warp and scaled: dbq's
  // partial row from the f32 values, dq rounded once and out through its
  // staging rows with 16-byte stores
  __syncthreads();
  float* tiles = reinterpret_cast<float*>(smem);
  if (c > 0) put_split<HD>(tiles, warp, hd, acc);
  __syncthreads();
  if (c == 0 && active) {
    for (int cc = 1; cc < geo.splits; ++cc) add_split<HD>(acc, tiles, warp + cc, hd);
    const int ld3 = 3 * D;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fmul_rn(acc[j][e], scale);
    }
    column_sums<HD>(part + (static_cast<long long>(b) * geo.ng + row0 / 16) * ld3 + h * hd, hd,
                    acc, row0 + g < T, row0 + g + 8 < T);
    bf16* stg = reinterpret_cast<bf16*>(tiles + warp * 16 * (hd + 4));  // its own slot
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (j * 8 >= hd) break;
      stage_pair(stg, hd + 8, j * 8, acc[j]);
    }
    __syncwarp();
    store_rows(dqkv + static_cast<long long>(b) * T * ld3 + h * hd, ld3, row0, T, stg, hd + 8,
               hd / 8, hd);
  }
}

// ---- backward: the keys pass -----------------------------------------------

// dv = pᵀ·do and dk = dsᵀ·bf16(q·scale) (bf16) into dqkv's last and middle
// D columns, dbk's and dbv's partial rows.
template <int HD>
__global__ void __launch_bounds__(KEY_WARPS * 32, (HD <= 64 ? 2 : 1))
attn_bwd_keys_kernel(const bf16* __restrict__ dO, const bf16* __restrict__ q,
                     const bf16* __restrict__ p, const bf16* __restrict__ ds,
                     bf16* __restrict__ dqkv, float* __restrict__ part, int T, int D, int H,
                     int hd, float scale, int key_blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, warps = nt >> 5, warp = tid >> 5;
  const KeysSmem L(warps, hd);
  const int g = lane_g();
  const int pair = blockIdx.x / key_blocks, b = pair / H, h = pair - b * H;
  const int k0 = (blockIdx.x - pair * key_blocks) * warps * 16, key0 = k0 + warp * 16;
  const int tp = p_pitch(T), ng = (T + 15) / 16, cpr = hd / 8;
  const long long head = static_cast<long long>(b) * T * D + static_cast<long long>(h) * hd;
  const long long pbase = static_cast<long long>(pair) * T * tp + k0;
  auto ptile = [&](int s, int which) {  // 0: p, 1: ds; [query][key]
    return reinterpret_cast<bf16*>(smem + s * L.stage + which * L.ptile);
  };
  auto htile = [&](int s, int which) {  // 0: do, 1: q, then bf16(q·scale); [query][h]
    return reinterpret_cast<bf16*>(smem + s * L.stage + 2 * L.ptile + which * L.htile);
  };
  const int ntiles = (T + KEY_BQ - 1) / KEY_BQ;
  auto load = [&](int it) {  // query tile `it`, rows up to 16 past T
    const int qq = it * KEY_BQ, s = it % KEY_STAGES;
    const int n = min(KEY_BQ, (T - qq + 15) / 16 * 16);
    load_tile<bf16, 1>(ptile(s, 0), L.kld, 0, p + pbase, tp, qq, n, T, tp - k0, warps * 16, true,
                       tid, nt);
    load_tile<bf16, 1>(ptile(s, 1), L.kld, 0, ds + pbase, tp, qq, n, T, tp - k0, warps * 16,
                       true, tid, nt);
    load_tile<bf16, 1>(htile(s, 0), L.ld, 0, dO + head, D, qq, n, T, hd, hd, true, tid, nt);
    load_tile<bf16, 1>(htile(s, 1), L.ld, 0, q + head, D, qq, n, T, hd, hd, true, tid, nt);
  };
#pragma unroll
  for (int it = 0; it < KEY_STAGES - 1; ++it) {
    if (it < ntiles) load(it);
    cp_async_commit();
  }

  float dva[HD / 8][4], dka[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[j][e] = dka[j][e] = 0.0f;
  }
  for (int it = 0; it < ntiles; ++it) {
    const int s_ = it % KEY_STAGES, nqg = min(KEY_BQ, T - it * KEY_BQ + 15) / 16;
    ring_step<KEY_STAGES>(it, ntiles, load);
    bf16* qs = htile(s_, 1);
    for (int i = tid; i < nqg * 16 * cpr; i += nt) {  // q → bf16(q·scale), 8 at a time
      const int rr = i / cpr, ch = i - rr * cpr;
      uint4* x = reinterpret_cast<uint4*>(qs + rr * L.ld + ch * 8);
      uint4 u = *x;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack(w[e]);
        w[e] = pack(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
      }
      *x = u;
    }
    __syncthreads();
    const bf16 *pt = ptile(s_, 0), *dt = ptile(s_, 1), *dot = htile(s_, 0);
#pragma unroll
    for (int kk = 0; kk < KEY_BQ / 16; ++kk) {
      if (kk >= nqg) break;
      uint32_t pa[4], da[4];
      ldsm_a_trans(pa, pt, L.kld, kk * 16, warp * 16);
      ldsm_a_trans(da, dt, L.kld, kk * 16, warp * 16);
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        if (nn * 16 >= hd) break;
        uint32_t bfr[4];
        ldsm_x4<true>(bfr, dot, L.ld, kk * 16, nn * 16);
        mma16816(dva[2 * nn], pa, bfr);
        mma16816(dva[2 * nn + 1], pa, bfr + 2);
        ldsm_x4<true>(bfr, qs, L.ld, kk * 16, nn * 16);
        mma16816(dka[2 * nn], da, bfr);
        mma16816(dka[2 * nn + 1], da, bfr + 2);
      }
    }
  }
  __syncthreads();  // the ring is free for the output staging

  // dbv's and dbk's partial rows from the f32 accumulators
  const int ld3 = 3 * D;
  if (key0 < T) {
    float* prow = part + (static_cast<long long>(b) * ng + key0 / 16) * ld3 + h * hd;
    column_sums<HD>(prow + 2 * D, hd, dva, key0 + g < T, key0 + g + 8 < T);
    column_sums<HD>(prow + D, hd, dka, key0 + g < T, key0 + g + 8 < T);
  }

  // dv and dk rounded once, out through the warp's staging rows
  bf16* stg = reinterpret_cast<bf16*>(smem) + warp * 16 * L.ld;
  bf16* out = dqkv + static_cast<long long>(b) * T * ld3 + h * hd;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (j * 8 >= hd) break;
      stage_pair(stg, L.ld, j * 8, which ? dka[j] : dva[j]);
    }
    __syncwarp();
    store_rows(out + (which ? D : 2 * D), ld3, key0, T, stg, L.ld, cpr, hd);
    __syncwarp();
  }
}

}  // namespace
}  // namespace vtt_k4
