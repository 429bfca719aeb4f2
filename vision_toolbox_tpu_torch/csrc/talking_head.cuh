// Shared pieces of the CaiT talking-head attention kernels (K5):
// talking_head.cu (the forward) and talking_head_bwd.cu (the rows pass: row
// statistics, dq and the mix-parameter gradients; the keys pass: dk, dv).
//
// The two (H, H) head mixes join every head at each (t, s), so a block
// owns R 16-row tiles of one image (query rows; key rows in the keys pass)
// for ALL heads, and streams the other side's 16-row tiles through a
// cp.async ring in shared memory, one tile of KT = 16 keys (or queries) at
// a time. Each tile runs three phases, with a barrier between them:
//   A. products on the tensor cores (attention_mma.cuh: mma.sync m16n8k16,
//      f32 accumulators in registers): warp (r, w) of the block forms, for
//      its row tile r and its G heads w·G ..., the 16 × 16 logits
//      q_h·k_hᵀ (and dout_g·v_gᵀ in the backward), and stores them in f32
//      to an exchange plane per head in shared memory;
//   B. the head mixes, lane-local: a thread owns PPT positions (t, s) of
//      the tile and reads every head's value there, so mixl_g = mlb_g +
//      Σ_h ml[g][h]·raw_h, the softmax, pw and, in the backward, dp, dmixl
//      and draw are H² fused multiply-adds in one thread's registers; the
//      results go back to the exchange planes, in place;
//   C. products again, per head: warp (r, w) reads its heads' 16 × 16 tiles
//      of pw (or draw) from the planes in the accumulator layout, splits
//      them into bf16 planes in registers and accumulates o = pw·v (dq =
//      draw·k; dv = pwᵀ·dout, dk = drawᵀ·q) in registers (`tile_product`).
// No (B, H, T, S) tensor leaves the chip. The softmax takes two sweeps over
// the keys: the first forms each row's max and Σe (and, in the backward,
// Σ e·dp, so delta = Σ_s dp·p without p), the second the probabilities.
//
// Rounding points: the logits are (q·kᵀ)·scale in f32; mixes, softmax and
// every backward intermediate f32, as the TPU kernel holds them; a product
// operand is a sum of bf16 planes (attention_mma.cuh): bf16 inputs one
// plane, f32 inputs three, and pw and draw three (f32's own rounding). Each
// tile's product is summed apart and added to its accumulator in f32. With
// two planes, or with tiles summed straight into the accumulator, the bf16
// outputs' rel L2 to the plain version at cait_s_24 b128 was 3.4× and 2.1×
// the CUDA-core first design's; this way 1.2–1.4× (NVIDIA H100 80GB HBM3,
// scripts/ab_talking_head.py). The outputs are rounded once to the input
// type.
//
// What holds them back on an H100 (cait_s_24 b128 bf16, forward 0.348 ms
// against a 0.023 ms bound, backward 1.19 against 0.056): the per-thread
// state (two heads' accumulators, the positions' values of every head, the
// row statistics) takes 128–255 registers, so an SM holds 8–16 warps; the
// K/V stream is about a fifth of the forward; no phase dominates and the
// barriers cost about 2% (phases switched off one at a time). Integer work
// was the first limit: loads and item indices divide nothing, and the
// fragment loaders take their lane offsets once a kernel (`Lanes`).
//
// Head widths: the wrapper zero-pads a head to hdp, a multiple of 16. A
// head is staged and written in chunks of HC columns (`chunk_width`: one
// chunk of 48 or 64 for heads up to 64 wide, else 48-wide chunks; 16 for
// f32, whose three planes take three times the room). With one chunk the
// block's own rows stay resident in shared memory; with several, a chunk
// of them rides in each ring stage with the streamed rows' chunk, the
// logits summing over the chunks, and the output columns are split over
// blockIdx.y, one chunk a block (recomputing the mixes per chunk).
#pragma once

#include <algorithm>
#include <initializer_list>

#include "attention_mma.cuh"

namespace vtt_th {

using namespace vtt_mma;

constexpr int MAX_SEQ = 512;  // T and S, as the JAX gate
constexpr int MAX_HEADS = 16;
constexpr int KT = 16;         // keys (queries in the keys pass) of a streamed tile
constexpr int XP = KT;         // f32 pitch of an exchange-plane row (swizzled: `xo`)
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kSmPool = 228 * 1024;  // an SM's shared memory, 1 KB of it reserved a block

// Warps of a block and blocks an SM (the launch bounds) per kernel: eight
// warps, so a block holds two 16-row tiles at 8 heads (four at 4) and each
// image's K/V (q/dout) stream is read half as often as with one; two
// forward blocks an SM (128 registers), one backward block (up to 255).
// Below that the stream from L2 and the barriers held each block back:
// blocks of four warps, three or two an SM, ran the forward 5% and the
// rows pass 10% slower (scripts/ab_talking_head.py, cait_s_24 b128).
constexpr int FWD_WARPS = 8, FWD_BLOCKS = 2, ROWS_WARPS = 8, ROWS_BLOCKS = 1, KEYS_WARPS = 8,
              KEYS_BLOCKS = 1;
constexpr int HEADS_PER_WARP = 2;  // G: the heads whose products a warp forms
// (16 heads take two whatever it is: with one, a 16-row tile's 16 warps
// would leave phase B less than a position a thread; one head a warp ran
// the forward 0.69 ms against 0.41 at cait_s_24 b128)
template <int MH>
__host__ __device__ constexpr int heads_per_warp() { return MH == 16 ? 2 : HEADS_PER_WARP; }
// A 16-row tile of W warps: blocks of `want` warps below 16 heads; at 16
// heads one tile (eight warps) a block, one block an SM.
__host__ __device__ constexpr int block_warps(int want, int W) { return W > 4 ? W : want; }
__host__ __device__ constexpr int sm_blocks(int want, int W) { return W > 4 ? 1 : want; }

// bf16 planes of an input operand (bf16: one, f32: three) and of pw and
// draw where they enter a product (three: f32's own rounding)
template <typename T>
constexpr int kInPlanes = std::is_same<T, bf16>::value ? 1 : 3;
constexpr int MID = 3;

// Whether (B, T, S, H, hd) has a kernel: hd is the padded head width, a
// multiple of 16.
inline bool admits(int B, int T, int S, int H, int hd) {
  return B >= 1 && T >= 1 && T <= MAX_SEQ && S >= 1 && S <= MAX_SEQ && H >= 1 &&
         H <= MAX_HEADS && hd >= 16 && hd % 16 == 0 &&
         static_cast<long long>(B) * ((T + 15) / 16) <= 0x7fffffffLL;
}

// The register width of H heads: 4, 8 or 16.
inline int mix_heads(int H) { return H <= 4 ? 4 : H <= 8 ? 8 : 16; }

// e = e^(x − m) on the special-function unit (2^x, relative error about
// 2⁻²²; expf gave the same rel L2 to the plain version at cait_s_24 b128
// and cost the forward 0.05 ms); p = e·(1/Σe).
__device__ __forceinline__ float softmax_e(float x, float m) {
  return exp2_approx((x - m) * kLog2e);
}

// Offset of (row, col) in an exchange plane: 16 f32 a row, the two 8-column
// halves swapped in rows with bit 1 set, so a half-warp's accesses hit 32
// distinct banks both in the accumulator layout (rows g = 0..3, 8 columns)
// and in phase B's (2 rows × 16 columns, or 1 × 16).
__device__ __forceinline__ int xo(int row, int col) { return row * XP + (col ^ ((row & 2) << 2)); }

// Columns of a head chunk for a padded head width hdp (a multiple of 16).
inline int chunk_width(int hdp, bool is_bf16) {
  if (!is_bf16) return 16;
  return hdp <= 64 && hdp != 48 ? 64 : 48;
}

// Bytes of one staged part: NP bf16 planes of `rows` rows of every head's
// chunk (pitch H·HC + 8 elements, see attention_mma.cuh).
__host__ __device__ inline size_t part_bytes(int np, int rows, int pitch) {
  return align128(static_cast<size_t>(np) * rows * pitch * 2);
}

// The mix parameters in shared memory, heads padded to MH with zeros: ml,
// mlb, mw, mwb and the transposes mlT, mwT (`mix` reads a matrix by
// columns; the 16-byte-aligned bias rows are read four at a time).
template <int MH>
struct Mix {
  float *ml, *mlb, *mw, *mwb, *mlT, *mwT;
  static constexpr size_t kBytes = align128((4 * MH * MH + 2 * MH) * 4);
  __device__ Mix(float* base)
      : ml(base), mlb(base + MH * MH), mw(mlb + MH), mwb(mw + MH * MH), mlT(mwb + MH),
        mwT(mlT + MH * MH) {}
  // From the caller's (2H² + 2H) f32 buffer: ml (H²), mlb (H), mw (H²), mwb (H).
  __device__ void load(const float* mix, int H, int tid, int nt) const {
    for (int i = tid; i < MH * MH; i += nt) {
      const int g = i / MH, h = i % MH;
      const bool in = g < H && h < H;
      ml[i] = in ? mix[g * H + h] : 0.0f;
      mw[i] = in ? mix[H * H + H + g * H + h] : 0.0f;
      mlT[h * MH + g] = ml[i];
      mwT[h * MH + g] = mw[i];
    }
    for (int g = tid; g < MH; g += nt) {
      mlb[g] = g < H ? mix[H * H + g] : 0.0f;
      mwb[g] = g < H ? mix[2 * H * H + H + g] : 0.0f;
    }
  }
};

// Row w (MH values, 16-byte aligned) of an MH × MH matrix in shared memory.
template <int MH>
__device__ __forceinline__ void mix_row(const float* m, int w, float (&r)[MH]) {
#pragma unroll
  for (int i = 0; i < MH / 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(m + w * MH)[i];
    r[4 * i] = f.x;
    r[4 * i + 1] = f.y;
    r[4 * i + 2] = f.z;
    r[4 * i + 3] = f.w;
  }
}

// out[j][g] = bias[g] + Σ_h m[g][h]·x[j][h] for the PPT positions j (bias
// null: no bias), given mT = mᵀ (mT[h][g] = m[g][h]). The sum runs over h
// in order, every (j, g) accumulator advancing one h at a time: PPT·MH
// independent fused multiply-adds a step, one column of weights in
// registers.
template <int MH, int PPT>
__device__ __forceinline__ void mix(const float* mT, const float* bias, const float (&x)[PPT][MH],
                                    float (&out)[PPT][MH]) {
#pragma unroll
  for (int g = 0; g < MH; g += 4) {
    const float4 b = bias != nullptr ? *reinterpret_cast<const float4*>(bias + g)
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      out[j][g] = b.x, out[j][g + 1] = b.y, out[j][g + 2] = b.z, out[j][g + 3] = b.w;
    }
  }
#pragma unroll
  for (int h = 0; h < MH; ++h) {
    float w[MH];
    mix_row<MH>(mT, h, w);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
#pragma unroll
      for (int g = 0; g < MH; ++g) out[j][g] = fmaf(w[g], x[j][h], out[j][g]);
    }
  }
}

// PPT consecutive f32 values (16-byte aligned for PPT = 4, 8 for 2) to and
// from an exchange plane.
template <int PPT>
__device__ __forceinline__ void ld_pos(const float* p, float* r) {
  if constexpr (PPT == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    r[0] = f.x, r[1] = f.y, r[2] = f.z, r[3] = f.w;
  } else if constexpr (PPT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    r[0] = f.x, r[1] = f.y;
  } else {
    r[0] = p[0];
  }
}
template <int PPT>
__device__ __forceinline__ void st_pos(float* p, const float* r) {
  if constexpr (PPT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (PPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    p[0] = r[0];
  }
}

// Every head's value at a thread's PPT positions (row `row`, columns c0..)
// of the exchange planes x (plane stride `plane`). The planes of padded
// heads (H ≤ h < MH) hold finite values (`zero_padded`), which their zero
// mix weights cancel.
template <int MH, int PPT>
__device__ __forceinline__ void gather(const float* x, int plane, int row, int c0,
                                       float (&out)[PPT][MH]) {
#pragma unroll
  for (int h = 0; h < MH; ++h) {
    float r[PPT];
    ld_pos<PPT>(x + h * plane + xo(row, c0), r);
#pragma unroll
    for (int j = 0; j < PPT; ++j) out[j][h] = r[j];
  }
}

// ... and back.
template <int MH, int PPT>
__device__ __forceinline__ void scatter(float* x, int plane, int row, int c0,
                                        const float (&v)[PPT][MH]) {
#pragma unroll
  for (int h = 0; h < MH; ++h) {
    float r[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) r[j] = v[j][h];
    st_pos<PPT>(x + h * plane + xo(row, c0), r);
  }
}

// Zeros the planes of the padded heads H..MH − 1 of an exchange buffer
// (visible after the block's next barrier).
template <int MH>
__device__ __forceinline__ void zero_padded(float* x, int plane, int H, int tid, int nt) {
  for (int i = tid; i < (MH - H) * plane; i += nt) x[H * plane + i] = 0.0f;
}

// A 16 × 16 accumulator pair (two n-tiles) of a warp, scaled, to its rows
// r0.. of an exchange plane (the accumulator layout: row g and g + 8,
// columns 2t, 2t + 1 of each 8-column tile).
__device__ __forceinline__ void put_tile(float* x, int r0, const float (*c)[4], float s) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float* p = x + xo(r0 + g, n * 8 + 2 * t);  // row g + 8 is 8 rows on, same swizzle
    *reinterpret_cast<float2*>(p) = make_float2(c[n][0] * s, c[n][1] * s);
    *reinterpret_cast<float2*>(p + 8 * XP) = make_float2(c[n][2] * s, c[n][3] * s);
  }
}

// The inverse: a warp's 16 × 16 tile at rows r0.. of a plane, in the
// accumulator layout.
__device__ __forceinline__ void get_tile(const float* x, int r0, float (*c)[4]) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float* p = x + xo(r0 + g, n * 8 + 2 * t);
    const float2 a = *reinterpret_cast<const float2*>(p);
    const float2 b = *reinterpret_cast<const float2*>(p + 8 * XP);
    c[n][0] = a.x, c[n][1] = a.y, c[n][2] = b.x, c[n][3] = b.y;
  }
}

// A thread's 16-byte pieces of a staged part whose rows hold H·HC/8 of
// them: thread t takes piece t % per_row of rows t / per_row, t / per_row +
// step, ... (a block has at least per_row threads), so its columns are
// fixed and loading divides nothing; threads past step·per_row idle.
struct Pieces {
  int step, r0, head, col;
  __device__ Pieces(int H, int HC, int tid, int nt) {
    const int per = HC / 8, per_row = H * per;
    step = nt / per_row;
    r0 = tid < step * per_row ? tid / per_row : 1 << 20;
    const int p = tid - (tid / per_row) * per_row;
    head = p / per;
    col = (p - head * per) * 8;
  }
};

// Item j of a sweep over key (or query) tiles of nc head chunks each: its
// tile and chunk, with no division when a head is one chunk.
__device__ __forceinline__ void tile_chunk(int j, int nc, int& tile, int& c) {
  if (nc == 1) {
    tile = j, c = 0;
  } else {
    tile = j / nc, c = j - tile * nc;
  }
}

// Rows [r0, r0 + rows) of one image's (n × H·hdp) matrix, columns
// [c0, c0 + cw) of every head, into NP bf16 planes at dst: dst[r][h·HC +
// j] for j < HC (pitch `pitch`, plane stride `plane`), zero where j ≥ cw
// or r0 + r ≥ n. bf16 goes through cp.async in 16-byte pieces (the caller
// commits and waits; hdp and c0 are multiples of 16 and the rows 16-byte
// aligned); f32 is read and split here, synchronously.
template <typename T, int NP, int HC>
__device__ __forceinline__ void load_chunk(bf16* dst, int pitch, int plane, const T* src, int D,
                                           int r0, int rows, int n, int hdp, int c0, int cw,
                                           const Pieces& P) {
  const bool col_ok = P.col < cw;
  const T* s = src + static_cast<size_t>(r0) * D + P.head * hdp + c0 + P.col;
  bf16* d = dst + P.head * HC + P.col;
  for (int r = P.r0; r < rows; r += P.step) {
    const bool ok = col_ok && r0 + r < n;
    const T* sr = s + static_cast<size_t>(r) * D;
    bf16* dr = d + r * pitch;
    if constexpr (NP == 1 && std::is_same<T, bf16>::value) {
      cp_async16(dr, ok ? sr : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) split_store<NP>(ok ? to_f32(sr[i]) : 0.0f, dr + i, plane);
    }
  }
}

// The head of one step of a one- or two-stage ring over `n` items (item i
// in stage i % 2; with two stages the caller loaded item 0 before the
// loop): waits for item `it`, makes it visible to the block and starts the
// copy of item it + 1 into the stage item it − 1 used, which every warp
// has left at the barrier. With one stage the item is loaded here, and the
// caller ends the step with a barrier before the stage is refilled.
template <typename Load>
__device__ __forceinline__ void ring_head(int it, int n, int stages, Load&& load) {
  if (stages == 1) {
    load(it);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  } else {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n) load(it + 1);
    cp_async_commit();
  }
}

// Where a launch runs: R 16-row tiles a block, `blocks` blocks an image
// (the image's tiles spread evenly), `stages` ring stages, `smem` bytes.
struct Geometry {
  int R, blocks, stages;
  size_t smem;
};

// The widest block (up to `warps` warps of `warps_per_tile` each) whose
// shared memory lets `blocks` blocks share an SM, else the widest that
// fits one, two ring stages before one; smem(R, stages) gives the bytes.
// Blocks narrow to one tile while the B images' grid would not fill the
// card's SMs twice (cait_s_24 b8: 104 one-tile blocks ran the forward 12%
// faster than 56 two-tile ones). R = 0 when nothing fits.
template <typename Smem>
Geometry pick_geometry(int B, int rows, int warps_per_tile, int warps, int blocks, Smem&& smem) {
  const int tiles = (rows + 15) / 16;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int rmax = std::max(1, std::min(warps / warps_per_tile, tiles));
  while (rmax > 1 && static_cast<long long>(B) * ((tiles + rmax - 1) / rmax) < 2LL * sms) --rmax;
  const size_t shared = std::min(kMaxSmem, kSmPool / blocks - 1024);
  for (size_t budget : {shared, kMaxSmem}) {
    for (int R = rmax; R >= 1; --R) {
      for (int st = 2; st >= 1; --st) {
        const size_t bytes = smem(R, st);
        if (bytes <= budget) {
          const int blocks = (tiles + R - 1) / R;
          const int r_even = (tiles + blocks - 1) / blocks;  // the same tiles, evenly
          return {r_even, blocks, st, smem(r_even, st)};
        }
      }
    }
  }
  return {0, 0, 0, 0};
}

// ldmatrix .x4 from a 32-bit shared-memory address.
template <bool TRANS>
__device__ __forceinline__ void ldsm_at(uint32_t r[4], uint32_t addr) {
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  }
}

// A lane's byte offsets of ldmatrix's row addresses in a bf16 tile of pitch
// ld elements (the patterns of attention_mma.cuh `ldsm_x4` and
// `ldsm_b_nk`), worked out once a kernel: `a` for an A fragment at (r0, c0)
// and a transposed B fragment at (k0, n0), `b` for the B fragment of an
// [n][k] tile. A fragment's 16-column step is then 32 bytes on the address.
struct Lanes {
  uint32_t a, b;
  __device__ explicit Lanes(int ld) {
    const int l = threadIdx.x & 31;
    a = 2u * static_cast<uint32_t>(((l & 7) + ((l >> 3) & 1) * 8) * ld + (l >> 4) * 8);
    b = 2u * static_cast<uint32_t>(((l & 7) + (l >> 4) * 8) * ld + ((l >> 3) & 1) * 8);
  }
};

// acc (16 × 16, two accumulator tiles) += x·yᵀ over nkh 16-column steps of
// a head (attention_mma.cuh `scores_t` for one 16-wide column group): x at
// shared byte address x0 (the warp's first row, the head's first column,
// Lanes::a added), y at y0 (Lanes::b added), IN planes x_plane / y_plane
// bytes apart.
template <int IN, int HC>
__device__ __forceinline__ void logits16(float (*acc)[4], uint32_t x0, uint32_t y0,
                                         uint32_t x_plane, uint32_t y_plane, int nkh) {
#pragma unroll
  for (int kk = 0; kk < HC / 16; ++kk) {
    if (kk >= nkh) break;
    uint32_t xf[IN][4], yf[IN][4];
#pragma unroll
    for (int i = 0; i < IN; ++i) ldsm_at<false>(xf[i], x0 + i * x_plane + kk * 32);
#pragma unroll
    for (int i = 0; i < IN; ++i) ldsm_at<false>(yf[i], y0 + i * y_plane + kk * 32);
    mma_planes2<IN, IN>(acc[0], acc[1], xf, yf);
  }
}

// acc (16 rows × the chunk's columns) += x·b for one 16-deep step: x the
// warp's 16 × 16 f32 tile (two accumulator tiles) as MID bf16 planes, b the
// [k][h] tile's 16 rows at shared byte address b0 (its first column,
// Lanes::a added; IN planes b_plane bytes apart), hc columns. Each
// 16-column group is formed in a fresh accumulator, plane products from the
// smallest up, and added to acc in f32: the tensor cores align a sum to its
// largest term and drop the bits below, so summing into the running
// accumulator would lose a tile's low bits to the total's magnitude at
// every step.
template <int MID, int IN, int HC>
__device__ __forceinline__ void tile_product(float (*acc)[4], const float (*x)[4], uint32_t b0,
                                             uint32_t b_plane, int hc) {
  constexpr int N = MID > IN ? MID : IN;
  uint32_t xa[MID][4];
  acc_to_a<MID>(x[0], x[1], xa);
#pragma unroll
  for (int nn = 0; nn < HC / 16; ++nn) {
    if (nn * 16 >= hc) break;
    uint32_t bfr[IN][4];
#pragma unroll
    for (int i = 0; i < IN; ++i) ldsm_at<true>(bfr[i], b0 + i * b_plane + nn * 32);
    float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, t1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int sum = N - 1; sum >= 0; --sum) {
#pragma unroll
      for (int i = 0; i < MID; ++i) {
        const int j = sum - i;
        if (j >= 0 && j < IN) {
          mma16816(t0, xa[i], bfr[j]);
          mma16816(t1, xa[i], bfr[j] + 2);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * nn][e] += t0[e];
      acc[2 * nn + 1][e] += t1[e];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace vtt_th
