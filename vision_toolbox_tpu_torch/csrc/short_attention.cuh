// Shared pieces of the short-sequence attention kernels (K2):
// short_attention.cu (the forward) and short_attention_bwd.cu (the rows
// pass: lse, delta and dq; the keys pass: dK/dV).
//
// K2 computes softmax(q·kᵀ·scale)·v for 2 ≤ T, S ≤ 512 and heads up to 128
// wide. The kernels read and write the packed (B, L, N, H) layout in place:
// the (batch·head) pair (b, n) is the matrix at b·L·N·H + n·H with a row
// pitch of N·H, so no (B·N, L, H) copy is made. A head that is no multiple
// of 16 wide is zero-padded in shared memory to the next multiple (zero
// columns add nothing to q·kᵀ; the output's pad columns are never written).
//
// They run on K6's register tiles (attention_mma.cuh): mma.sync m16n8k16
// with the scores, p, dp, ds and every accumulator in registers, fragments
// read by ldmatrix from padded shared-memory tiles that a cp.async ring
// fills, one barrier a tile. Each warp owns 16 rows (queries in the forward
// and the rows pass, keys in the keys pass), so T and S are padded to 16,
// not to a block's tile: a pair's 16-row tiles are spread evenly over the
// fewest blocks of at most WMAX warps (`split_rows`; T = 197: two blocks of
// seven warps, 13 tiles in 14 slots), a query tile with no valid row does
// no products, and the products over the streamed dimension stop at the
// next multiple of 16 past its end (`groups16`; 208 at S = 197), whatever
// the ring's tile. Exact operands: bf16 inputs are one bf16 plane and p and ds,
// f32 on the TPU, two planes split in registers (never rounded to bf16
// once); f32 inputs are three planes and p and ds three, which keeps f32
// accuracy without TF32.
#pragma once

#include <initializer_list>

#include "attention_mma.cuh"

namespace vtt_short {

using namespace vtt_mma;

constexpr int MAX_SEQ = 512;    // T and S: the gate's bound
constexpr int MAX_WIDTH = 128;  // the widest head
constexpr size_t kMaxSmem = 227 * 1024;

// Per input type: the most warps a block, the streamed key tile of the
// forward (BK) and of the rows pass (BKR), the streamed query tile of the
// keys pass (BQ), ring stages, bf16 planes of an input operand and of p and
// ds. bf16: the rows pass, which holds s, dp and dq, streams 32 keys, not
// 64: at 64 it spilled 88 bytes at 128 registers (two blocks an SM), at 48
// 12 (scripts/ab_short_attention.py --variant, vit_b_16 b128, H100). f32's
// three planes take three times the registers and shared memory: small
// blocks and tiles, one stage.
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int WMAX = 8, BK = 64, BKR = 32, BQ = 32, STAGES = 2, IN = 1, MID = 2;
};
template <>
struct Cfg<float> {
  static constexpr int WMAX = 2, BK = 16, BKR = 16, BQ = 16, STAGES = 1, IN = 3, MID = 3;
};

// Two blocks an SM for bf16 heads up to 64, as K6's head-64 kernels;
// wider heads and f32 take what they need.
template <typename T, int HD>
__host__ __device__ constexpr int min_blocks() {
  return std::is_same<T, bf16>::value && HD == 64 ? 2 : 1;
}

// Offset of pair `pair` (= b·N + n) of a packed (B, L, N, H) tensor.
__device__ __forceinline__ size_t pair_offset(int pair, int N, int L, int H) {
  const int b = pair / N, n = pair % N;
  return (static_cast<size_t>(b) * L * N + n) * H;
}

// 16-wide groups of the `tile` rows from r0 that reach a valid row (< end).
__device__ __forceinline__ int groups16(int r0, int tile, int end) {
  return min(tile, end - r0 + 15) / 16;
}

// A pair's n rows as 16-row tiles, one a warp, over the fewest blocks of at
// most wmax warps, the same number of warps in each.
struct Split {
  int blocks, warps;
};
inline Split split_rows(int n, int wmax) {
  const int tiles = (n + 15) / 16, blocks = (tiles + wmax - 1) / wmax;
  return {blocks, (tiles + blocks - 1) / blocks};
}

// Launches `kernel` on `blocks` one-dimensional blocks of `warps` warps.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, long long blocks, int warps, size_t smem, cudaStream_t st,
                   Args... args) {
  if (blocks > 0x7fffffffLL || smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace vtt_short
