// Shared pieces of the short-sequence attention kernels (K2):
// short_attention.cu (the forward) and short_attention_bwd.cu (dq with the
// row statistics, then dK/dV).
//
// K2 computes softmax(q·kᵀ·scale)·v for 2 ≤ T, S ≤ 512 and heads up to 128
// wide, with the whole (T, S) logit row of a query on chip and no running
// softmax: p = e / Σe exactly, then p·v, both in f32. The kernels read and
// write the packed (B, L, N, H) layout in place: the (batch·head) pair
// (b, n) is the matrix at b·L·N·H + n·H with a row pitch of N·H, so no
// (B·N, L, H) copy is made. A head that is no multiple of 16 wide is
// zero-padded in shared memory to the next multiple (zero columns add
// nothing to q·kᵀ; the output's pad columns are never written).
//
// The products run on the tensor cores with K6's exact-operand planes
// (wmma_planes.cuh): bf16 inputs are one bf16 plane and p and ds, f32
// on the TPU, two; f32 inputs are three planes and p and ds three, which
// keeps f32 accuracy without TF32.
#pragma once

#include "wmma_planes.cuh"

namespace vtt_short {

using namespace vtt_flash;

constexpr int MAX_SEQ = 512;   // T and S: the gate's bound, and the logit rows' room
constexpr int MAX_WIDTH = 128;  // the widest head

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Offset of pair `pair` (= b·N + n) of a packed (B, L, N, H) tensor.
__device__ __forceinline__ size_t pair_offset(int pair, int N, int L, int H) {
  const int b = pair / N, n = pair % N;
  return (static_cast<size_t>(b) * L * N + n) * H;
}

// Rows [r0, r0 + rows) of one pair's (n × H) matrix (row pitch src_ld) into
// NP bf16 planes of pitch ld, plane stride `plane`; columns H..Hp and rows
// at or past n read as zero.
template <typename T, int NP>
__device__ __forceinline__ void load_padded(const T* __restrict__ src, size_t src_ld, int r0,
                                            int rows, int n, int H, int Hp, bf16* dst, int ld,
                                            int plane) {
  if constexpr (NP == 1 && std::is_same<T, bf16>::value) {
    if (H % 8 == 0) {  // 16-byte pieces: the pair's offset and pitch are multiples of 8
      const int per = Hp / 8;
      for (int e = threadIdx.x; e < rows * per; e += NT) {
        const int r = e / per, c = (e % per) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r0 + r < n && c < H) {
          val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * src_ld + c);
        }
        *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < rows * Hp; e += NT) {
    const int r = e / Hp, c = e % Hp;
    const float x =
        r0 + r < n && c < H ? to_f32(src[static_cast<size_t>(r0 + r) * src_ld + c]) : 0.0f;
    split_store<NP>(x, dst + r * ld + c, plane);
  }
}

// One warp: the f32 row of q·kᵀ (S valid columns of Sp) becomes p = e / Σe,
// e = exp(x·scale − max), in place, zero past S. Returns (max, Σe).
__device__ __forceinline__ float2 softmax_row(float* row, int S, int Sp, float scale) {
  const int lane = threadIdx.x & 31;
  float mx = kNegInf;
  for (int c = lane; c < S; c += 32) mx = fmaxf(mx, row[c] * scale);
  mx = warp_max(mx);
  float sum = 0.0f;
  for (int c = lane; c < S; c += 32) {
    const float e = expf(row[c] * scale - mx);
    row[c] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int c = lane; c < Sp; c += 32) row[c] = c < S ? row[c] / sum : 0.0f;
  return make_float2(mx, sum);
}

// Rows of an f32 (BQ × ·) staging buffer (pitch lds) to one pair's rows
// [r0, r0 + BQ) of a packed output (pitch dst_ld), H columns, times `mul`,
// rounded once; rows at or past n are not written.
template <typename T>
__device__ __forceinline__ void store_rows(const float* staged, int lds, int rows, T* dst,
                                           size_t dst_ld, int r0, int n, int H, float mul) {
  for (int e = threadIdx.x; e < rows * H; e += NT) {
    const int r = e / H, c = e % H;
    if (r0 + r < n) {
      dst[static_cast<size_t>(r0 + r) * dst_ld + c] = from_f32<T>(staged[r * lds + c] * mul);
    }
  }
}

}  // namespace vtt_short
