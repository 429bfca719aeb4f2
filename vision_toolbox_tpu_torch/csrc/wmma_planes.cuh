// The exact-operand wmma pieces of the window-attention kernels (K7:
// swin_attention{,_bwd}.cu), in the namespace of the flash-attention
// kernels they were written for; those (K6) and the short-attention
// kernels (K2) now run on attention_mma.cuh's register tiles.
//
// Every product runs on the tensor cores (nvcuda::wmma m16n16k16, bf16
// operands, f32 accumulation) with exact operands. An operand sits in shared
// memory as a sum of bf16 planes: a bf16 input is one plane; an f32 value x
// is split into x0 = bf16(x), x1 = bf16(x − x0), x2 = bf16(x − x0 − x1), so
// two planes hold x to 2⁻¹⁶ of its value and three to 2⁻²⁴, f32's own
// rounding. A product sums the plane products (i, j) with i + j below the
// larger plane count; the terms it drops are of the order of the planes'
// residue. bf16 × bf16 products are exact in f32.
//  - bf16 inputs: q, k, v and the cotangent g one plane each; p and ds,
//    which the TPU kernels keep in f32, two planes, so neither is ever
//    rounded to bf16 once.
//  - f32 inputs: every operand three planes, which keeps f32 accuracy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace vtt_flash {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int NT = 256;  // eight warps
constexpr int NW = NT / 32;
constexpr int MAX_HEAD = 128;      // output columns of a block: a chunk of the head
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

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

// Rows [r0, r0 + rows) of a row-major (n × src_ld) matrix, its first `cols`
// columns (src may point at a later column), into NP planes of pitch ld;
// rows at or past n read as zero.
template <typename T, int NP>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int r0, int rows, int n,
                                          int src_ld, int cols, bf16* dst, int ld, int plane) {
  if constexpr (NP == 1 && std::is_same<T, bf16>::value) {
    const int per = cols / 8;  // 16-byte pieces
    for (int e = threadIdx.x; e < rows * per; e += NT) {
      const int r = e / per, c = (e % per) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < n) {
        val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * src_ld + c);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += NT) {
      const int r = e / cols, c = e % cols;
      const float x = r0 + r < n ? to_f32(src[static_cast<size_t>(r0 + r) * src_ld + c]) : 0.0f;
      split_store<NP>(x, dst + r * ld + c, plane);
    }
  }
}

// acc += A·B over depth K (a multiple of 16): A a 16 × K and B a K × 16
// tile held as NA and NB bf16 planes (pitches lda/ldb, plane strides
// a_plane/b_plane, wmma layouts LA/LB); a_step/b_step step one 16-deep slice.
template <typename LA, typename LB, int NA, int NB>
__device__ __forceinline__ void mma_planes(Acc& acc, const bf16* a, int lda, int a_step,
                                           int a_plane, const bf16* b, int ldb, int b_step,
                                           int b_plane, int K) {
  constexpr int N = NA > NB ? NA : NB;
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
      wmma::load_matrix_sync(fa, a + i * a_plane + kk * a_step, lda);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (i + j < N) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
          wmma::load_matrix_sync(fb, b + j * b_plane + kk * b_step, ldb);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace vtt_flash
