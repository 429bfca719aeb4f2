// Shared pieces of Swin's window-attention kernels (K7): swin_attention.cu (the
// forward) and swin_attention_bwd.cu (the backward and the dPE sum).
//
// Operands are the projections' packed layout, q/k/v (B, nW, T, N·hd), T = S = w²
// tokens a window. A block owns one head h and a run of consecutive windows of the
// flattened (B·nW) window axis (grid (G, N)); it takes them one at a time, stages the
// window-head's (T, hd) operands in shared memory in their own type (when they fit:
// row pitches odd in 32-bit words, so 32 lanes reading 32 rows hit 32 banks; else
// the same code reads them from device memory) and gives each query row (and, in the
// backward, each key) to one warp: row t always to warp t mod 8. The warp copies
// its q·scale row to its own row of shared memory, and lane j sums the logits of
// keys j + 32i (T ≤ 256: at most 8 each) over the head, reading that row as a
// broadcast; the scores stay in registers and the softmax runs there. For the
// products with v (and k, q, g in the backward) the probabilities go to another
// row of the warp's, read back as a broadcast while lane j sums head columns
// j + 32i. Every value is f32, as in the TPU kernels
// (vision_toolbox_tpu/ops/swin_attention.py `_fwd_kernel`, `_bwd_kernel`): the
// logits (q·scale)·kᵀ summed over the head in order, then + pe, then + mask, each
// an f32 add; p = e / Σe with e = exp(logit − max); products on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// The tensor-core kernels: bf16 operands, windows of up to TC_MAX_SEQ tokens (window
// 7 and 8), head widths a multiple of 16. A block holds one window-head whole: its
// operands as bf16 tiles of TP = T rounded up to 16 rows (zero past T, pitch hd +
// 8), the f32 products q·kᵀ (and g·vᵀ) as TP × (TP + 4) planes, p (and ds) as two
// bf16 planes each (hi, lo: 2⁻¹⁶ of the value, never rounded to bf16 once; pitch
// TP + 8), an f32 staging tile for one output (TP × (hd + 4)) and, in the backward,
// the block's dPE partial (T × T f32). Products run on wmma m16n16k16 tiles with
// f32 accumulation (wmma_planes.cuh `mma_planes`).
constexpr int TC_MAX_SEQ = 64;

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

struct TcSmem {
  int tp, ldh, lds, ldp, ldo;
  size_t op_bytes, f_bytes, p_bytes, ops, f, p, o, dpe, total;
  // n_ops staged operands, n_f f32 product planes and n_p (hi, lo) plane pairs
  __host__ __device__ TcSmem(int T_, int hd, int n_ops, int n_f, int n_p, bool with_dpe) {
    tp = (T_ + 15) / 16 * 16;
    ldh = hd + 8;
    lds = tp + 4;
    ldp = tp + 8;
    ldo = hd + 4;
    op_bytes = align128(static_cast<size_t>(tp) * ldh * 2);
    f_bytes = align128(static_cast<size_t>(tp) * lds * 4);
    p_bytes = align128(static_cast<size_t>(2) * tp * ldp * 2);
    ops = 0;
    f = ops + n_ops * op_bytes;
    p = f + n_f * f_bytes;
    o = p + n_p * p_bytes;
    dpe = o + align128(static_cast<size_t>(tp) * ldo * 4);
    total = dpe + (with_dpe ? align128(static_cast<size_t>(T_) * T_ * 4) : 0);
  }
};

// Whether a shape runs the tensor-core kernels.
__host__ __device__ inline bool use_tc(int is_bf16, int T_, int hd) {
  return is_bf16 && T_ <= TC_MAX_SEQ && hd % 16 == 0;
}

// The row step of the tensor-core kernels: query row r's logits from the f32
// product row s_row (q·kᵀ) as s_row[s]·scale + pe + mask for s < T, and its softmax
// p = e / Σe into p_out, lane j holding keys j and j + 32 (T ≤ 64); 0 at s ≥ T and
// on rows past T.
__device__ __forceinline__ void tc_softmax_row(const float* s_row, int r, int T_, float scale,
                                               const void* pe, int pe_bf16, size_t pe_base,
                                               const void* mask, int mask_bf16, size_t mask_base,
                                               float (&p_out)[2]) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = lane + 32 * u;
    p_out[u] = -INFINITY;
    if (r < T_ && s < T_) {
      const size_t at = static_cast<size_t>(r) * T_ + s;
      p_out[u] = add_bias(s_row[s] * scale, pe, pe_bf16, mask, mask_bf16, pe_base + at,
                          mask_base + at);
      mx = fmaxf(mx, p_out[u]);
    }
  }
  mx = warp_max(mx);
  float sum = 0.0f;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    p_out[u] = r < T_ && lane + 32 * u < T_ ? expf(p_out[u] - mx) : 0.0f;
    sum += p_out[u];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int u = 0; u < 2; ++u) p_out[u] = r < T_ ? p_out[u] / sum : 0.0f;
}

}  // namespace vtt_swin
