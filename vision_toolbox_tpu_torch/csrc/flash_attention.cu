// Flash attention, forward (K6): per (batch·head) pair,
//   out = softmax(q·kᵀ·scale + bias)·v,   lse = logsumexp of each logit row,
// q (BN, T, H), k/v (BN, S, H), bias (BN, T, S) or none; out in the input
// type, lse (BN, T) f32 for the backward (flash_attention_bwd.cu).
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/flash_attention.py
// `_flash_fwd` (`_flash_fwd_kernel`).
//
// The TPU kernel holds one pair's whole K and V in VMEM and runs the
// running softmax over 256-key slices of them for a 256-row query block. A
// Hopper block has 227 KB of shared memory, so here K and V stream through
// it: one block per (query tile, pair) keeps its q tile, the f32 output
// accumulator and each row's running max and sum in shared memory while the
// K/V tiles pass (from L2, which holds a pair's K and V: 256 KB at T = 1024,
// head 64, bf16). Per key tile:
//   s = q·kᵀ on the tensor cores (exact operands, flash_attention.cuh), f32;
//   one warp per row: logits = s·scale (+ bias), keys ≥ S masked to −1e30,
//     m' = max(m, row max), p = exp(logits − m') in f32, stored as bf16
//     planes, l' = l·e^(m − m') + Σ p, the row's accumulator scaled by
//     e^(m − m');
//   o += p·v on the tensor cores (p's planes: never rounded to bf16 once).
// out = o / l rounded once to the input type; lse = m + log l in f32.
// The scale multiplies the f32 logits (the TPU kernel scales q first: the
// same value for a power-of-two scale, head 64; an f32 rounding otherwise).
// A head wider than 128 is split into ≤ 128-wide chunks of v's (and the
// output's) columns on grid z; each chunk's block computes the scores and
// the running softmax over the whole head again (flash_attention.cuh).
//
// What bounds it: at siglip vit_b_16 batch 32 (T = S = 1024, 12 heads of 64,
// bf16) the products are 103 GFLOP against 201 MB of operands, so the
// tensor cores set the bound (0.104 ms at 989 TFLOP/s). This first version
// stages every product through shared memory (wmma loads and stores, the
// softmax on shared rows) and spends a third product pass on p's second
// plane; register-resident tiles and wgmma/TMA pipelines are later work.
#include "flash_attention.cuh"

using namespace vtt_flash;

namespace {

// Element pitches and byte offsets of the forward's shared memory: the q
// tile, one K tile (the whole head) and one V tile (the block's chunk of
// columns, `hc` wide), as input planes, the f32 scores, p (f32 planes), the
// f32 output accumulator of the chunk, and each row's running max and sum.
template <typename T>
struct FwdSmem {
  int ldh, ldv, ldk, lds, ldo;
  size_t q, k, v, s, p, o, stats, total;
  __host__ __device__ FwdSmem(int H, int hc) {
    constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
    ldh = H + 8;
    ldv = hc + 8;
    ldk = BK + 8;
    lds = BK + 4;
    ldo = hc + 4;
    q = 0;
    k = q + align128(static_cast<size_t>(IN) * BQ * ldh * 2);
    v = k + align128(static_cast<size_t>(IN) * BK * ldh * 2);
    s = v + align128(static_cast<size_t>(IN) * BK * ldv * 2);
    p = s + align128(static_cast<size_t>(BQ) * lds * 4);
    o = p + align128(static_cast<size_t>(MID) * BQ * ldk * 2);
    stats = o + align128(static_cast<size_t>(BQ) * ldo * 4);
    total = stats + align128(static_cast<size_t>(2) * BQ * 4);
  }
};

template <typename T, bool BIAS, bool LSE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const void* __restrict__ bias, int bias_bf16, T* __restrict__ out,
                 float* __restrict__ lse, int Tq, int S, int H, float scale) {
  constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.z * MAX_HEAD, hc = chunk_width(H, c0);  // this block's output columns
  const FwdSmem<T> L(H, hc);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v);
  float* sf = reinterpret_cast<float*>(smem + L.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
  float* of = reinterpret_cast<float*>(smem + L.o);
  float* row_max = reinterpret_cast<float*>(smem + L.stats);
  float* row_sum = row_max + BQ;

  const int q0 = blockIdx.x * BQ;
  const size_t bn = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qplane = BQ * L.ldh, kplane = BK * L.ldh, vplane = BK * L.ldv, pplane = BQ * L.ldk;

  load_rows<T, IN>(q + bn * Tq * H, q0, BQ, Tq, H, H, qs, L.ldh, qplane);
  for (int e = threadIdx.x; e < BQ * L.ldo; e += NT) of[e] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += NT) {
    row_max[r] = kNegInf;
    row_sum[r] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the last tile's products are done with K, V and p
    load_rows<T, IN>(k + bn * S * H, k0, BK, S, H, H, ks, L.ldh, kplane);
    load_rows<T, IN>(v + bn * S * H + c0, k0, BK, S, H, hc, vs, L.ldv, vplane);
    __syncthreads();

    // s = q·kᵀ over the whole head, 16×16 tiles over the warps
    for (int t = warp; t < (BQ / 16) * (BK / 16); t += NW) {
      const int i = t % (BQ / 16), j = t / (BQ / 16);
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      mma_planes<wmma::row_major, wmma::col_major, IN, IN>(
          acc, qs + i * 16 * L.ldh, L.ldh, 16, qplane, ks + j * 16 * L.ldh, L.ldh, 16, kplane, H);
      wmma::store_matrix_sync(sf + i * 16 * L.lds + j * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncthreads();

    // the running softmax, one warp per query row
    for (int r = warp; r < BQ; r += NW) {
      const int row = q0 + r;
      float x[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u, col = k0 + c;
        float logit = sf[r * L.lds + c] * scale;
        if constexpr (BIAS) {
          if (row < Tq && col < S) {
            const size_t o = (bn * Tq + row) * S + col;
            logit += bias_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[o])
                               : static_cast<const float*>(bias)[o];
          }
        }
        x[u] = col < S ? logit : kNegInf;
        mx = fmaxf(mx, x[u]);
      }
      mx = warp_max(mx);
      const float m_prev = row_max[r], m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = expf(x[u] - m_new);
        sum += p;
        split_store<MID>(p, ps + r * L.ldk + lane + 32 * u, pplane);
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_prev - m_new);
      for (int c = lane; c < hc; c += 32) of[r * L.ldo + c] *= alpha;
      if (lane == 0) {
        row_max[r] = m_new;
        row_sum[r] = row_sum[r] * alpha + sum;
      }
    }
    __syncthreads();

    // o += p·v over the chunk's columns
    for (int t = warp; t < (BQ / 16) * (hc / 16); t += NW) {
      const int i = t % (BQ / 16), j = t / (BQ / 16);
      Acc acc;
      float* tile = of + i * 16 * L.ldo + j * 16;
      wmma::load_matrix_sync(acc, tile, L.ldo, wmma::mem_row_major);
      mma_planes<wmma::row_major, wmma::row_major, MID, IN>(
          acc, ps + i * 16 * L.ldk, L.ldk, 16, pplane, vs + j * 16, L.ldv, 16 * L.ldv, vplane, BK);
      wmma::store_matrix_sync(tile, acc, L.ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < BQ * hc; e += NT) {
    const int r = e / hc, c = e % hc;
    if (q0 + r < Tq) {
      out[(bn * Tq + q0 + r) * H + c0 + c] = from_f32<T>(of[r * L.ldo + c] / row_sum[r]);
    }
  }
  if constexpr (LSE) {
    if (blockIdx.z > 0) return;  // every chunk computes the same row statistics
    for (int r = threadIdx.x; r < BQ; r += NT) {
      if (q0 + r < Tq) lse[bn * Tq + q0 + r] = row_max[r] + logf(row_sum[r]);
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias,
                       int bias_bf16, void* out, float* lse, int BN, int Tq, int S, int H,
                       float scale, cudaStream_t st) {
  const FwdSmem<T> L(H, chunk_width(H, 0));  // the first chunk is the widest
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((Tq + Cfg<T>::BQ - 1) / Cfg<T>::BQ, BN, (H + MAX_HEAD - 1) / MAX_HEAD);
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(L.total));
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, L.total, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), bias, bias_bf16,
                                      static_cast<T*>(out), lse, Tq, S, H, scale);
    return cudaGetLastError();
  };
  if (bias != nullptr) {
    return lse ? run(flash_fwd_kernel<T, true, true>) : run(flash_fwd_kernel<T, true, false>);
  }
  return lse ? run(flash_fwd_kernel<T, false, true>) : run(flash_fwd_kernel<T, false, false>);
}

}  // namespace

extern "C" int vtt_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                             int bias_bf16, int is_bf16, void* out, float* lse, int BN, int T,
                             int S, int H, float scale, void* stream) {
  if (BN <= 0 || BN > 65535 || T <= 0 || S <= 0 || H < 16 || H > MAX_HEAD_DIM || H % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<bf16>(q, k, v, bias, bias_bf16, out, lse, BN, T, S, H, scale, st)
              : launch_fwd<float>(q, k, v, bias, bias_bf16, out, lse, BN, T, S, H, scale, st);
  return static_cast<int>(err);
}
