// Flash attention, backward (K6) without a bias: from q, k, v (BN, ·, H),
// the forward's output and lse, and the output cotangent g,
//   delta = Σ_h g·out (f32, per query row),
//   p     = exp(q·kᵀ·scale − lse),  dp = g·vᵀ,  ds = p·(dp − delta),
//   dv    = pᵀ·g,  dk = dsᵀ·q·scale,  dq = ds·k·scale,
// every intermediate f32, dq/dk/dv rounded once to the input type.
//
// Replaces the TPU kernels vision_toolbox_tpu/ops/flash_attention.py
// `_flash_bwd_pallas` (`_flash_bwd_dkv_kernel`, `_flash_bwd_dq_kernel`).
//
// FlashAttention-2's split, as in the TPU kernels, whose f32 accumulators
// carry along a sequential grid axis; here a loop inside the block takes
// that axis's place:
//   (a) delta, one warp per query row;
//   (b) dK/dV per (key tile, pair): the block's K and V tiles stay in shared
//       memory, query tiles of q and g stream past; p and ds are recomputed
//       per tile pair and dV += pᵀ·g, dK += dsᵀ·q accumulate in registers;
//   (c) dQ per (query tile, pair): q and g stay, K/V tiles stream past;
//       dQ += ds·k in registers.
// p and ds never leave shared memory; nothing of size (T, S) goes to device
// memory. A head wider than 128: (b) and (c) run per ≤ 128-wide chunk of
// the gradients' columns (grid z), each recomputing s and dp over the whole
// head (flash_attention.cuh). Every product runs on the tensor cores with exact operands (q, k,
// v, g as given; p and ds as two bf16 planes for bf16 inputs, everything as
// three for f32 ones: flash_attention.cuh). dk is the f32 dsᵀ·q scaled
// afterwards (the TPU kernel scales q first: the same value at head 64).
//
// What bounds it: at siglip vit_b_16 batch 64 (T = S = 1024, 12 heads of
// 64, bf16) the five products the algorithm needs are 515 GFLOP (0.52 ms at
// 989 TFLOP/s) against 0.5 GB of operands, so the tensor cores set the
// bound. This version recomputes s and dp in both (b) and (c) (FA-2's
// price for no atomics), spends a second pass on each two-plane operand and
// stages every product through shared memory.
#include "flash_attention.cuh"

using namespace vtt_flash;

namespace {

// Element pitches and byte offsets of (b)'s and (c)'s shared memory: q and g
// tiles, k and v tiles (input planes), the f32 scores and dp, p and ds
// (f32 planes), and lse and delta of the query rows.
template <typename T>
struct BwdSmem {
  int ldh, ldk, lds;
  size_t q, g, k, v, s, dp, p, ds, lse, delta, total;
  __host__ __device__ explicit BwdSmem(int H) {
    constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
    ldh = H + 8;
    ldk = BK + 8;
    lds = BK + 4;
    const size_t qt = align128(static_cast<size_t>(IN) * BQ * ldh * 2);
    const size_t kt = align128(static_cast<size_t>(IN) * BK * ldh * 2);
    const size_t st = align128(static_cast<size_t>(BQ) * lds * 4);
    const size_t pt = align128(static_cast<size_t>(MID) * BQ * ldk * 2);
    q = 0;
    g = q + qt;
    k = g + qt;
    v = k + kt;
    s = v + kt;
    dp = s + st;
    p = dp + st;
    ds = p + pt;
    lse = ds + pt;
    delta = lse + align128(BQ * 4);
    const size_t stream = delta + align128(BQ * 4);
    // after the loop the f32 results of the block's column chunk are staged
    // over the same bytes: [dv | dk] or dq
    const size_t staged = static_cast<size_t>(2) * (BK > BQ ? BK : BQ) * (chunk_width(H, 0) + 4) * 4;
    total = stream > staged ? stream : staged;
  }
};

template <typename T>
struct Tiles {  // shared-memory pointers of one backward block
  bf16 *q, *g, *k, *v, *p, *ds;
  float *s, *dp, *lse, *delta;
  __device__ Tiles(unsigned char* smem, const BwdSmem<T>& L)
      : q(reinterpret_cast<bf16*>(smem + L.q)), g(reinterpret_cast<bf16*>(smem + L.g)),
        k(reinterpret_cast<bf16*>(smem + L.k)), v(reinterpret_cast<bf16*>(smem + L.v)),
        p(reinterpret_cast<bf16*>(smem + L.p)), ds(reinterpret_cast<bf16*>(smem + L.ds)),
        s(reinterpret_cast<float*>(smem + L.s)), dp(reinterpret_cast<float*>(smem + L.dp)),
        lse(reinterpret_cast<float*>(smem + L.lse)),
        delta(reinterpret_cast<float*>(smem + L.delta)) {}
};

template <typename T>
__global__ void __launch_bounds__(NT)
flash_delta_kernel(const T* __restrict__ out, const T* __restrict__ g, float* __restrict__ delta,
                   int rows, int H) {
  const int row = blockIdx.x * NW + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * H;
  float s = 0.0f;
  for (int c = lane; c < H; c += 32) s += to_f32(out[base + c]) * to_f32(g[base + c]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// lse and delta of query rows [q0, q0 + BQ) into shared memory (0 past T).
template <typename T>
__device__ __forceinline__ void load_row_stats(const float* lse, const float* delta, size_t bn,
                                               int q0, int Tq, const Tiles<T>& sm) {
  for (int r = threadIdx.x; r < Cfg<T>::BQ; r += NT) {
    const bool ok = q0 + r < Tq;
    sm.lse[r] = ok ? lse[bn * Tq + q0 + r] : 0.0f;
    sm.delta[r] = ok ? delta[bn * Tq + q0 + r] : 0.0f;
  }
}

// For the tile pair (query rows q0.., keys k0..) whose q, g, k, v tiles are
// in shared memory: s = q·kᵀ and dp = g·vᵀ (f32), then p = exp(s·scale −
// lse) and ds = p·(dp − delta), zero outside T × S, as bf16 planes (p only
// if WITH_P). Ends synchronised.
template <typename T, bool WITH_P>
__device__ __forceinline__ void probs_and_ds(const Tiles<T>& sm, const BwdSmem<T>& L, int q0,
                                             int Tq, int k0, int S, int H, float scale) {
  constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
  const int warp = threadIdx.x >> 5;
  const int qplane = BQ * L.ldh, kplane = BK * L.ldh, pplane = BQ * L.ldk;
  constexpr int per = (BQ / 16) * (BK / 16);
  for (int t = warp; t < 2 * per; t += NW) {
    const int which = t / per, rem = t % per, i = rem % (BQ / 16), j = rem / (BQ / 16);
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    mma_planes<wmma::row_major, wmma::col_major, IN, IN>(
        acc, (which ? sm.g : sm.q) + i * 16 * L.ldh, L.ldh, 16, qplane,
        (which ? sm.v : sm.k) + j * 16 * L.ldh, L.ldh, 16, kplane, H);
    wmma::store_matrix_sync((which ? sm.dp : sm.s) + i * 16 * L.lds + j * 16, acc, L.lds,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BQ * BK; e += NT) {
    const int r = e / BK, c = e % BK;
    const bool ok = q0 + r < Tq && k0 + c < S;
    const float p = ok ? expf(sm.s[r * L.lds + c] * scale - sm.lse[r]) : 0.0f;
    const float ds = p * (sm.dp[r * L.lds + c] - sm.delta[r]);
    if constexpr (WITH_P) split_store<MID>(p, sm.p + r * L.ldk + c, pplane);
    split_store<MID>(ds, sm.ds + r * L.ldk + c, pplane);
  }
  __syncthreads();
}

// Two blocks an SM (at most 128 registers a thread): its dV and dK fragments
// otherwise take it to 136 and one block an SM, 1.3× slower at head 64.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Tq, int S, int H, float scale) {
  constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
  constexpr int MAXF = 2 * (BK / 16) * (MAX_HEAD / 16) / NW;  // [dv | dk] tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<T> L(H);
  const Tiles<T> sm(smem, L);
  const int k0 = blockIdx.x * BK;
  const size_t bn = blockIdx.y;
  const int c0 = blockIdx.z * MAX_HEAD, hc = chunk_width(H, c0);  // this block's columns
  const int warp = threadIdx.x >> 5;
  const int qplane = BQ * L.ldh, kplane = BK * L.ldh, pplane = BQ * L.ldk;

  load_rows<T, IN>(k + bn * S * H, k0, BK, S, H, H, sm.k, L.ldh, kplane);
  load_rows<T, IN>(v + bn * S * H, k0, BK, S, H, H, sm.v, L.ldh, kplane);
  const int per = (BK / 16) * (hc / 16), n_tiles = 2 * per;  // t → (dv | dk, key tile, column tile)
  Acc acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the last tile's products are done with q, g, p and ds
    load_rows<T, IN>(q + bn * Tq * H, q0, BQ, Tq, H, H, sm.q, L.ldh, qplane);
    load_rows<T, IN>(g + bn * Tq * H, q0, BQ, Tq, H, H, sm.g, L.ldh, qplane);
    load_row_stats(lse, delta, bn, q0, Tq, sm);
    __syncthreads();
    probs_and_ds<T, true>(sm, L, q0, Tq, k0, S, H, scale);
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int t = warp + f * NW;
      if (t >= n_tiles) continue;
      const int which = t / per, rem = t % per, i = rem % (BK / 16), j = rem / (BK / 16);
      // dv += pᵀ·g, dk += dsᵀ·q: (p or ds)ᵀ read column-major from the [query][key] tile
      mma_planes<wmma::col_major, wmma::row_major, MID, IN>(
          acc[f], (which ? sm.ds : sm.p) + i * 16, L.ldk, 16 * L.ldk, pplane,
          (which ? sm.q : sm.g) + c0 + j * 16, L.ldh, 16 * L.ldh, qplane, BQ);
    }
  }
  __syncthreads();

  float* staged = reinterpret_cast<float*>(smem);  // [dv | dk][key][hc + 4]
  const int ldo = hc + 4;
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int t = warp + f * NW;
    if (t >= n_tiles) continue;
    const int which = t / per, rem = t % per, i = rem % (BK / 16), j = rem / (BK / 16);
    wmma::store_matrix_sync(staged + (which * BK + i * 16) * ldo + j * 16, acc[f], ldo,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * BK * hc; e += NT) {
    const int which = e / (BK * hc), r = (e / hc) % BK, c = e % hc;
    if (k0 + r >= S) continue;
    const float val = staged[(which * BK + r) * ldo + c];
    const size_t o = (bn * S + k0 + r) * H + c0 + c;
    if (which) {
      dk[o] = from_f32<T>(val * scale);
    } else {
      dv[o] = from_f32<T>(val);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Tq, int S, int H,
                    float scale) {
  constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
  constexpr int MAXF = (BQ / 16) * (MAX_HEAD / 16) / NW;  // dq tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<T> L(H);
  const Tiles<T> sm(smem, L);
  const int q0 = blockIdx.x * BQ;
  const size_t bn = blockIdx.y;
  const int c0 = blockIdx.z * MAX_HEAD, hc = chunk_width(H, c0);  // this block's columns
  const int warp = threadIdx.x >> 5;
  const int qplane = BQ * L.ldh, kplane = BK * L.ldh, pplane = BQ * L.ldk;

  load_rows<T, IN>(q + bn * Tq * H, q0, BQ, Tq, H, H, sm.q, L.ldh, qplane);
  load_rows<T, IN>(g + bn * Tq * H, q0, BQ, Tq, H, H, sm.g, L.ldh, qplane);
  load_row_stats(lse, delta, bn, q0, Tq, sm);
  const int per = (BQ / 16) * (hc / 16);  // t → (query tile, column tile)
  Acc acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the last tile's products are done with k and ds
    load_rows<T, IN>(k + bn * S * H, k0, BK, S, H, H, sm.k, L.ldh, kplane);
    load_rows<T, IN>(v + bn * S * H, k0, BK, S, H, H, sm.v, L.ldh, kplane);
    __syncthreads();
    probs_and_ds<T, false>(sm, L, q0, Tq, k0, S, H, scale);
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {  // dq += ds·k
      const int t = warp + f * NW;
      if (t >= per) continue;
      const int i = t % (BQ / 16), j = t / (BQ / 16);
      mma_planes<wmma::row_major, wmma::row_major, MID, IN>(
          acc[f], sm.ds + i * 16 * L.ldk, L.ldk, 16, pplane, sm.k + c0 + j * 16, L.ldh,
          16 * L.ldh, kplane, BK);
    }
  }
  __syncthreads();

  float* staged = reinterpret_cast<float*>(smem);  // [query][hc + 4]
  const int ldo = hc + 4;
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int t = warp + f * NW;
    if (t >= per) continue;
    const int i = t % (BQ / 16), j = t / (BQ / 16);
    wmma::store_matrix_sync(staged + i * 16 * ldo + j * 16, acc[f], ldo, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BQ * hc; e += NT) {
    const int r = e / hc, c = e % hc;
    if (q0 + r < Tq) dq[(bn * Tq + q0 + r) * H + c0 + c] = from_f32<T>(staged[r * ldo + c] * scale);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* g, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int BN, int Tq, int S, int H, float scale, cudaStream_t st) {
  const BwdSmem<T> L(H);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  const int rows = BN * Tq;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  flash_delta_kernel<T><<<(rows + NW - 1) / NW, NT, 0, st>>>(static_cast<const T*>(out), gt,
                                                             delta, rows, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const int chunks = (H + MAX_HEAD - 1) / MAX_HEAD;
  flash_bwd_dkv_kernel<T><<<dim3((S + Cfg<T>::BK - 1) / Cfg<T>::BK, BN, chunks), NT, L.total, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Tq, S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T><<<dim3((Tq + Cfg<T>::BQ - 1) / Cfg<T>::BQ, BN, chunks), NT, L.total, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), Tq, S, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                             const void* g, const float* lse, float* delta, int is_bf16, void* dq,
                             void* dk, void* dv, int BN, int T, int S, int H, float scale,
                             void* stream) {
  if (BN <= 0 || BN > 65535 || T <= 0 || S <= 0 || H < 16 || H > MAX_HEAD_DIM || H % 16 != 0 ||
      static_cast<long long>(BN) * T > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<bf16>(q, k, v, out, g, lse, delta, dq, dk, dv, BN, T, S, H, scale, st)
              : launch_bwd<float>(q, k, v, out, g, lse, delta, dq, dk, dv, BN, T, S, H, scale, st);
  return static_cast<int>(err);
}
