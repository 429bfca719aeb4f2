// Short-sequence attention, forward (K2): per (batch·head) pair of the
// packed (B, T, N, H) q and (B, S, N, H) k and v,
//   out = softmax(q·kᵀ·scale)·v,   scale = H^-0.5,
// the softmax over each whole logit row (no running max), p in f32, out
// rounded once to the input type.
//
// Replaces the TPU kernels vision_toolbox_tpu/ops/short_attention.py
// `_packed_attention_fwd` (`_packed_fwd_kernel`, heads split inside the
// kernel) and `_short_attention_fwd` (`_fwd_kernel`, on (B·N, T, H)): one
// function, so one kernel here, which reads the packed layout in place.
//
// The TPU kernel holds whole images (all heads, all T rows and S keys) in
// VMEM. Here a block takes one tile of query rows of one pair and keeps
// their whole logit rows in shared memory, f32, so the softmax is the TPU
// kernel's two-pass one:
//   1. s = q·kᵀ, key tile by key tile (K streams through shared memory),
//      on the tensor cores into the (BQ × S) f32 rows;
//   2. one warp per row: max, e = exp(s·scale − max), Σe, p = e / Σe;
//   3. o = p·v, V streaming again, p as bf16 planes (short_attention.cuh),
//      o in registers; o rounded once.
// At the rule's corner (T = S = 512, H = 128, bf16) that is 185 KB of
// shared memory (q tile, one K/V tile, the f32 rows, p's planes of a tile).
// The scale multiplies the f32 q·kᵀ (the TPU kernel scales q first: the
// same value for a power-of-two scale, head 64; an f32 rounding otherwise).
//
// What bounds it: at vit_b_16 bs128 (1536 pairs, T = S = 197, head 64,
// bf16) the products are 15.3 GFLOP against 155 MB of q, k, v and out, so
// the bytes set the bound (0.046 ms at 3.35 TB/s). This first version
// stages every product through shared memory, pads T to 64-row tiles and
// spends a second product pass on p's second plane.
#include "short_attention.cuh"

using namespace vtt_short;

namespace {

template <typename T>
struct FwdTile;
template <>
struct FwdTile<bf16> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct FwdTile<float> {
  static constexpr int BQ = 32, BK = 32;
};

// Element pitches and byte offsets of the forward's shared memory: the q
// tile and one K (then V) tile as input planes, the f32 logit rows (which
// stage the output at the end), p's planes of one key tile.
template <typename T>
struct FwdSmem {
  int Hp, Sp, ldh, lds, ldp;
  size_t q, kv, s, p, total;
  __host__ __device__ FwdSmem(int H, int S) {
    constexpr int BQ = FwdTile<T>::BQ, BK = FwdTile<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
    Hp = round_up(H, 16);
    Sp = round_up(S, BK);
    ldh = Hp + 8;
    lds = (Sp > Hp ? Sp : Hp) + 4;
    ldp = BK + 8;
    q = 0;
    kv = q + align128(static_cast<size_t>(IN) * BQ * ldh * 2);
    s = kv + align128(static_cast<size_t>(IN) * BK * ldh * 2);
    p = s + align128(static_cast<size_t>(BQ) * lds * 4);
    total = p + align128(static_cast<size_t>(MID) * BQ * ldp * 2);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int N, int Tq, int S, int H, int q_tiles, float scale) {
  constexpr int BQ = FwdTile<T>::BQ, BK = FwdTile<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
  constexpr int MAXF = (BQ / 16) * (MAX_WIDTH / 16) / NW;  // output tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem<T> L(H, S);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* kvs = reinterpret_cast<bf16*>(smem + L.kv);
  float* sf = reinterpret_cast<float*>(smem + L.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);

  const int pair = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * BQ;
  const size_t ld = static_cast<size_t>(N) * H;
  const size_t qo = pair_offset(pair, N, Tq, H), ko = pair_offset(pair, N, S, H);
  const int warp = threadIdx.x >> 5;
  const int qplane = BQ * L.ldh, kplane = BK * L.ldh, pplane = BQ * L.ldp;

  load_padded<T, IN>(q + qo, ld, q0, BQ, Tq, H, L.Hp, qs, L.ldh, qplane);

  // 1. the logit rows s = q·kᵀ, 16×16 tiles over the warps
  for (int k0 = 0; k0 < L.Sp; k0 += BK) {
    __syncthreads();  // the last tile's products are done with K
    load_padded<T, IN>(k + ko, ld, k0, BK, S, H, L.Hp, kvs, L.ldh, kplane);
    __syncthreads();
    for (int t = warp; t < (BQ / 16) * (BK / 16); t += NW) {
      const int i = t % (BQ / 16), j = t / (BQ / 16);
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      mma_planes<wmma::row_major, wmma::col_major, IN, IN>(
          acc, qs + i * 16 * L.ldh, L.ldh, 16, qplane, kvs + j * 16 * L.ldh, L.ldh, 16, kplane,
          L.Hp);
      wmma::store_matrix_sync(sf + i * 16 * L.lds + k0 + j * 16, acc, L.lds,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // 2. the softmax of each whole row, one warp per row
  for (int r = warp; r < BQ; r += NW) softmax_row(sf + r * L.lds, S, L.Sp, scale);

  // 3. o = p·v, V tile by V tile, o in registers
  Acc acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  const int n_tiles = (BQ / 16) * (L.Hp / 16);
  for (int k0 = 0; k0 < L.Sp; k0 += BK) {
    __syncthreads();  // the softmax is done; the last tile's products are done with V and p
    load_padded<T, IN>(v + ko, ld, k0, BK, S, H, L.Hp, kvs, L.ldh, kplane);
    for (int e = threadIdx.x; e < BQ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      split_store<MID>(sf[r * L.lds + k0 + c], ps + r * L.ldp + c, pplane);
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int t = warp + f * NW;
      if (t >= n_tiles) continue;
      const int i = t % (BQ / 16), j = t / (BQ / 16);
      mma_planes<wmma::row_major, wmma::row_major, MID, IN>(
          acc[f], ps + i * 16 * L.ldp, L.ldp, 16, pplane, kvs + j * 16, L.ldh, 16 * L.ldh, kplane,
          BK);
    }
  }
  __syncthreads();  // every product is done with p: the logit rows stage the output

#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int t = warp + f * NW;
    if (t >= n_tiles) continue;
    const int i = t % (BQ / 16), j = t / (BQ / 16);
    wmma::store_matrix_sync(sf + i * 16 * L.lds + j * 16, acc[f], L.lds, wmma::mem_row_major);
  }
  __syncthreads();
  store_rows<T>(sf, L.lds, BQ, out + qo, ld, q0, Tq, H, 1.0f);
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, int B, int N,
                       int Tq, int S, int H, float scale, cudaStream_t st) {
  const FwdSmem<T> L(H, S);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  const int q_tiles = (Tq + FwdTile<T>::BQ - 1) / FwdTile<T>::BQ;
  const long long blocks = static_cast<long long>(B) * N * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      short_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  short_fwd_kernel<T><<<static_cast<unsigned>(blocks), NT, L.total, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), N, Tq, S, H, q_tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_short_attention_fwd(const void* q, const void* k, const void* v, int is_bf16,
                                       void* out, int B, int N, int T, int S, int H, float scale,
                                       void* stream) {
  if (B <= 0 || N <= 0 || T <= 0 || T > MAX_SEQ || S <= 0 || S > MAX_SEQ || H <= 0 ||
      H > MAX_WIDTH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_fwd<bf16>(q, k, v, out, B, N, T, S, H, scale, st)
                                  : launch_fwd<float>(q, k, v, out, B, N, T, S, H, scale, st);
  return static_cast<int>(err);
}
