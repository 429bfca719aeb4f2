// Short-sequence attention, backward (K2): from the saved q, k, v (packed
// (B, ·, N, H), no bias) and the output cotangent g, per (batch·head) pair,
//   p  = softmax(q·kᵀ·scale) recomputed,   dp = g·vᵀ,
//   ds = p·(dp − Σ_s dp·p),
//   dv = pᵀ·g,   dq = ds·k·scale,   dk = dsᵀ·q·scale,
// every intermediate f32, dq/dk/dv rounded once to the input type.
//
// Replaces the TPU kernels vision_toolbox_tpu/ops/short_attention.py
// `_packed_attention_bwd` (`_packed_bwd_kernel`) and `_short_attention_bwd`
// (`_bwd_kernel`, on (B·N, T, H)): one function, one pair of kernels here,
// on the packed layout in place.
//
// The TPU kernel emits dq, dk and dv of a whole image in one pass, its f32
// dk/dv for all S keys in VMEM. A Hopper block cannot hold those (512 KB at
// S = 512, head 128), so the work is split as K6's backward splits it,
// without atomics (a second backward is bit-equal to the first):
//   (a) rows: a block per (query tile, pair) keeps the whole logit and dp
//       rows of its queries in shared memory (K and V stream past), forms
//       p = e / Σe exactly as the forward does, delta = Σ_s dp·p and ds in
//       f32, then dq = ds·k·scale (K streaming again); it writes each row's
//       lse = max + log Σe and delta (f32, B·N·T each) for (b);
//   (b) keys: a block per (key tile, pair) keeps its K and V tiles, query
//       tiles of q and g stream past; p = exp(s·scale − lse) (the same p up
//       to f32 rounding) and ds are recomputed per tile pair, and
//       dV += pᵀ·g, dK += dsᵀ·q accumulate in registers.
// p and ds never leave shared memory. Products on the tensor cores with
// exact operands (short_attention.cuh). dk is the f32 dsᵀ·q scaled
// afterwards, dq the f32 ds·k (the TPU kernel scales q first: the same
// value at head 64).
//
// What bounds it: at vit_b_16 bs128 (1536 pairs, T = S = 197, head 64,
// bf16) the five products are 38 GFLOP against 271 MB of q, k, v, g in and
// dq, dk, dv out, so the bytes set the bound (0.081 ms at 3.35 TB/s). This
// version recomputes s and dp in both (a) and (b), spends a second pass on
// each two-plane operand and stages every product through shared memory.
#include "short_attention.cuh"

using namespace vtt_short;

namespace {

// (a)'s tiles: two whole f32 rows per query (s and dp) take the room, so
// fewer query rows a block than the forward.
template <typename T>
struct RowsTile;
template <>
struct RowsTile<bf16> {
  static constexpr int BQ = 32, BK = 64;
};
template <>
struct RowsTile<float> {
  static constexpr int BQ = 16, BK = 32;
};

// (a)'s shared memory: q and g tiles, one K and one V tile (input planes),
// the f32 s and dp rows (s stages dq at the end), ds's planes of a key tile.
template <typename T>
struct RowsSmem {
  int Hp, Sp, ldh, lds, ldp;
  size_t q, g, k, v, s, dp, ds, total;
  __host__ __device__ RowsSmem(int H, int S) {
    constexpr int BQ = RowsTile<T>::BQ, BK = RowsTile<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
    Hp = round_up(H, 16);
    Sp = round_up(S, BK);
    ldh = Hp + 8;
    lds = (Sp > Hp ? Sp : Hp) + 4;
    ldp = BK + 8;
    const size_t qt = align128(static_cast<size_t>(IN) * BQ * ldh * 2);
    const size_t kt = align128(static_cast<size_t>(IN) * BK * ldh * 2);
    const size_t rows = align128(static_cast<size_t>(BQ) * lds * 4);
    q = 0;
    g = q + qt;
    k = g + qt;
    v = k + kt;
    s = v + kt;
    dp = s + rows;
    ds = dp + rows;
    total = ds + align128(static_cast<size_t>(MID) * BQ * ldp * 2);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
short_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ lse,
                      float* __restrict__ delta, int N, int Tq, int S, int H, int q_tiles,
                      float scale) {
  constexpr int BQ = RowsTile<T>::BQ, BK = RowsTile<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
  constexpr int MAXF = (BQ / 16) * (MAX_WIDTH / 16) / NW;  // dq tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsSmem<T> L(H, S);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.g);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v);
  float* sf = reinterpret_cast<float*>(smem + L.s);
  float* dpf = reinterpret_cast<float*>(smem + L.dp);
  bf16* dss = reinterpret_cast<bf16*>(smem + L.ds);

  const int pair = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * BQ;
  const size_t ld = static_cast<size_t>(N) * H;
  const size_t qo = pair_offset(pair, N, Tq, H), ko = pair_offset(pair, N, S, H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qplane = BQ * L.ldh, kplane = BK * L.ldh, pplane = BQ * L.ldp;

  load_padded<T, IN>(q + qo, ld, q0, BQ, Tq, H, L.Hp, qs, L.ldh, qplane);
  load_padded<T, IN>(g + qo, ld, q0, BQ, Tq, H, L.Hp, gs, L.ldh, qplane);

  // 1. the rows s = q·kᵀ and dp = g·vᵀ
  constexpr int per = (BQ / 16) * (BK / 16);
  for (int k0 = 0; k0 < L.Sp; k0 += BK) {
    __syncthreads();  // the last tile's products are done with K and V
    load_padded<T, IN>(k + ko, ld, k0, BK, S, H, L.Hp, ks, L.ldh, kplane);
    load_padded<T, IN>(v + ko, ld, k0, BK, S, H, L.Hp, vs, L.ldh, kplane);
    __syncthreads();
    for (int t = warp; t < 2 * per; t += NW) {
      const int which = t / per, rem = t % per, i = rem % (BQ / 16), j = rem / (BQ / 16);
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      mma_planes<wmma::row_major, wmma::col_major, IN, IN>(
          acc, (which ? gs : qs) + i * 16 * L.ldh, L.ldh, 16, qplane,
          (which ? vs : ks) + j * 16 * L.ldh, L.ldh, 16, kplane, L.Hp);
      wmma::store_matrix_sync((which ? dpf : sf) + i * 16 * L.lds + k0 + j * 16, acc, L.lds,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // 2. per row: p, delta = Σ dp·p, ds = p·(dp − delta) over dp; lse and delta out
  for (int r = warp; r < BQ; r += NW) {
    float* srow = sf + r * L.lds;
    float* drow = dpf + r * L.lds;
    const float2 stats = softmax_row(srow, S, L.Sp, scale);
    float d = 0.0f;
    for (int c = lane; c < S; c += 32) d += drow[c] * srow[c];
    d = warp_sum(d);
    for (int c = lane; c < L.Sp; c += 32) drow[c] = srow[c] * (drow[c] - d);
    if (lane == 0 && q0 + r < Tq) {
      const size_t row = static_cast<size_t>(pair) * Tq + q0 + r;
      lse[row] = stats.x + logf(stats.y);
      delta[row] = d;
    }
  }

  // 3. dq = ds·k, K tile by K tile, in registers
  Acc acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  const int n_tiles = (BQ / 16) * (L.Hp / 16);
  for (int k0 = 0; k0 < L.Sp; k0 += BK) {
    __syncthreads();  // ds is done; the last tile's products are done with K and ds
    load_padded<T, IN>(k + ko, ld, k0, BK, S, H, L.Hp, ks, L.ldh, kplane);
    for (int e = threadIdx.x; e < BQ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      split_store<MID>(dpf[r * L.lds + k0 + c], dss + r * L.ldp + c, pplane);
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int t = warp + f * NW;
      if (t >= n_tiles) continue;
      const int i = t % (BQ / 16), j = t / (BQ / 16);
      mma_planes<wmma::row_major, wmma::row_major, MID, IN>(
          acc[f], dss + i * 16 * L.ldp, L.ldp, 16, pplane, ks + j * 16, L.ldh, 16 * L.ldh,
          kplane, BK);
    }
  }
  __syncthreads();

#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int t = warp + f * NW;
    if (t >= n_tiles) continue;
    const int i = t % (BQ / 16), j = t / (BQ / 16);
    wmma::store_matrix_sync(sf + i * 16 * L.lds + j * 16, acc[f], L.lds, wmma::mem_row_major);
  }
  __syncthreads();
  store_rows<T>(sf, L.lds, BQ, dq + qo, ld, q0, Tq, H, scale);
}

// (b)'s shared memory, K6's dK/dV layout (Cfg's tiles): q and g tiles, k and
// v tiles, the f32 s and dp of a tile pair, p and ds planes, lse and delta
// of the query rows; after the loop [dv | dk] are staged over the same bytes.
template <typename T>
struct KeysSmem {
  int Hp, ldh, ldk, lds;
  size_t q, g, k, v, s, dp, p, ds, lse, delta, total;
  __host__ __device__ explicit KeysSmem(int H) {
    constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
    Hp = round_up(H, 16);
    ldh = Hp + 8;
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
    const size_t staged = static_cast<size_t>(2) * BK * (Hp + 4) * 4;
    total = stream > staged ? stream : staged;
  }
};

// Two blocks an SM (at most 128 registers a thread), as K6's dK/dV kernel.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
short_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int N, int Tq, int S, int H, int k_tiles, float scale) {
  constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK, IN = Cfg<T>::IN, MID = Cfg<T>::MID;
  constexpr int MAXF = 2 * (BK / 16) * (MAX_WIDTH / 16) / NW;  // [dv | dk] tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const KeysSmem<T> L(H);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.g);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v);
  float* sf = reinterpret_cast<float*>(smem + L.s);
  float* dpf = reinterpret_cast<float*>(smem + L.dp);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
  bf16* dss = reinterpret_cast<bf16*>(smem + L.ds);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);

  const int pair = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * BK;
  const size_t ld = static_cast<size_t>(N) * H;
  const size_t qo = pair_offset(pair, N, Tq, H), ko = pair_offset(pair, N, S, H);
  const int warp = threadIdx.x >> 5;
  const int qplane = BQ * L.ldh, kplane = BK * L.ldh, pplane = BQ * L.ldk;

  load_padded<T, IN>(k + ko, ld, k0, BK, S, H, L.Hp, ks, L.ldh, kplane);
  load_padded<T, IN>(v + ko, ld, k0, BK, S, H, L.Hp, vs, L.ldh, kplane);
  const int per = (BK / 16) * (L.Hp / 16), n_tiles = 2 * per;  // t → (dv | dk, key, column)
  Acc acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  constexpr int per_s = (BQ / 16) * (BK / 16);
  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the last tile's products are done with q, g, p and ds
    load_padded<T, IN>(q + qo, ld, q0, BQ, Tq, H, L.Hp, qs, L.ldh, qplane);
    load_padded<T, IN>(g + qo, ld, q0, BQ, Tq, H, L.Hp, gs, L.ldh, qplane);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool ok = q0 + r < Tq;
      const size_t row = static_cast<size_t>(pair) * Tq + q0 + r;
      lse_s[r] = ok ? lse[row] : 0.0f;
      delta_s[r] = ok ? delta[row] : 0.0f;
    }
    __syncthreads();
    for (int t = warp; t < 2 * per_s; t += NW) {  // s = q·kᵀ and dp = g·vᵀ of the tile pair
      const int which = t / per_s, rem = t % per_s, i = rem % (BQ / 16), j = rem / (BQ / 16);
      Acc a;
      wmma::fill_fragment(a, 0.0f);
      mma_planes<wmma::row_major, wmma::col_major, IN, IN>(
          a, (which ? gs : qs) + i * 16 * L.ldh, L.ldh, 16, qplane,
          (which ? vs : ks) + j * 16 * L.ldh, L.ldh, 16, kplane, L.Hp);
      wmma::store_matrix_sync((which ? dpf : sf) + i * 16 * L.lds + j * 16, a, L.lds,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const bool ok = q0 + r < Tq && k0 + c < S;
      const float p = ok ? expf(sf[r * L.lds + c] * scale - lse_s[r]) : 0.0f;
      const float ds = p * (dpf[r * L.lds + c] - delta_s[r]);
      split_store<MID>(p, ps + r * L.ldk + c, pplane);
      split_store<MID>(ds, dss + r * L.ldk + c, pplane);
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int t = warp + f * NW;
      if (t >= n_tiles) continue;
      const int which = t / per, rem = t % per, i = rem % (BK / 16), j = rem / (BK / 16);
      // dv += pᵀ·g, dk += dsᵀ·q: (p or ds)ᵀ read column-major from the [query][key] tile
      mma_planes<wmma::col_major, wmma::row_major, MID, IN>(
          acc[f], (which ? dss : ps) + i * 16, L.ldk, 16 * L.ldk, pplane,
          (which ? qs : gs) + j * 16, L.ldh, 16 * L.ldh, qplane, BQ);
    }
  }
  __syncthreads();

  float* staged = reinterpret_cast<float*>(smem);  // [dv | dk][key][Hp + 4]
  const int ldo = L.Hp + 4;
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int t = warp + f * NW;
    if (t >= n_tiles) continue;
    const int which = t / per, rem = t % per, i = rem % (BK / 16), j = rem / (BK / 16);
    wmma::store_matrix_sync(staged + (which * BK + i * 16) * ldo + j * 16, acc[f], ldo,
                            wmma::mem_row_major);
  }
  __syncthreads();
  store_rows<T>(staged, ldo, BK, dv + ko, ld, k0, S, H, 1.0f);
  store_rows<T>(staged + BK * ldo, ldo, BK, dk + ko, ld, k0, S, H, scale);
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                       void* dk, void* dv, float* lse, float* delta, int B, int N, int Tq, int S,
                       int H, float scale, cudaStream_t st) {
  const RowsSmem<T> R(H, S);
  const KeysSmem<T> K(H);
  if (R.total > kMaxSmem || K.total > kMaxSmem) return cudaErrorInvalidValue;
  const int q_tiles = (Tq + RowsTile<T>::BQ - 1) / RowsTile<T>::BQ;
  const int k_tiles = (S + Cfg<T>::BK - 1) / Cfg<T>::BK;
  const long long pairs = static_cast<long long>(B) * N;
  if (pairs * (q_tiles > k_tiles ? q_tiles : k_tiles) > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);

  cudaError_t err = cudaFuncSetAttribute(short_bwd_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(R.total));
  if (err != cudaSuccess) return err;
  short_bwd_rows_kernel<T><<<static_cast<unsigned>(pairs * q_tiles), NT, R.total, st>>>(
      qt, kt, vt, gt, static_cast<T*>(dq), lse, delta, N, Tq, S, H, q_tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(short_bwd_keys_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(K.total));
  if (err != cudaSuccess) return err;
  short_bwd_keys_kernel<T><<<static_cast<unsigned>(pairs * k_tiles), NT, K.total, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, Tq, S, H,
      k_tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_short_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                       int is_bf16, void* dq, void* dk, void* dv, float* lse,
                                       float* delta, int B, int N, int T, int S, int H,
                                       float scale, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0 || T > MAX_SEQ || S <= 0 || S > MAX_SEQ || H <= 0 ||
      H > MAX_WIDTH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<bf16>(q, k, v, g, dq, dk, dv, lse, delta, B, N, T, S, H, scale, st)
              : launch_bwd<float>(q, k, v, g, dq, dk, dv, lse, delta, B, N, T, S, H, scale, st);
  return static_cast<int>(err);
}
