// Flash attention, backward (K6) without a bias: from q (B, T, N, H), k, v
// (B, S, N, H), the forward's output and lse (B·N, T) and the output
// cotangent g, all read in place with their strides,
//   delta = Σ_h g·out (f32, per query row),
//   p     = exp(q·kᵀ·scale − lse),  dp = g·vᵀ,  ds = p·(dp − delta),
//   dv    = pᵀ·g,  dk = dsᵀ·q·scale,  dq = ds·k·scale,
// every intermediate f32, dq/dk/dv rounded once to the input type and
// written in place in (B, T, N, H) / (B, S, N, H). The flat (B·N, T, H)
// layout is the case N = 1.
//
// Replaces the TPU kernels vision_toolbox_tpu/ops/flash_attention.py
// `_flash_bwd_pallas` (`_flash_bwd_dkv_kernel`, `_flash_bwd_dq_kernel`).
//
// What bounds it: at siglip vit_b_16 batch 32 (T = S = 1024, 12 heads of
// 64, bf16) the five products the algorithm needs are 258 GFLOP (0.26 ms
// at 989 TFLOP/s) against 0.25 GB of operands, so the tensor cores set
// the bound.
//
// Design: FlashAttention-2's split, as in the TPU kernels, whose f32
// accumulators carry along a sequential grid axis; here a loop inside the
// block takes that axis's place. No atomics: a second backward gives the
// same bits.
//   (a) delta, one warp per query row;
//   (b) dK/dV, one block per (128 keys, pair, ≤ 128 gradient columns),
//       eight warps of 16 keys. K and V stay in shared memory; tiles of 32
//       queries of q and g (with their lse and delta) stream through a
//       two-stage cp.async ring. Each warp forms the transposed scores
//       directly, sᵀ = k·qᵀ and dpᵀ = v·gᵀ, in registers, then pᵀ and
//       dsᵀ = pᵀ·(dpᵀ − delta) in f32, and dv += pᵀ·g, dk += dsᵀ·q with
//       pᵀ and dsᵀ fed from registers as A fragments (their accumulator
//       layout is the A layout, attention_mma.cuh), so no operand is ever
//       transposed through shared memory; dv and dk stay in registers.
//   (c) dQ, one block per (128 queries, pair, ≤ 128 columns): q and g stay,
//       K/V tiles stream through the ring; s, dp, p and ds in registers,
//       dq += ds·k from registers.
// Planes (exact operands, attention_mma.cuh): bf16 inputs — sᵀ, dpᵀ, s
// and dp one plane each (one mma), pᵀ·g, dsᵀ·q and ds·k with p and ds as
// two planes split in registers (two mmas), so neither is rounded to bf16
// once; f32 inputs — q, k, v, g three planes, p and ds three (six mmas).
// Heads above 128: (b) and (c) run per 128-wide chunk of the gradients'
// columns (grid z), each recomputing the scores over the whole head. dk is
// the f32 dsᵀ·q scaled afterwards (the TPU kernel scales q first: the same
// value at head 64).
#include <initializer_list>

#include "attention_mma.cuh"

using namespace vtt_mma;

namespace {

constexpr int MAX_HEAD_DIM = 256;
constexpr int CHUNK = 128;  // gradient columns of a block

// Per input type: warps of 16 rows (keys in (b), queries in (c)), the
// streamed tile (queries in (b), keys in (c)), ring stages, planes of an
// input operand and of p and ds.
template <typename T>
struct Bwd;
template <>
struct Bwd<bf16> {
  static constexpr int NW = 8, QSTEP = 32, KSTEP = 64, STAGES = 2, IN = 1, MID = 2;
};
template <>
struct Bwd<float> {  // three planes of every operand: small tiles
  static constexpr int NW = 2, QSTEP = 16, KSTEP = 16, STAGES = 1, IN = 3, MID = 3;
};
// (c)'s key tile: K and V of the whole head take two ring stages, so the
// widest heads stream 32 keys at a time.
template <typename T, int HD>
__host__ __device__ constexpr int dq_kstep() {
  return HD == 256 && Bwd<T>::KSTEP > 32 ? 32 : Bwd<T>::KSTEP;
}
// Two blocks an SM at head 64 (128 registers, no spills): at one block an
// SM the backward ran 1.45× slower (scripts/tune_flash_attention.py,
// SigLIP b32, H100).
template <typename T, int HD>
__host__ __device__ constexpr int bwd_min_blocks() {
  return std::is_same<T, bf16>::value && HD == 64 ? 2 : 1;
}

enum { Q_, K_, V_, O_, G_, DQ_, DK_, DV_ };  // rows of BwdArgs::st

struct BwdArgs {
  const void *q, *k, *v, *out, *g;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  long long st[8][3];  // (batch, row, head) element strides, in the order above
  int N, T, S, H, Hp, vec;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* pair_ptr(const BwdArgs& a, int which, const void* p, int pair) {
  return Mat<const T>{static_cast<const T*>(p), a.st[which][0], a.st[which][1], a.st[which][2]}
      .pair(pair, a.N);
}
template <typename T>
__device__ __forceinline__ T* pair_ptr_out(const BwdArgs& a, int which, void* p, int pair) {
  return Mat<T>{static_cast<T*>(p), a.st[which][0], a.st[which][1], a.st[which][2]}.pair(pair, a.N);
}

// (a): delta[pair·T + t] = Σ_h g·out, one warp per row, rows pair-major.
template <typename T>
__global__ void __launch_bounds__(256) flash_delta_kernel(const BwdArgs a, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int pair = row / a.T, r = row % a.T;
  const T* o = pair_ptr<T>(a, O_, a.out, pair) + r * a.st[O_][1];
  const T* g = pair_ptr<T>(a, G_, a.g, pair) + r * a.st[G_][1];
  float s = 0.0f;
  for (int c = lane; c < a.H; c += 32) s += to_f32(o[c]) * to_f32(g[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[row] = s;
}

// Byte offsets of (b)'s shared memory: K and V (the whole head, resident),
// then per ring stage a q and a g tile, lse and delta of its queries.
template <typename T>
struct DkvSmem {
  int ldh;
  size_t kv_bytes, q_bytes, stage, ring, total;
  __host__ __device__ explicit DkvSmem(int Hp) {
    constexpr int BKV = 16 * Bwd<T>::NW, BQ = Bwd<T>::QSTEP, IN = Bwd<T>::IN;
    ldh = Hp + 8;
    kv_bytes = align128(static_cast<size_t>(IN) * BKV * ldh * 2);
    q_bytes = align128(static_cast<size_t>(IN) * BQ * ldh * 2);
    stage = 2 * q_bytes + align128(2 * BQ * 4);
    ring = 2 * kv_bytes;
    total = ring + Bwd<T>::STAGES * stage;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(Bwd<T>::NW * 32, (bwd_min_blocks<T, HD>()))
flash_bwd_dkv_kernel(const BwdArgs a) {
  using C = Bwd<T>;
  constexpr int NW = C::NW, NT = NW * 32, BKV = 16 * NW, BQ = C::QSTEP, IN = C::IN, MID = C::MID;
  constexpr int HC = HD < CHUNK ? HD : CHUNK;
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvSmem<T> L(a.Hp);
  const int tid = threadIdx.x, warp = tid >> 5, t = lane_t();
  const int k0 = blockIdx.x * BKV, pair = blockIdx.y;
  const int c0 = blockIdx.z * CHUNK, hc = min(CHUNK, a.Hp - c0);
  const int nkh = a.Hp / 16;
  const T* qp = pair_ptr<T>(a, Q_, a.q, pair);
  const T* gp = pair_ptr<T>(a, G_, a.g, pair);
  const float* lse = a.lse + static_cast<size_t>(pair) * a.T;
  const float* delta = a.delta + static_cast<size_t>(pair) * a.T;
  const int kvplane = BKV * L.ldh, qplane = BQ * L.ldh;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.kv_bytes);
  auto stage = [&](int s) { return smem + L.ring + s * L.stage; };
  auto qs = [&](int s) { return reinterpret_cast<bf16*>(stage(s)); };
  auto gs = [&](int s) { return reinterpret_cast<bf16*>(stage(s) + L.q_bytes); };
  auto stats = [&](int s) { return reinterpret_cast<float*>(stage(s) + 2 * L.q_bytes); };
  const int ntiles = (a.T + BQ - 1) / BQ;
  auto load_q = [&](int it) {  // query tile `it` into its ring stage
    const int q0 = it * BQ, s = it % C::STAGES;
    load_tile<T, IN>(qs(s), L.ldh, qplane, qp, a.st[Q_][1], q0, BQ, a.T, a.H, a.Hp, a.vec, tid, NT);
    load_tile<T, IN>(gs(s), L.ldh, qplane, gp, a.st[G_][1], q0, BQ, a.T, a.H, a.Hp, a.vec, tid, NT);
    float* st = stats(s);  // lse·log2 e (1e30 past T: p = 0 there) and delta
    for (int r = tid; r < BQ; r += NT) {
      const bool ok = q0 + r < a.T;
      st[r] = ok ? lse[q0 + r] * kLog2e : 1e30f;
      st[BQ + r] = ok ? delta[q0 + r] : 0.0f;
    }
  };

  load_tile<T, IN>(ks, L.ldh, kvplane, pair_ptr<T>(a, K_, a.k, pair), a.st[K_][1], k0, BKV, a.S,
                   a.H, a.Hp, a.vec, tid, NT);
  load_tile<T, IN>(vs, L.ldh, kvplane, pair_ptr<T>(a, V_, a.v, pair), a.st[V_][1], k0, BKV, a.S,
                   a.H, a.Hp, a.vec, tid, NT);
#pragma unroll
  for (int it = 0; it < C::STAGES - 1; ++it) {  // the ring's first tiles, each its own group
    if (it < ntiles) load_q(it);
    cp_async_commit();
  }

  float dv[HC / 8][4], dk[HC / 8][4];
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = dk[j][e] = 0.0f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int s_ = it % C::STAGES;
    ring_step<C::STAGES>(it, ntiles, load_q);

    // sᵀ = k·qᵀ, then dpᵀ = v·gᵀ, over the whole head: 16 keys × BQ queries
    // (one product at a time keeps half the fragments live)
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
    const bf16 *qt = qs(s_), *gt = gs(s_);
    scores_t<IN, BQ, HD>(s, ks, qt, kvplane, qplane, L.ldh, warp, nkh);
    scores_t<IN, BQ, HD>(dp, vs, gt, kvplane, qplane, L.ldh, warp, nkh);

    // pᵀ = e^(sᵀ·scale − lse) and dsᵀ = pᵀ·(dpᵀ − delta)
    const float* st = stats(s_);
    const float fac = a.scale * kLog2e;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float p = exp2_approx(fmaf(s[j][e], fac, -st[c]));
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - st[BQ + c]);
      }
    }

    // dv += pᵀ·g, then dk += dsᵀ·q, over the chunk's columns, pᵀ and dsᵀ
    // from registers (one product at a time keeps half the fragments live)
    grad_step<MID, IN, BQ, HC>(dv, s, gt, qplane, L.ldh, c0, hc);
    grad_step<MID, IN, BQ, HC>(dk, dp, qt, qplane, L.ldh, c0, hc);
    if constexpr (C::STAGES == 1) __syncthreads();  // the one stage is refilled next
  }

  T* dkp = pair_ptr_out<T>(a, DK_, a.dk, pair) + c0;
  T* dvp = pair_ptr_out<T>(a, DV_, a.dv, pair) + c0;
  const int row0 = k0 + warp * 16 + lane_g();
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) {
    if (j * 8 >= hc) break;
    const float sk[4] = {dk[j][0] * a.scale, dk[j][1] * a.scale, dk[j][2] * a.scale,
                         dk[j][3] * a.scale};
    store_acc<T>(dvp, a.st[DV_][1], row0, a.S, j * 8 + 2 * t, a.H - c0, dv[j]);
    store_acc<T>(dkp, a.st[DK_][1], row0, a.S, j * 8 + 2 * t, a.H - c0, sk);
  }
}

// Byte offsets of (c)'s shared memory: q and g (resident), lse and delta of
// their rows, then per ring stage a K and a V tile, both over the whole head.
template <typename T, int HD>
struct DqSmem {
  int ldh;
  size_t q_bytes, k_bytes, stats, ring, stage, total;
  __host__ __device__ explicit DqSmem(int Hp) {
    constexpr int BQ = 16 * Bwd<T>::NW, BK = dq_kstep<T, HD>(), IN = Bwd<T>::IN;
    ldh = Hp + 8;
    q_bytes = align128(static_cast<size_t>(IN) * BQ * ldh * 2);
    k_bytes = align128(static_cast<size_t>(IN) * BK * ldh * 2);
    stats = 2 * q_bytes;
    ring = stats + align128(2 * BQ * 4);
    stage = 2 * k_bytes;
    total = ring + Bwd<T>::STAGES * stage;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(Bwd<T>::NW * 32, (bwd_min_blocks<T, HD>()))
flash_bwd_dq_kernel(const BwdArgs a) {
  using C = Bwd<T>;
  constexpr int NW = C::NW, NT = NW * 32, BQ = 16 * NW, BK = dq_kstep<T, HD>(), IN = C::IN,
                MID = C::MID;
  constexpr int HC = HD < CHUNK ? HD : CHUNK;
  extern __shared__ __align__(128) unsigned char smem[];
  const DqSmem<T, HD> L(a.Hp);
  const int tid = threadIdx.x, warp = tid >> 5, t = lane_t();
  const int q0 = blockIdx.x * BQ, pair = blockIdx.y;
  const int c0 = blockIdx.z * CHUNK, hc = min(CHUNK, a.Hp - c0);
  const int nkh = a.Hp / 16;
  const T* kp = pair_ptr<T>(a, K_, a.k, pair);
  const T* vp = pair_ptr<T>(a, V_, a.v, pair);
  const int qplane = BQ * L.ldh, kplane = BK * L.ldh;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.q_bytes);
  float* stats = reinterpret_cast<float*>(smem + L.stats);  // lse·log2 e, delta of the rows
  auto ks = [&](int s) { return reinterpret_cast<bf16*>(smem + L.ring + s * L.stage); };
  auto vs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.ring + s * L.stage + L.k_bytes); };
  const int ntiles = (a.S + BK - 1) / BK;
  auto load_kv = [&](int it) {  // key tile `it` into its ring stage
    const int k0 = it * BK, s = it % C::STAGES;
    load_tile<T, IN>(ks(s), L.ldh, kplane, kp, a.st[K_][1], k0, BK, a.S, a.H, a.Hp, a.vec, tid, NT);
    load_tile<T, IN>(vs(s), L.ldh, kplane, vp, a.st[V_][1], k0, BK, a.S, a.H, a.Hp, a.vec, tid, NT);
  };

  load_tile<T, IN>(qs, L.ldh, qplane, pair_ptr<T>(a, Q_, a.q, pair), a.st[Q_][1], q0, BQ, a.T, a.H,
                   a.Hp, a.vec, tid, NT);
  load_tile<T, IN>(gs, L.ldh, qplane, pair_ptr<T>(a, G_, a.g, pair), a.st[G_][1], q0, BQ, a.T, a.H,
                   a.Hp, a.vec, tid, NT);
#pragma unroll
  for (int it = 0; it < C::STAGES - 1; ++it) {
    if (it < ntiles) load_kv(it);
    cp_async_commit();
  }

  for (int r = tid; r < BQ; r += NT) {  // p = 0 past T
    const bool ok = q0 + r < a.T;
    const size_t i = static_cast<size_t>(pair) * a.T + q0 + r;
    stats[r] = ok ? a.lse[i] * kLog2e : 1e30f;
    stats[BQ + r] = ok ? a.delta[i] : 0.0f;
  }
  const int row0 = q0 + warp * 16 + lane_g(), srow = warp * 16 + lane_g();
  float dq[HC / 8][4];
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK, s_ = it % C::STAGES;
    ring_step<C::STAGES>(it, ntiles, load_kv);

    // s = q·kᵀ, then dp = g·vᵀ, over the whole head: 16 queries × BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
    const bf16 *kt = ks(s_), *vt = vs(s_);
    scores_t<IN, BK, HD>(s, qs, kt, qplane, kplane, L.ldh, warp, nkh);
    scores_t<IN, BK, HD>(dp, gs, vt, qplane, kplane, L.ldh, warp, nkh);

    // ds = p·(dp − delta), p = e^(s·scale − lse); keys past S (only in the
    // last tile) masked, though their zero rows of k add nothing to dq
    const bool tail = k0 + BK > a.S;
    const float fac = a.scale * kLog2e;
    const float lse_r[2] = {stats[srow], stats[srow + 8]};
    const float delta_r[2] = {stats[BQ + srow], stats[BQ + srow + 8]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2_approx(fmaf(s[j][e], fac, -lse_r[h]));
        if (tail && k0 + j * 8 + 2 * t + (e & 1) >= a.S) p = 0.0f;
        dp[j][e] = p * (dp[j][e] - delta_r[h]);
      }
    }

    // dq += ds·k over the chunk's columns, ds from registers
    grad_step<MID, IN, BK, HC>(dq, dp, kt, kplane, L.ldh, c0, hc);
    if constexpr (C::STAGES == 1) __syncthreads();
  }

  T* dqp = pair_ptr_out<T>(a, DQ_, a.dq, pair) + c0;
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) {
    if (j * 8 >= hc) break;
    const float sq[4] = {dq[j][0] * a.scale, dq[j][1] * a.scale, dq[j][2] * a.scale,
                         dq[j][3] * a.scale};
    store_acc<T>(dqp, a.st[DQ_][1], row0, a.T, j * 8 + 2 * t, a.H - c0, sq);
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, const BwdArgs& a,
                   cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const BwdArgs& a, int pairs, cudaStream_t st) {
  constexpr int NW = Bwd<T>::NW, NT = NW * 32;
  const int rows = pairs * a.T, chunks = (a.Hp + CHUNK - 1) / CHUNK;
  flash_delta_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(a, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch(flash_bwd_dkv_kernel<T, HD>, dim3((a.S + 16 * NW - 1) / (16 * NW), pairs, chunks),
               NT, DkvSmem<T>(a.Hp).total, a, st);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_kernel<T, HD>, dim3((a.T + 16 * NW - 1) / (16 * NW), pairs, chunks),
                NT, DqSmem<T, HD>(a.Hp).total, a, st);
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, int pairs, cudaStream_t st) {
  if (a.Hp <= 64) return launch_bwd<T, 64>(a, pairs, st);
  if (a.Hp <= 128) return launch_bwd<T, 128>(a, pairs, st);
  return launch_bwd<T, 256>(a, pairs, st);
}

}  // namespace

// strides: (batch, row, head) element strides of q, k, v, out, g, dq, dk, dv,
// 24 values; lse and delta (B·N, T) f32, delta written here.
extern "C" int vtt_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                             const void* g, const float* lse, float* delta, int is_bf16, void* dq,
                             void* dk, void* dv, const long long* strides, int B, int N, int T,
                             int S, int H, float scale, void* stream) {
  if (B <= 0 || N <= 0 || static_cast<long long>(B) * N > 65535 || T <= 0 || S <= 0 || H < 1 ||
      H > MAX_HEAD_DIM || static_cast<long long>(B) * N * T > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a{q, k, v, out, g, lse, delta, dq, dk, dv, {}, N, T, S, H, round_up(H, 16), 0, scale};
  bool aligned = is_bf16 && H % 8 == 0;
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 3; ++j) {
      a.st[i][j] = strides[3 * i + j];
      if ((i == Q_ || i == K_ || i == V_ || i == G_) && a.st[i][j] % 8 != 0) aligned = false;
    }
  }
  for (const void* p : {q, k, v, g}) aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  a.vec = aligned;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<bf16>(a, B * N, st) : launch_bwd<float>(a, B * N, st);
  return static_cast<int>(err);
}
