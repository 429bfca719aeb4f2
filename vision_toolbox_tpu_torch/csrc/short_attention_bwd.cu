// Short-sequence attention, backward (K2): from the saved q, k, v (packed
// (B, ·, N, H), no bias) and the output cotangent g, per (batch·head) pair,
//   p  = softmax(q·kᵀ·scale) recomputed,   dp = g·vᵀ,
//   ds = p·(dp − Σ_s dp·p),
//   dv = pᵀ·g,   dq = ds·k·scale,   dk = dsᵀ·q·scale,
// every intermediate f32, dq/dk/dv rounded once to the input type and
// written in place.
//
// Replaces the TPU kernels vision_toolbox_tpu/ops/short_attention.py
// `_packed_attention_bwd` (`_packed_bwd_kernel`) and `_short_attention_bwd`
// (`_bwd_kernel`, on (B·N, T, H)): one function, one pair of kernels here,
// on the packed layout in place.
//
// What bounds it: at vit_b_16 bs128 (1536 pairs, T = S = 197, head 64,
// bf16) the five products are 38 GFLOP against 271 MB of q, k, v, g in and
// dq, dk, dv out, so the bytes set the bound (0.081 ms at 3.35 TB/s). The
// products issued, with 16-row padding and p's and ds's two planes, are 12
// units of 8.5 GFLOP (below).
//
// Design: the TPU kernel emits dq, dk and dv of a whole image in one pass,
// its f32 dk/dv for all S keys in VMEM. Here the work is split as K6's
// backward splits it, without atomics (a second backward gives the same
// bits), on K6's register tiles (short_attention.cuh):
//   (a) rows: a block per group of a pair's 16-row query tiles, one a warp,
//       q and g rows resident; K and V tiles of 32 keys stream through a
//       cp.async ring twice, one sweep after the other in one ring. Sweep 1
//       forms s = q·kᵀ and dp = g·vᵀ in registers and keeps, per row, the
//       running max m, Σe and Σ e·dp (e = e^(s·scale − m), rescaled as m
//       grows), so lse = m + log Σe and delta = Σ e·dp / Σe = Σ_s dp·p, the
//       TPU kernel's own delta (out is not saved, so not Σ g·out), with no
//       whole f32 row on chip. Sweep 2 forms s and dp again, p = e^(s·scale
//       − lse), ds = p·(dp − delta) and dq += ds·k with ds split into two
//       bf16 planes in registers. lse and delta (f32, B·N·T each) go out
//       for (b). Issued: 2 units, then 2 + 2. A query tile with no valid row
//       does no products.
//   (b) keys, K6's dK/dV kernel: a block per group of a pair's 16-row key
//       tiles, K and V resident; q and g tiles of 32 queries with their lse
//       and delta stream through a cp.async ring. sᵀ = k·qᵀ and dpᵀ = v·gᵀ
//       are formed directly in registers, so pᵀ = e^(sᵀ·scale − lse) and
//       dsᵀ = pᵀ·(dpᵀ − delta) are A fragments: dv += pᵀ·g and dk +=
//       dsᵀ·q, on two planes each. Issued: 2 + 2 + 2. A warp whose keys all
//       lie past S (one of 14 at S = 197) runs on zero rows and stores
//       nothing: skipping it cost the kernel 4 bytes of spills.
// Products over the streamed dimension stop at the next multiple of 16
// past its end. Registers (ptxas, bf16 head 64, two blocks an SM): 128 or
// fewer, no spills. f32 inputs: three planes of every operand and of p and
// ds. dk is the f32 dsᵀ·q scaled afterwards, dq the f32 ds·k (the TPU
// kernel scales q first: the same value at head 64).
#include "short_attention.cuh"

using namespace vtt_short;

namespace {

// Byte offsets of (a)'s shared memory: the block's q and g rows, then per
// ring stage a K and a V tile.
template <typename T>
struct RowsSmem {
  int ldh;
  size_t qbytes, kbytes, ring, total;
  __host__ __device__ RowsSmem(int Hp, int warps) {
    constexpr int IN = Cfg<T>::IN;
    ldh = Hp + 8;
    qbytes = align128(static_cast<size_t>(IN) * warps * 16 * ldh * 2);
    kbytes = align128(static_cast<size_t>(IN) * Cfg<T>::BKR * ldh * 2);
    ring = 2 * qbytes;
    total = ring + Cfg<T>::STAGES * 2 * kbytes;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T>::WMAX * 32, (min_blocks<T, HD>()))
short_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ lse,
                      float* __restrict__ delta, int N, int Tq, int S, int H, int Hp, int vec,
                      int row_blocks, float scale) {
  using C = Cfg<T>;
  constexpr int BK = C::BKR, IN = C::IN, MID = C::MID, ST = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x, warps = nt >> 5;
  const RowsSmem<T> L(Hp, warps);
  const int tid = threadIdx.x, warp = tid >> 5, t = lane_t();
  const int pair = blockIdx.x / row_blocks, q0 = (blockIdx.x % row_blocks) * warps * 16;
  const long long ld = static_cast<long long>(N) * H;
  const size_t qo = pair_offset(pair, N, Tq, H);
  const T* kp = k + pair_offset(pair, N, S, H);
  const T* vp = v + pair_offset(pair, N, S, H);
  const int qplane = warps * 16 * L.ldh, kplane = BK * L.ldh, nkh = Hp / 16;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.qbytes);
  auto ks = [&](int s) { return reinterpret_cast<bf16*>(smem + L.ring + 2 * s * L.kbytes); };
  auto vs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.ring + (2 * s + 1) * L.kbytes); };
  const int ntiles = (S + BK - 1) / BK;
  auto load_kv = [&](int it) {  // iteration `it` of the two sweeps: key tile it % ntiles
    const int k0 = it % ntiles * BK, s = it % ST, rows = groups16(k0, BK, S) * 16;
    load_tile<T, IN>(ks(s), L.ldh, kplane, kp, ld, k0, rows, S, H, Hp, vec, tid, nt);
    load_tile<T, IN>(vs(s), L.ldh, kplane, vp, ld, k0, rows, S, H, Hp, vec, tid, nt);
  };

  const int qrows = groups16(q0, warps * 16, Tq) * 16;
  load_tile<T, IN>(qs, L.ldh, qplane, q + qo, ld, q0, qrows, Tq, H, Hp, vec, tid, nt);
  load_tile<T, IN>(gs, L.ldh, qplane, g + qo, ld, q0, qrows, Tq, H, Hp, vec, tid, nt);
#pragma unroll
  for (int it = 0; it < ST - 1; ++it) {  // the ring's first tiles, each its own group
    if (it < ntiles) load_kv(it);
    cp_async_commit();
  }

  const bool active = q0 + warp * 16 < Tq;  // the warp's tile holds a query row
  const int row0 = q0 + warp * 16 + lane_g();
  const float fac = scale * kLog2e;

  // sweep 1: per row (g, g + 8) the running max m, and this thread's part
  // of Σe and Σ e·dp
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, d[2] = {0.0f, 0.0f};
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK, s_ = it % ST;
    ring_step<ST>(it, 2 * ntiles, load_kv);
    if (active) {
      const int nkg = groups16(k0, BK, S);
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
      scores_t<IN, BK, HD>(s, qs, ks(s_), qplane, kplane, L.ldh, warp, nkh, nkg);
      scores_t<IN, BK, HD>(dp, gs, vs(s_), qplane, kplane, L.ldh, warp, nkh, nkg);
      const bool tail = k0 + BK > S;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (tail && k0 + j * 8 + 2 * t + (e & 1) >= S) s[j][e] = kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float mb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]) * scale);
        const float alpha = exp2_approx((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        mb[h] = m_new * kLog2e;
        l[h] *= alpha;
        d[h] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[j][e], fac, -mb[e >> 1]));
          l[e >> 1] += p;
          d[e >> 1] = fmaf(p, dp[j][e], d[e >> 1]);
        }
      }
    }
    if constexpr (ST == 1) __syncthreads();  // the one stage is refilled next
  }

  // lse and delta of the rows: out for (b), and kept (lse as lse·log2 e)
  // for sweep 2
  float lb[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]);
    const float row_lse = m[h] + logf(lt);
    lb[h] = row_lse * kLog2e;
    dl[h] = quad_sum(d[h]) / lt;
    const int r = row0 + 8 * h;
    if (active && t == 0 && r < Tq) {
      lse[static_cast<size_t>(pair) * Tq + r] = row_lse;
      delta[static_cast<size_t>(pair) * Tq + r] = dl[h];
    }
  }

  // sweep 2: p, ds = p·(dp − delta), dq += ds·k
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int it = ntiles; it < 2 * ntiles; ++it) {
    const int k0 = (it - ntiles) * BK, s_ = it % ST;
    ring_step<ST>(it, 2 * ntiles, load_kv);
    if (active) {
      const int nkg = groups16(k0, BK, S);
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
      scores_t<IN, BK, HD>(s, qs, ks(s_), qplane, kplane, L.ldh, warp, nkh, nkg);
      scores_t<IN, BK, HD>(dp, gs, vs(s_), qplane, kplane, L.ldh, warp, nkh, nkg);
      const bool tail = k0 + BK > S;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = exp2_approx(fmaf(s[j][e], fac, -lb[h]));
          if (tail && k0 + j * 8 + 2 * t + (e & 1) >= S) p = 0.0f;
          dp[j][e] = p * (dp[j][e] - dl[h]);
        }
      }
      grad_step<MID, IN, BK, HD>(acc, dp, ks(s_), kplane, L.ldh, 0, Hp, nkg);
    }
    if constexpr (ST == 1) __syncthreads();
  }
  if (!active) return;

  T* dqp = dq + qo;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (j * 8 >= Hp) break;
    const float val[4] = {acc[j][0] * scale, acc[j][1] * scale, acc[j][2] * scale,
                          acc[j][3] * scale};
    store_acc<T>(dqp, ld, row0, Tq, j * 8 + 2 * t, H, val);
  }
}

// Byte offsets of (b)'s shared memory: the block's K and V rows, then per
// ring stage a q and a g tile, lse·log2 e and delta of its queries.
template <typename T>
struct KeysSmem {
  int ldh;
  size_t kv_bytes, q_bytes, stage, ring, total;
  __host__ __device__ KeysSmem(int Hp, int warps) {
    constexpr int IN = Cfg<T>::IN, BQ = Cfg<T>::BQ;
    ldh = Hp + 8;
    kv_bytes = align128(static_cast<size_t>(IN) * warps * 16 * ldh * 2);
    q_bytes = align128(static_cast<size_t>(IN) * BQ * ldh * 2);
    stage = 2 * q_bytes + align128(2 * BQ * 4);
    ring = 2 * kv_bytes;
    total = ring + Cfg<T>::STAGES * stage;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T>::WMAX * 32, (min_blocks<T, HD>()))
short_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int N, int Tq, int S, int H, int Hp, int vec, int key_blocks, float scale) {
  using C = Cfg<T>;
  constexpr int BQ = C::BQ, IN = C::IN, MID = C::MID, ST = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x, warps = nt >> 5;
  const KeysSmem<T> L(Hp, warps);
  const int tid = threadIdx.x, warp = tid >> 5, t = lane_t();
  const int pair = blockIdx.x / key_blocks, k0 = (blockIdx.x % key_blocks) * warps * 16;
  const long long ld = static_cast<long long>(N) * H;
  const size_t qo = pair_offset(pair, N, Tq, H), ko = pair_offset(pair, N, S, H);
  const float* lse_p = lse + static_cast<size_t>(pair) * Tq;
  const float* delta_p = delta + static_cast<size_t>(pair) * Tq;
  const int kvplane = warps * 16 * L.ldh, qplane = BQ * L.ldh, nkh = Hp / 16;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.kv_bytes);
  auto stage = [&](int s) { return smem + L.ring + s * L.stage; };
  auto qs = [&](int s) { return reinterpret_cast<bf16*>(stage(s)); };
  auto gs = [&](int s) { return reinterpret_cast<bf16*>(stage(s) + L.q_bytes); };
  auto stats = [&](int s) { return reinterpret_cast<float*>(stage(s) + 2 * L.q_bytes); };
  const int ntiles = (Tq + BQ - 1) / BQ;
  auto load_q = [&](int it) {  // query tile `it` into its ring stage, rows up to 16 past T
    const int q0 = it * BQ, s = it % ST, rows = groups16(q0, BQ, Tq) * 16;
    load_tile<T, IN>(qs(s), L.ldh, qplane, q + qo, ld, q0, rows, Tq, H, Hp, vec, tid, nt);
    load_tile<T, IN>(gs(s), L.ldh, qplane, g + qo, ld, q0, rows, Tq, H, Hp, vec, tid, nt);
    float* st = stats(s);  // lse·log2 e (1e30 past T: p = 0 there) and delta
    for (int r = tid; r < BQ; r += nt) {
      const bool ok = q0 + r < Tq;
      st[r] = ok ? lse_p[q0 + r] * kLog2e : 1e30f;
      st[BQ + r] = ok ? delta_p[q0 + r] : 0.0f;
    }
  };

  // every warp's 16 key rows, zero past S: a warp whose keys all lie past S
  // runs its products on zeros and stores nothing (a guard around them cost
  // the kernel 4 bytes of spills at 128 registers)
  load_tile<T, IN>(ks, L.ldh, kvplane, k + ko, ld, k0, warps * 16, S, H, Hp, vec, tid, nt);
  load_tile<T, IN>(vs, L.ldh, kvplane, v + ko, ld, k0, warps * 16, S, H, Hp, vec, tid, nt);
#pragma unroll
  for (int it = 0; it < ST - 1; ++it) {
    if (it < ntiles) load_q(it);
    cp_async_commit();
  }

  const float fac = scale * kLog2e;
  float dva[HD / 8][4], dka[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[j][e] = dka[j][e] = 0.0f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int s_ = it % ST;
    ring_step<ST>(it, ntiles, load_q);

    // sᵀ = k·qᵀ, then dpᵀ = v·gᵀ: 16 keys × the tile's queries up to 16 past T
    const int nqg = groups16(it * BQ, BQ, Tq);
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
    const bf16 *qt = qs(s_), *gt = gs(s_);
    scores_t<IN, BQ, HD>(s, ks, qt, kvplane, qplane, L.ldh, warp, nkh, nqg);
    scores_t<IN, BQ, HD>(dp, vs, gt, kvplane, qplane, L.ldh, warp, nkh, nqg);

    // pᵀ = e^(sᵀ·scale − lse) and dsᵀ = pᵀ·(dpᵀ − delta)
    const float* st = stats(s_);
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

    // dv += pᵀ·g, then dk += dsᵀ·q, pᵀ and dsᵀ from registers
    grad_step<MID, IN, BQ, HD>(dva, s, gt, qplane, L.ldh, 0, Hp, nqg);
    grad_step<MID, IN, BQ, HD>(dka, dp, qt, qplane, L.ldh, 0, Hp, nqg);
    if constexpr (ST == 1) __syncthreads();  // the one stage is refilled next
  }

  T* dkp = dk + ko;
  T* dvp = dv + ko;
  const int row0 = k0 + warp * 16 + lane_g();
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (j * 8 >= Hp) break;
    const float sk[4] = {dka[j][0] * scale, dka[j][1] * scale, dka[j][2] * scale,
                         dka[j][3] * scale};
    store_acc<T>(dvp, ld, row0, S, j * 8 + 2 * t, H, dva[j]);
    store_acc<T>(dkp, ld, row0, S, j * 8 + 2 * t, H, sk);
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                       void* dk, void* dv, float* lse, float* delta, int B, int N, int Tq, int S,
                       int H, int vec, float scale, cudaStream_t st) {
  const int Hp = round_up(H, 16);
  const long long pairs = static_cast<long long>(B) * N;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  const Split rows = split_rows(Tq, Cfg<T>::WMAX), keys = split_rows(S, Cfg<T>::WMAX);
  cudaError_t err = launch(short_bwd_rows_kernel<T, HD>, pairs * rows.blocks, rows.warps,
                           RowsSmem<T>(Hp, rows.warps).total, st, qt, kt, vt, gt,
                           static_cast<T*>(dq), lse, delta, N, Tq, S, H, Hp, vec, rows.blocks,
                           scale);
  if (err != cudaSuccess) return err;
  return launch(short_bwd_keys_kernel<T, HD>, pairs * keys.blocks, keys.warps,
                KeysSmem<T>(Hp, keys.warps).total, st, qt, kt, vt, gt,
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), N, Tq, S, H, Hp, vec, keys.blocks,
                scale);
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                       void* dk, void* dv, float* lse, float* delta, int B, int N, int Tq, int S,
                       int H, int vec, float scale, cudaStream_t st) {
  return round_up(H, 16) <= 64
             ? launch_bwd<T, 64>(q, k, v, g, dq, dk, dv, lse, delta, B, N, Tq, S, H, vec, scale,
                                 st)
             : launch_bwd<T, 128>(q, k, v, g, dq, dk, dv, lse, delta, B, N, Tq, S, H, vec, scale,
                                  st);
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
  // cp.async takes 16-byte rows: bf16, H a multiple of 8, 16-byte-aligned operands
  int vec = is_bf16 && H % 8 == 0;
  for (const void* p : {q, k, v, g}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<bf16>(q, k, v, g, dq, dk, dv, lse, delta, B, N, T, S, H, vec, scale, st)
              : launch_bwd<float>(q, k, v, g, dq, dk, dv, lse, delta, B, N, T, S, H, vec, scale,
                                  st);
  return static_cast<int>(err);
}
