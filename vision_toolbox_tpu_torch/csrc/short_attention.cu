// Short-sequence attention, forward (K2): per (batch·head) pair of the
// packed (B, T, N, H) q and (B, S, N, H) k and v,
//   out = softmax(q·kᵀ·scale)·v,   scale = H^-0.5,
// the logits, softmax and p in f32, p·v accumulated in f32, out rounded
// once to the input type and written in place.
//
// Replaces the TPU kernels vision_toolbox_tpu/ops/short_attention.py
// `_packed_attention_fwd` (`_packed_fwd_kernel`, heads split inside the
// kernel) and `_short_attention_fwd` (`_fwd_kernel`, on (B·N, T, H)): one
// function, so one kernel here, which reads the packed layout in place.
//
// What bounds it: at vit_b_16 bs128 (1536 pairs, T = S = 197, head 64,
// bf16) the products q·kᵀ and p·v are 15.3 GFLOP against 155 MB of q, k, v
// and out, so the bytes set the bound (0.046 ms at 3.35 TB/s). The products
// issued, with 16-row padding and p's two planes, are 25.5 GFLOP.
//
// Design (short_attention.cuh, attention_mma.cuh): one block per group of
// a pair's 16-row query tiles, one tile a warp (T = 197: two blocks of
// seven warps). The block's q rows are loaded once; K and V tiles of 64
// keys stream through a two-stage cp.async ring, one barrier a tile.
//  - s = q·kᵀ on the tensor cores into registers, over 16-key groups up to
//    the next multiple of 16 past S; keys ≥ S masked to −1e30.
//  - The softmax runs as K6's does: a running max and sum in registers,
//    reduced over the four threads of a row, p = e^(s·scale − m) in f32
//    (2^x on the special-function unit), the output accumulator rescaled
//    in registers, out = o / l at the end. The TPU kernel normalises before
//    the product (p = e / Σe over the whole row); the two differ by f32
//    rounding only, and the running form needs no whole f32 row on chip.
//  - o += p·v with p split into bf16 planes hi = bf16(p), lo = bf16(p − hi)
//    in registers and fed as A fragments (three planes for f32 inputs).
// The scale multiplies the f32 logits (the TPU kernel scales q first: the
// same value for a power-of-two scale, head 64; an f32 rounding otherwise).
#include "short_attention.cuh"

using namespace vtt_short;

namespace {

// Byte offsets of the forward's shared memory: the block's q rows, then per
// ring stage a K and a V tile.
template <typename T>
struct FwdSmem {
  int ldh;
  size_t kbytes, ring, total;
  __host__ __device__ FwdSmem(int Hp, int warps) {
    constexpr int IN = Cfg<T>::IN;
    ldh = Hp + 8;
    ring = align128(static_cast<size_t>(IN) * warps * 16 * ldh * 2);
    kbytes = align128(static_cast<size_t>(IN) * Cfg<T>::BK * ldh * 2);
    total = ring + Cfg<T>::STAGES * 2 * kbytes;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T>::WMAX * 32, (min_blocks<T, HD>()))
short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int N, int Tq, int S, int H, int Hp, int vec,
                 int row_blocks, float scale) {
  using C = Cfg<T>;
  constexpr int BK = C::BK, IN = C::IN, MID = C::MID, ST = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x, warps = nt >> 5;
  const FwdSmem<T> L(Hp, warps);
  const int tid = threadIdx.x, warp = tid >> 5, t = lane_t();
  const int pair = blockIdx.x / row_blocks, q0 = (blockIdx.x % row_blocks) * warps * 16;
  const long long ld = static_cast<long long>(N) * H;
  const T* kp = k + pair_offset(pair, N, S, H);
  const T* vp = v + pair_offset(pair, N, S, H);
  const int qplane = warps * 16 * L.ldh, kplane = BK * L.ldh, nkh = Hp / 16;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  auto ks = [&](int s) { return reinterpret_cast<bf16*>(smem + L.ring + 2 * s * L.kbytes); };
  auto vs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.ring + (2 * s + 1) * L.kbytes); };
  const int ntiles = (S + BK - 1) / BK;
  auto load_kv = [&](int it) {  // key tile `it` into its ring stage, rows up to 16 past S
    const int k0 = it * BK, s = it % ST, rows = groups16(k0, BK, S) * 16;
    load_tile<T, IN>(ks(s), L.ldh, kplane, kp, ld, k0, rows, S, H, Hp, vec, tid, nt);
    load_tile<T, IN>(vs(s), L.ldh, kplane, vp, ld, k0, rows, S, H, Hp, vec, tid, nt);
  };

  load_tile<T, IN>(qs, L.ldh, qplane, q + pair_offset(pair, N, Tq, H), ld, q0,
                   groups16(q0, warps * 16, Tq) * 16, Tq, H, Hp, vec, tid, nt);
#pragma unroll
  for (int it = 0; it < ST - 1; ++it) {  // the ring's first tiles, each its own group
    if (it < ntiles) load_kv(it);
    cp_async_commit();
  }

  const bool active = q0 + warp * 16 < Tq;  // the warp's tile holds a query row
  const float fac = scale * kLog2e;         // x·log2 e = s·fac
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // rows g, g + 8 (l: this thread's part)

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK, s_ = it % ST;
    ring_step<ST>(it, ntiles, load_kv);
    if (active) {
      const int nkg = groups16(k0, BK, S);
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      scores_t<IN, BK, HD>(s, qs, ks(s_), qplane, kplane, L.ldh, warp, nkh, nkg);

      // the running softmax: keys ≥ S (only in the last tile) masked; the max
      // over s, scaled once (scale > 0); p = 2^(s·fac − m·log2 e)
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
      float alpha[2], mb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]) * scale);
        alpha[h] = exp2_approx((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        mb[h] = m_new * kLog2e;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[j][e], fac, -mb[e >> 1]));
          s[j][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // o += p·v, p's planes from registers
      grad_step<MID, IN, BK, HD>(o, s, vs(s_), kplane, L.ldh, 0, Hp, nkg);
    }
    if constexpr (ST == 1) __syncthreads();  // the one stage is refilled next
  }
  if (!active) return;

  T* op = out + pair_offset(pair, N, Tq, H);
  const int row0 = q0 + warp * 16 + lane_g();
  const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (j * 8 >= Hp) break;
    const float val[4] = {o[j][0] / lt[0], o[j][1] / lt[0], o[j][2] / lt[1], o[j][3] / lt[1]};
    store_acc<T>(op, ld, row0, Tq, j * 8 + 2 * t, H, val);
  }
}

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, int B, int N,
                       int Tq, int S, int H, int vec, float scale, cudaStream_t st) {
  const int Hp = round_up(H, 16);
  const Split sp = split_rows(Tq, Cfg<T>::WMAX);
  return launch(short_fwd_kernel<T, HD>, static_cast<long long>(B) * N * sp.blocks, sp.warps,
                FwdSmem<T>(Hp, sp.warps).total, st, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), N, Tq,
                S, H, Hp, vec, sp.blocks, scale);
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, int B, int N,
                       int Tq, int S, int H, int vec, float scale, cudaStream_t st) {
  return round_up(H, 16) <= 64
             ? launch_fwd<T, 64>(q, k, v, out, B, N, Tq, S, H, vec, scale, st)
             : launch_fwd<T, 128>(q, k, v, out, B, N, Tq, S, H, vec, scale, st);
}

}  // namespace

extern "C" int vtt_short_attention_fwd(const void* q, const void* k, const void* v, int is_bf16,
                                       void* out, int B, int N, int T, int S, int H, float scale,
                                       void* stream) {
  if (B <= 0 || N <= 0 || T <= 0 || T > MAX_SEQ || S <= 0 || S > MAX_SEQ || H <= 0 ||
      H > MAX_WIDTH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // cp.async takes 16-byte rows: bf16, H a multiple of 8, 16-byte-aligned operands
  int vec = is_bf16 && H % 8 == 0;
  for (const void* p : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_fwd<bf16>(q, k, v, out, B, N, T, S, H, vec, scale, st)
                                  : launch_fwd<float>(q, k, v, out, B, N, T, S, H, vec, scale, st);
  return static_cast<int>(err);
}
