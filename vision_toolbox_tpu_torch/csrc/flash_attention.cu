// Flash attention, forward (K6): per (batch·head) pair of q (B, T, N, H)
// and k, v (B, S, N, H), read in place with their strides,
//   out = softmax(q·kᵀ·scale + bias)·v,   lse = logsumexp of each logit row,
// bias (B·N, T, S) or none; out (B, T, N, H) in the input type, lse
// (B·N, T) f32 for the backward (flash_attention_bwd.cu). The flat
// (B·N, T, H) layout is the case N = 1.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/flash_attention.py
// `_flash_fwd` (`_flash_fwd_kernel`).
//
// What bounds it: at siglip vit_b_16 batch 32 (T = S = 1024, 12 heads of
// 64, bf16) the products q·kᵀ and p·v are 103 GFLOP against 201 MB of
// operands, so the tensor cores set the bound (0.104 ms at 989 TFLOP/s).
//
// Design (attention_mma.cuh): one block per (128 query rows, pair, ≤ 128
// output columns): eight warps of 16 rows, whose scores (16 × 64 keys) and
// 64-wide output accumulator take 32 f32 registers each, so two head-64
// blocks share an SM; or, for the unbiased head-64 kernel, four warps of
// 32 rows (two m16 tiles a warp share every K and V fragment read from
// shared memory; three blocks an SM). The kernels are latency-bound: with
// eight warps of 16 rows at one block an SM (more registers, fewer warps)
// the head-64 forward ran 1.56× slower (scripts/tune_flash_attention.py,
// SigLIP b32, H100).
//  - The q tile is loaded once (with 16 rows a warp at head ≤ 64 its
//    fragments then stay in registers); K and V tiles of 64 keys stream
//    through a two-stage cp.async ring, the next tile's copy in flight
//    while this one's products run, one barrier a tile. Tiles are
//    zero-padded to the head's next multiple of 16 in shared memory; rows
//    past T or S read as zero.
//  - s = q·kᵀ on the tensor cores (mma.sync m16n8k16) into registers;
//    logits = s·scale (+ bias, read into the accumulator layout) in f32,
//    keys ≥ S masked to −1e30; the running max and sum stay in registers,
//    the max reduced over the four threads of a row; p = exp(logits − m)
//    in f32 (as 2^(·log2 e) on the special-function unit: one fma and one
//    ex2 an element in place of expf's longer sequence), the output
//    accumulator rescaled by e^(m_old − m) in registers.
//  - o += p·v with p fed from registers as A fragments: its accumulator
//    layout is the A layout. The output accumulator stays in registers.
//  - out = o / l rounded once and written in place; lse = m + log l.
// Planes (exact operands, attention_mma.cuh): bf16 inputs — q·kᵀ one plane
// each (one mma), p·v with p as two planes hi = bf16(p), lo = bf16(p − hi)
// split in registers (two mmas), so p is never rounded to bf16 once; f32
// inputs — q, k, v three planes in shared memory, p three in registers
// (six mmas per product). Heads above 128: the output's 128-wide column
// chunk is on grid z, and each chunk's block computes the scores over the
// whole head again. The scale multiplies the f32 logits (the TPU kernel
// scales q first: the same value for a power-of-two scale, head 64; an f32
// rounding otherwise).
#include <initializer_list>

#include "attention_mma.cuh"

using namespace vtt_mma;

namespace {

constexpr int MAX_HEAD_DIM = 256;  // the widest head
constexpr int CHUNK = 128;         // output columns of a block

// Per input type: query rows and keys of a tile, ring stages, bf16 planes
// of an input operand and of p.
template <typename T>
struct Fwd;
template <>
struct Fwd<bf16> {
  static constexpr int BQ = 128, BK = 64, STAGES = 2, IN = 1, MID = 2;
};
template <>
struct Fwd<float> {  // three planes of q, k and v: smaller tiles
  static constexpr int BQ = 64, BK = 32, STAGES = 1, IN = 3, MID = 3;
};

// m16 tiles of query rows a warp owns, and blocks an SM is to hold (the
// register budget). HD: the head class (the padded head is at most HD):
// 64, 128 or 256. The unbiased bf16 head-64 kernel (SigLIP's) runs four
// warps of 32 rows: each K and V fragment read from shared memory serves
// two m-tiles, and at 168 registers three blocks share an SM (0.662 ms
// against 0.751 for eight warps of 16 rows at two blocks an SM, SigLIP b32,
// H100, scripts/tune_flash_attention.py); wider heads and the biased
// kernel run eight warps of 16 rows (two m-tiles were slower at head 256
// and spilled in the biased kernel).
template <typename T, int HD, bool BIAS>
__host__ __device__ constexpr int fwd_mt() {
  return std::is_same<T, bf16>::value && HD == 64 && !BIAS ? 2 : 1;
}
template <typename T, int HD, bool BIAS>
__host__ __device__ constexpr int fwd_warps() {
  return Fwd<T>::BQ / (16 * fwd_mt<T, HD, BIAS>());
}
template <typename T, int HD, bool BIAS>
__host__ __device__ constexpr int fwd_min_blocks() {
  return fwd_mt<T, HD, BIAS>() == 2 ? 3 : std::is_same<T, bf16>::value && HD == 64 ? 2 : 1;
}

struct FwdArgs {
  const void *q, *k, *v, *bias;
  void* out;
  float* lse;            // null: inference
  long long st[4][3];    // (batch, row, head) element strides of q, k, v, out
  int N, T, S, H, Hp;    // Hp: H rounded up to 16
  int bias_bf16, vec;    // vec: q, k, v rows are 16-byte aligned bf16 (cp.async)
  float scale;
};

// Byte offsets of the forward's shared memory: the q tile, then STAGES
// K/V tiles (K over the whole head, V over the block's column chunk).
template <typename T>
struct FwdSmem {
  int ldh, ldv;
  size_t kbytes, stage, kv, total;
  __host__ __device__ explicit FwdSmem(int Hp) {
    constexpr int BQ = Fwd<T>::BQ, BK = Fwd<T>::BK, IN = Fwd<T>::IN;
    ldh = Hp + 8;
    ldv = (Hp < CHUNK ? Hp : CHUNK) + 8;
    kv = align128(static_cast<size_t>(IN) * BQ * ldh * 2);
    kbytes = align128(static_cast<size_t>(IN) * BK * ldh * 2);
    stage = kbytes + align128(static_cast<size_t>(IN) * BK * ldv * 2);
    total = kv + Fwd<T>::STAGES * stage;
  }
};

template <typename T, int HD, bool BIAS>
__global__ void __launch_bounds__(fwd_warps<T, HD, BIAS>() * 32, (fwd_min_blocks<T, HD, BIAS>()))
flash_fwd_kernel(const FwdArgs a) {
  using C = Fwd<T>;
  constexpr int MT = fwd_mt<T, HD, BIAS>(), NT = fwd_warps<T, HD, BIAS>() * 32, BQ = C::BQ,
                BK = C::BK, IN = C::IN, MID = C::MID, ST = C::STAGES;
  constexpr int HC = HD < CHUNK ? HD : CHUNK;          // the widest output chunk
  constexpr bool QREG = IN == 1 && HD == 64 && MT == 1;  // q fragments held in registers
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem<T> L(a.Hp);
  const int tid = threadIdx.x, warp = tid >> 5, t = lane_t();
  const int q0 = blockIdx.x * BQ, pair = blockIdx.y;
  const int c0 = blockIdx.z * CHUNK, hc = min(CHUNK, a.Hp - c0);
  const int nkh = a.Hp / 16;  // 16-deep steps of q·kᵀ
  const T* qp = Mat<const T>{static_cast<const T*>(a.q), a.st[0][0], a.st[0][1], a.st[0][2]}
                    .pair(pair, a.N);
  const T* kp = Mat<const T>{static_cast<const T*>(a.k), a.st[1][0], a.st[1][1], a.st[1][2]}
                    .pair(pair, a.N);
  const T* vp = Mat<const T>{static_cast<const T*>(a.v), a.st[2][0], a.st[2][1], a.st[2][2]}
                    .pair(pair, a.N);
  T* op = Mat<T>{static_cast<T*>(a.out), a.st[3][0], a.st[3][1], a.st[3][2]}.pair(pair, a.N);
  const int qplane = BQ * L.ldh, kplane = BK * L.ldh, vplane = BK * L.ldv;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  auto ks = [&](int s) { return reinterpret_cast<bf16*>(smem + L.kv + s * L.stage); };
  auto vs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.kv + s * L.stage + L.kbytes); };
  const int ntiles = (a.S + BK - 1) / BK;
  auto load_kv = [&](int it) {  // key tile `it` into its ring stage
    const int k0 = it * BK, s = it % ST;
    load_tile<T, IN>(ks(s), L.ldh, kplane, kp, a.st[1][1], k0, BK, a.S, a.H, a.Hp, a.vec, tid, NT);
    load_tile<T, IN>(vs(s), L.ldv, vplane, vp + c0, a.st[2][1], k0, BK, a.S, a.H - c0, hc, a.vec,
                     tid, NT);
  };

  load_tile<T, IN>(qs, L.ldh, qplane, qp, a.st[0][1], q0, BQ, a.T, a.H, a.Hp, a.vec, tid, NT);
#pragma unroll
  for (int it = 0; it < ST - 1; ++it) {  // the ring's first tiles, each its own group
    if (it < ntiles) load_kv(it);
    cp_async_commit();
  }

  float o[MT][HC / 8][4];
  float m[MT][2], l[MT][2];  // rows g and g + 8 of each m-tile (l: this thread's part)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.0f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.0f;
  }
  uint32_t qf[QREG ? HD / 16 : 1][4];
  const int wrow = warp * 16 * MT;  // the warp's first row in the tile
  const int row0 = q0 + wrow + lane_g();

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK, s_ = it % ST;
    ring_step<ST>(it, ntiles, load_kv);
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          if (kk < nkh) ldsm_x4<false>(qf[kk], qs, L.ldh, wrow, kk * 16);
        }
      }
    }

    // s = q·kᵀ over the whole head; each K fragment serves the warp's MT m-tiles
    float s[MT][BK / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.0f;
    }
    const bf16* kt = ks(s_);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      if (kk >= nkh) break;
      uint32_t af[MT][IN][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (QREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) af[mt][0][r] = qf[kk][r];
        } else {
#pragma unroll
          for (int i = 0; i < IN; ++i) {
            ldsm_x4<false>(af[mt][i], qs + i * qplane, L.ldh, wrow + mt * 16, kk * 16);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) {
        uint32_t bfr[IN][4];
#pragma unroll
        for (int i = 0; i < IN; ++i) ldsm_b_nk(bfr[i], kt + i * kplane, L.ldh, jj * 16, kk * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_planes2<IN, IN>(s[mt][2 * jj], s[mt][2 * jj + 1], af[mt], bfr);
        }
      }
    }

    // the running softmax, in registers: logits x = s·scale (+ bias) in f32,
    // keys ≥ S (only in the last tile) masked to −1e30, p = e^(x − m) as
    // 2^(x·log2 e − m·log2 e); without a bias the max is taken over s and
    // scaled once (scale > 0), and x·log2 e is s·(scale·log2 e)
    const bool tail = k0 + BK > a.S;
    const float fac = BIAS ? kLog2e : a.scale * kLog2e;  // x·log2 e = s·fac
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = row0 + mt * 16;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1), h = e >> 1;
          float x = s[mt][j][e];
          if constexpr (BIAS) {
            x *= a.scale;
            if (r0 + 8 * h < a.T && col < a.S) {
              const size_t o_ = (static_cast<size_t>(pair) * a.T + r0 + 8 * h) * a.S + col;
              x += a.bias_bf16 ? __bfloat162float(static_cast<const bf16*>(a.bias)[o_])
                               : static_cast<const float*>(a.bias)[o_];
            }
          }
          if (tail && col >= a.S) x = kNegInf;
          s[mt][j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
      float alpha[2], mb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[mt][h], BIAS ? quad_max(mx[h]) : quad_max(mx[h]) * a.scale);
        alpha[h] = exp2_approx((m[mt][h] - m_new) * kLog2e);
        m[mt][h] = m_new;
        mb[h] = m_new * kLog2e;
        l[mt][h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[mt][j][e], fac, -mb[e >> 1]));
          s[mt][j][e] = p;
          l[mt][e >> 1] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        o[mt][j][0] *= alpha[0];
        o[mt][j][1] *= alpha[0];
        o[mt][j][2] *= alpha[1];
        o[mt][j][3] *= alpha[1];
      }
    }

    // o += p·v over the chunk's columns, p's planes from registers; each V
    // fragment serves the warp's MT m-tiles
    const bf16* vt = vs(s_);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][MID][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) acc_to_a<MID>(s[mt][2 * kk], s[mt][2 * kk + 1], pa[mt]);
#pragma unroll
      for (int nn = 0; nn < HC / 16; ++nn) {
        if (nn * 16 >= hc) break;
        uint32_t bfr[IN][4];
#pragma unroll
        for (int i = 0; i < IN; ++i) {
          ldsm_x4<true>(bfr[i], vt + i * vplane, L.ldv, kk * 16, nn * 16);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_planes2<MID, IN>(o[mt][2 * nn], o[mt][2 * nn + 1], pa[mt], bfr);
        }
      }
    }
    if constexpr (ST == 1) __syncthreads();  // the one stage is refilled next
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = row0 + mt * 16;
    float lt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) lt[h] = quad_sum(l[mt][h]);
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) {
      if (j * 8 >= hc) break;
      const float val[4] = {o[mt][j][0] / lt[0], o[mt][j][1] / lt[0], o[mt][j][2] / lt[1],
                            o[mt][j][3] / lt[1]};
      store_acc<T>(op + c0, a.st[3][1], r0, a.T, j * 8 + 2 * t, a.H - c0, val);
    }
    if (a.lse != nullptr && blockIdx.z == 0 && t == 0) {  // every chunk has the same statistics
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r0 + 8 * h < a.T) a.lse[static_cast<size_t>(pair) * a.T + r0 + 8 * h] =
            m[mt][h] + logf(lt[h]);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch_fwd(const FwdArgs& a, int pairs, cudaStream_t st) {
  const FwdSmem<T> L(a.Hp);
  const dim3 grid((a.T + Fwd<T>::BQ - 1) / Fwd<T>::BQ, pairs, (a.Hp + CHUNK - 1) / CHUNK);
  auto run = [&](auto kernel, int threads) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(L.total));
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, L.total, st>>>(a);
    return cudaGetLastError();
  };
  return a.bias != nullptr
             ? run(flash_fwd_kernel<T, HD, true>, fwd_warps<T, HD, true>() * 32)
             : run(flash_fwd_kernel<T, HD, false>, fwd_warps<T, HD, false>() * 32);
}

template <typename T>
cudaError_t launch_fwd(const FwdArgs& a, int pairs, cudaStream_t st) {
  if (a.Hp <= 64) return launch_fwd<T, 64>(a, pairs, st);
  if (a.Hp <= 128) return launch_fwd<T, 128>(a, pairs, st);
  return launch_fwd<T, 256>(a, pairs, st);
}

}  // namespace

// strides: (batch, row, head) element strides of q, k, v and out, twelve values.
extern "C" int vtt_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                             int bias_bf16, int is_bf16, void* out, float* lse,
                             const long long* strides, int B, int N, int T, int S, int H,
                             float scale, void* stream) {
  if (B <= 0 || N <= 0 || static_cast<long long>(B) * N > 65535 || T <= 0 || S <= 0 || H < 1 ||
      H > MAX_HEAD_DIM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs a{q, k, v, bias, out, lse, {}, N, T, S, H, round_up(H, 16), bias_bf16, 0, scale};
  bool aligned = is_bf16 && H % 8 == 0;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) {
      a.st[i][j] = strides[3 * i + j];
      if (i < 3 && a.st[i][j] % 8 != 0) aligned = false;
    }
  }
  for (const void* p : {q, k, v}) aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  a.vec = aligned;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<bf16>(a, B * N, st) : launch_fwd<float>(a, B * N, st);
  return static_cast<int>(err);
}
