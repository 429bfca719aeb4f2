// Swin window attention, backward (K7): from q, k, v, pe, the mask and the output
// cotangent g, per window and head, with p recomputed,
//   dv = pᵀ·g,   dp = g·vᵀ,   ds = p ⊙ (dp − rowsum(dp ⊙ p)),
//   dq = (ds·k)·scale,   dk = dsᵀ·(q·scale),   dPE[h] = Σ_{batch, windows} ds,
// dq, dk, dv (B, nW, T, N·hd) in the input type, dPE (1, N, T, T) f32; every
// intermediate f32. The mask's cotangent is zero and is not computed here.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/swin_attention.py
// `_swin_attention_bwd` (`_bwd_kernel`), which walks the images in order and carries
// dPE in a VMEM scratch across its sequential grid. Here blocks run in parallel
// (swin_attention.cuh's blocks: one head, one window index, a run of images), each
// adding ds into its own (T, T) dPE partial, each element by one thread in image
// order; a second launch sums the blocks' partials in block order. No atomics: the
// same bits on every run. Two kernels, as in the forward (swin_attention.cu):
//  - the register tiles (bf16), per window-head, warp r on query rows (then keys)
//    16r..16r + 15. Windows of up to 64 tokens: (a) s = q·kᵀ and dp = g·vᵀ over all
//    keys at once, the logits with pe and the mask, the softmax of whole rows, p =
//    e / Σe, delta = Σ e·dp / Σe = Σ_s dp·p (the TPU kernel's own delta; out is
//    not saved), ds = p·(dp − delta), each thread's part of the dPE partial += ds
//    in registers, dq += ds·k with ds as two bf16 planes; p's and ds's planes go
//    to shared memory once (the exchange), and (b) dv = pᵀ·g and dk = dsᵀ·q read
//    them back transposed (ldmatrix .trans): 2 + 2 + 2 + 2 product units of 64 ×
//    64 × 32. Larger windows (window 14), whose planes do not fit: K2's passes. (a)
//    rows: sweep 1 keeps the running max m, Σe and Σ e·dp (rescaled as m grows),
//    so lse = m + log Σe and delta need no whole f32 row on chip; sweep 2 forms p
//    = e^(logit − lse), ds, the partial (in device memory) and dq; lse and delta
//    go to shared memory. (b) keys: sᵀ = k·qᵀ and dpᵀ = v·gᵀ recomputed over query
//    tiles, pᵀ and dsᵀ as A fragments, dv += pᵀ·g and dk += dsᵀ·q on two planes.
//  - the CUDA cores (f32, and bf16 windows the register tiles do not take): a row
//    pass, a warp per query row t (p and m, l (max, Σe) recomputed, dp, delta,
//    ds, dq), then a key pass, a warp per key s, lane j the rows j + 32i, that
//    recomputes p and ds bit for bit from the row pass's m, l and delta and sums
//    dk and dv over the rows in order: no (T, T) plane of p or ds is kept. The
//    dPE partial is a shared-memory plane where it fits beside the staged
//    operands, else in device memory.
//
// What bounds it: at swin_t stage 1, batch 128 (bf16), q, k, v, g in and dq, dk, dv
// out are 539 MB, 0.16 ms at 3.35 TB/s; its five products (q·kᵀ, g·vᵀ and the three
// gradients) are 19 GFLOP, 0.02 ms on the tensor cores. The register tiles issue
// 8 units of 64 × 64 × 32 a window-head: 52 GFLOP.
#include "swin_attention.cuh"

using namespace vtt_swin;
using vtt_mma::kLog2e;
using vtt_mma::kNegInf;

namespace {

constexpr int REDUCE_THREADS = 256;

// Backward on the register tiles: for each window-head of the block's run, (a)
// then (b), warp r on rows (then keys) 16r..16r + 15.
template <int HD, bool SMALL>
__global__ void __launch_bounds__(rt_threads<SMALL>(), (rt_min_blocks<SMALL, HD, true>()))
swin_bwd_rt_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const void* __restrict__ pe, int pe_bf16, const void* __restrict__ mask,
                   int mask_bf16, bf16* __restrict__ dq, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, float* __restrict__ partials, int B, int nW, int T_,
                   int D, int hd, int Hp, int per_block, int runs, int vec, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool masked = mask != nullptr;
  const RtSmem L(T_, Hp, SMALL, pe_bf16, masked, mask_bf16, true);
  const int tid = threadIdx.x, nt = blockDim.x, r = tid >> 5;
  const int t = vtt_mma::lane_t(), gq = vtt_mma::lane_g();
  const BlockJob job(D / hd, runs);
  const int h = job.h, w = job.w, run = job.run;
  const int b0 = run * per_block, n = min(B, b0 + per_block) - b0;
  const int nkh = Hp / 16;
  const size_t plane = static_cast<size_t>(T_) * T_;
  auto op = [&](int s, int i) { return reinterpret_cast<bf16*>(smem + (4 * s + i) * L.tile); };
  auto load = [&](int it) {  // window w of image b0 + it: q, k, v, g into its ring stage
    const size_t base = window_head(b0 + it, w, h, nW, T_, D, hd);
    const bf16* src[4] = {q + base, k + base, v + base, g + base};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      vtt_mma::load_tile<bf16, 1>(op(it % BWD_STAGES, i), L.ldh, 0, src[i], D, 0, L.tp, T_, hd,
                                  Hp, vec, tid, nt);
    }
  };
#pragma unroll
  for (int it = 0; it < BWD_STAGES - 1; ++it) {  // the ring's first tiles, each its own group
    if (it < n) load(it);
    vtt_mma::cp_async_commit();
  }

  const void* pe_h = static_cast<const char*>(pe) + h * plane * (pe_bf16 ? 2 : 4);
  const void* mask_w = masked ? static_cast<const char*>(mask) + w * plane * (mask_bf16 ? 2 : 4)
                              : nullptr;
  Table pe_t{pe_h, pe_bf16, T_}, mask_t{mask_w, mask_bf16, T_};
  float* own = partials + blockIdx.x * plane;  // (w·runs + run, h) of (nW·runs, N, T, T)
  if constexpr (SMALL) {  // once a block; the first ring step's barrier publishes them
    pe_t = stage_table(pe_h, pe_bf16, T_, smem + L.pe);
    if (masked) mask_t = stage_table(mask_w, mask_bf16, T_, smem + L.mask);
  } else {  // the partial in device memory, zeroed before the first ring step's barrier
    for (size_t i = tid; i < plane; i += nt) own[i] = 0.0f;
  }
  const int row0 = 16 * r + gq;  // this thread's rows (then keys): row0 and row0 + 8
  // Small windows: this thread's part of the block's dPE partial, in the
  // accumulator layout (in shared memory it cost a block an SM: 30% slower)
  float dpe[SMALL ? BK / 8 : 1][4] = {};

  for (int it = 0; it < n; ++it) {
    vtt_mma::ring_step<BWD_STAGES>(it, n, load);
    const int st = it % BWD_STAGES;
    const bf16 *qs = op(st, 0), *ks = op(st, 1), *vs = op(st, 2), *gs = op(st, 3);
    const size_t base = window_head(b0 + it, w, h, nW, T_, D, hd);
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

    if constexpr (SMALL) {
      // (a) all keys in one tile: s, dp, the softmax of whole rows, ds, dPE, dq;
      // p and ds to the exchange as two planes each
      bf16* xp = reinterpret_cast<bf16*>(smem + L.extra);
      const int xplane = L.tp * XP, nkg = groups16(0, BK, T_);
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
      vtt_mma::scores_t<1, BK, HD>(s, qs, ks, 0, 0, L.ldh, r, nkh, nkg);
      vtt_mma::scores_t<1, BK, HD>(dp, gs, vs, 0, 0, L.ldh, r, nkh, nkg);
      logits<true>(s, 0, row0, T_, scale, pe_t, mask_t, masked);
      float mx[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, d[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
      const float mb[2] = {vtt_mma::quad_max(mx[0]) * kLog2e, vtt_mma::quad_max(mx[1]) * kLog2e};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // e = exp(logit − max), 0 at keys ≥ T
          s[j][e] = vtt_mma::exp2_approx(fmaf(s[j][e], kLog2e, -mb[e >> 1]));
          l[e >> 1] += s[j][e];
          d[e >> 1] = fmaf(s[j][e], dp[j][e], d[e >> 1]);
        }
      }
      float inv[2], dl[2];  // 1 / Σe and delta = Σ e·dp / Σe = Σ_s dp·p
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float lt = vtt_mma::quad_sum(l[hh]);
        inv[hh] = 1.0f / lt;
        dl[hh] = vtt_mma::quad_sum(d[hh]) / lt;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int c = j * 8 + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float* pp = s[j] + 2 * hh;
          float* x = dp[j] + 2 * hh;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            pp[u] *= inv[hh];              // p = e / Σe
            x[u] = pp[u] * (x[u] - dl[hh]);  // ds, 0 at keys ≥ T and rows ≥ T
            dpe[j][2 * hh + u] += x[u];
          }
          uint32_t pw[2], dw[2];
          vtt_mma::split_pair<2>(pp[0], pp[1], pw);
          vtt_mma::split_pair<2>(x[0], x[1], dw);
          const int at = (row0 + 8 * hh) * XP + c;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            *reinterpret_cast<uint32_t*>(xp + i * xplane + at) = pw[i];
            *reinterpret_cast<uint32_t*>(xp + (2 + i) * xplane + at) = dw[i];
          }
        }
      }
      vtt_mma::grad_step<2, 1, BK, HD>(acc, dp, ks, 0, L.ldh, 0, Hp, nkg);  // dq += ds·k
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if (j * 8 >= Hp) break;
        const float val[4] = {acc[j][0] * scale, acc[j][1] * scale, acc[j][2] * scale,
                              acc[j][3] * scale};
        vtt_mma::store_acc<bf16>(dq + base, D, row0, T_, j * 8 + 2 * t, hd, val);
      }
      __syncthreads();  // the exchange is complete

      // (b) dv = pᵀ·g and dk = dsᵀ·q from the exchange, over the window's queries
      float dka[HD / 8][4];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = dka[j][e] = 0.0f;
      }
      exchange_step<HD>(acc, xp, xplane, 16 * r, gs, L.ldh, Hp, nkg);
      exchange_step<HD>(dka, xp + 2 * xplane, xplane, 16 * r, qs, L.ldh, Hp, nkg);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if (j * 8 >= Hp) break;
        const float sk[4] = {dka[j][0] * scale, dka[j][1] * scale, dka[j][2] * scale,
                             dka[j][3] * scale};
        vtt_mma::store_acc<bf16>(dv + base, D, row0, T_, j * 8 + 2 * t, hd, acc[j]);
        vtt_mma::store_acc<bf16>(dk + base, D, row0, T_, j * 8 + 2 * t, hd, sk);
      }
    } else {
      // the rows pass's key tile and the keys pass's query tile: the warp holds s
      // and dp (then sᵀ and dpᵀ) of a tile beside dq (then dk and dv); head 32
      // takes 16 to fit two blocks an SM (rt_min_blocks)
      constexpr int BKR = HD <= 32 ? 16 : 32, BQ = HD <= 32 || HD > 64 ? 16 : 32;
      float* lse2 = reinterpret_cast<float*>(smem + L.extra);  // per query row: lse·log2 e
      float* dlt = lse2 + stat_rows(T_);                        // and delta
      // (a) sweep 1: per row the running max m and this thread's part of Σe and Σ e·dp
      float s[BKR / 8][4], dp[BKR / 8][4];
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, d[2] = {0.0f, 0.0f};
      for (int k0 = 0; k0 < T_; k0 += BKR) {
        const int nkg = groups16(k0, BKR, T_);
#pragma unroll
        for (int j = 0; j < BKR / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
        }
        vtt_mma::scores_t<1, BKR, HD>(s, qs, ks + k0 * L.ldh, 0, 0, L.ldh, r, nkh, nkg);
        vtt_mma::scores_t<1, BKR, HD>(dp, gs, vs + k0 * L.ldh, 0, 0, L.ldh, r, nkh, nkg);
        logits<false>(s, k0, row0, T_, scale, pe_t, mask_t, masked);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < BKR / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
        float mb[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float m_new = fmaxf(m[hh], vtt_mma::quad_max(mx[hh]));
          const float alpha = vtt_mma::exp2_approx((m[hh] - m_new) * kLog2e);
          m[hh] = m_new;
          mb[hh] = m_new * kLog2e;
          l[hh] *= alpha;
          d[hh] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < BKR / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = vtt_mma::exp2_approx(fmaf(s[j][e], kLog2e, -mb[e >> 1]));
            l[e >> 1] += p;
            d[e >> 1] = fmaf(p, dp[j][e], d[e >> 1]);
          }
        }
      }
      // lse (as lse·log2 e) and delta of the rows, to shared memory for (b); rows
      // ≥ T get +1e30 and 0, so that their p is zero there
      float lb[2], dl[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float lt = vtt_mma::quad_sum(l[hh]);
        lb[hh] = (m[hh] + logf(lt)) * kLog2e;
        dl[hh] = vtt_mma::quad_sum(d[hh]) / lt;
        const int row = row0 + 8 * hh;
        if (t == 0) {
          lse2[row] = row < T_ ? lb[hh] : 1e30f;
          dlt[row] = row < T_ ? dl[hh] : 0.0f;
        }
      }
      // (a) sweep 2: p, ds = p·(dp − delta), the dPE partial, dq += ds·k
      for (int k0 = 0; k0 < T_; k0 += BKR) {
        const int nkg = groups16(k0, BKR, T_);
#pragma unroll
        for (int j = 0; j < BKR / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
        }
        vtt_mma::scores_t<1, BKR, HD>(s, qs, ks + k0 * L.ldh, 0, 0, L.ldh, r, nkh, nkg);
        vtt_mma::scores_t<1, BKR, HD>(dp, gs, vs + k0 * L.ldh, 0, 0, L.ldh, r, nkh, nkg);
        logits<false>(s, k0, row0, T_, scale, pe_t, mask_t, masked);
#pragma unroll
        for (int j = 0; j < BKR / 8; ++j) {
          const int c = k0 + j * 8 + 2 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float* x = dp[j] + 2 * hh;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float p = vtt_mma::exp2_approx(fmaf(s[j][2 * hh + u], kLog2e, -lb[hh]));
              x[u] = p * (x[u] - dl[hh]);  // keys ≥ T: p = 0
            }
            const int row = row0 + 8 * hh;
            if (row < T_) {
              float* at = own + static_cast<size_t>(row) * T_ + c;
              if (c < T_) at[0] += x[0];
              if (c + 1 < T_) at[1] += x[1];
            }
          }
        }
        vtt_mma::grad_step<2, 1, BKR, HD>(acc, dp, ks + k0 * L.ldh, 0, L.ldh, 0, Hp, nkg);
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if (j * 8 >= Hp) break;
        const float val[4] = {acc[j][0] * scale, acc[j][1] * scale, acc[j][2] * scale,
                              acc[j][3] * scale};
        vtt_mma::store_acc<bf16>(dq + base, D, row0, T_, j * 8 + 2 * t, hd, val);
      }
      __syncthreads();  // every row's lse and delta are in

      // (b) the keys pass: sᵀ = k·qᵀ, dpᵀ = v·gᵀ over query tiles, dv += pᵀ·g,
      // dk += dsᵀ·q
      float dka[HD / 8][4];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = dka[j][e] = 0.0f;
      }
      for (int q0 = 0; q0 < T_; q0 += BQ) {
        const int nqg = groups16(q0, BQ, T_);
        float sq[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sq[j][e] = dpt[j][e] = 0.0f;
        }
        vtt_mma::scores_t<1, BQ, HD>(sq, ks, qs + q0 * L.ldh, 0, 0, L.ldh, r, nkh, nqg);
        vtt_mma::scores_t<1, BQ, HD>(dpt, vs, gs + q0 * L.ldh, 0, 0, L.ldh, r, nkh, nqg);
        logits_t(sq, q0, row0, T_, scale, pe_t, mask_t, masked);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = q0 + j * 8 + 2 * t + (e & 1);
            const float p = vtt_mma::exp2_approx(fmaf(sq[j][e], kLog2e, -lse2[qc]));
            sq[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - dlt[qc]);
          }
        }
        vtt_mma::grad_step<2, 1, BQ, HD>(acc, sq, gs + q0 * L.ldh, 0, L.ldh, 0, Hp, nqg);
        vtt_mma::grad_step<2, 1, BQ, HD>(dka, dpt, qs + q0 * L.ldh, 0, L.ldh, 0, Hp, nqg);
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if (j * 8 >= Hp) break;
        const float sk[4] = {dka[j][0] * scale, dka[j][1] * scale, dka[j][2] * scale,
                             dka[j][3] * scale};
        vtt_mma::store_acc<bf16>(dv + base, D, row0, T_, j * 8 + 2 * t, hd, acc[j]);
        vtt_mma::store_acc<bf16>(dk + base, D, row0, T_, j * 8 + 2 * t, hd, sk);
      }
    }
    if constexpr (BWD_STAGES == 1) __syncthreads();  // the one stage is refilled next
  }
  if constexpr (SMALL) {  // this thread's part of the block's T × T partial
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1), c = j * 8 + 2 * t + (e & 1);
        if (row < T_ && c < T_) own[static_cast<size_t>(row) * T_ + c] = dpe[j][e];
      }
    }
  }
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(NT)
swin_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ g, const void* __restrict__ pe, int pe_bf16,
                const void* __restrict__ mask, int mask_bf16, T* __restrict__ dq,
                T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ partials, int B,
                int nW, int T_, int D, int hd, int per_block, int runs, float scale,
                int plane_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, N = gridDim.y, w = blockIdx.x / runs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pitch = stage_pitch<T>(hd);
  const size_t op_bytes = staged_bytes<T>(1, T_, hd), plane = static_cast<size_t>(T_) * T_;
  // this warp's rows: two of T (score gradients, probabilities), two of hd
  float* wrow = reinterpret_cast<float*>(smem) + warp * warp_row_floats(2, 2, T_, hd);
  float* prow = wrow + pad4(T_);
  float* hrow0 = prow + pad4(T_);  // q·scale (row pass) or k (key pass)
  float* hrow1 = hrow0 + pad4(hd);  // g (row pass) or v (key pass)
  unsigned char* ops = smem + warp_rows_bytes(2, 2, T_, hd);
  unsigned char* rest = ops + (STAGED ? 4 * op_bytes : 0);
  float* row_m = reinterpret_cast<float*>(rest);  // per query row: max, Σe, delta
  float* row_l = row_m + T_;
  float* row_delta = row_l + T_;
  float* own = partials + (static_cast<size_t>(blockIdx.x) * N + h) * plane;
  float* dpe = plane_in_smem ? reinterpret_cast<float*>(rest + align16(3 * T_ * sizeof(float)))
                             : own;
  for (size_t i = threadIdx.x; i < plane; i += NT) dpe[i] = 0.0f;
  const size_t pe_base = static_cast<size_t>(h) * plane;
  const size_t mask_base = static_cast<size_t>(w) * plane;
  const int b0 = blockIdx.x % runs * per_block, b1 = min(B, b0 + per_block);

  for (int b = b0; b < b1; ++b) {
    const size_t base = window_head(b, w, h, nW, T_, D, hd);
    View<T> Q{q + base, D}, K{k + base, D}, V{v + base, D}, G{g + base, D};
    __syncthreads();  // the last window's key pass is done with the stats and operands
    if constexpr (STAGED) {
      T* s0 = reinterpret_cast<T*>(ops);
      T* s1 = reinterpret_cast<T*>(ops + op_bytes);
      T* s2 = reinterpret_cast<T*>(ops + 2 * op_bytes);
      T* s3 = reinterpret_cast<T*>(ops + 3 * op_bytes);
      stage(q + base, T_, D, hd, s0, pitch);
      stage(k + base, T_, D, hd, s1, pitch);
      stage(v + base, T_, D, hd, s2, pitch);
      stage(g + base, T_, D, hd, s3, pitch);
      __syncthreads();
      Q = View<T>{s0, pitch};
      K = View<T>{s1, pitch};
      V = View<T>{s2, pitch};
      G = View<T>{s3, pitch};
    }

    // row pass: dq, the row statistics and the dPE partial
    for (int t = warp; t < T_; t += NW) {
      float p[SLOTS], ds[SLOTS], m, l;
      head_row(Q, t, hd, scale, hrow0);
      head_row(G, t, hd, 1.0f, hrow1);
      logits_row(hrow0, K, t, T_, hd, pe, pe_bf16, pe_base, mask, mask_bf16, mask_base, p);
      softmax_row(p, T_, m, l);
      dots(hrow1, V, T_, hd, 1.0f, ds);  // dp = g·vᵀ
      float pdp = 0.0f;
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) pdp += ds[i] * p[i];
      const float delta = warp_sum(pdp);
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int s = lane + 32 * i;
        ds[i] = p[i] * (ds[i] - delta);
        if (s < T_) dpe[static_cast<size_t>(t) * T_ + s] += ds[i];
      }
      float acc[DSLOTS] = {};
      put_row(ds, T_, wrow);
      weighted_rows(wrow, K, T_, hd, 1.0f, acc);
#pragma unroll
      for (int j = 0; j < DSLOTS; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) dq[base + static_cast<size_t>(t) * D + d] = from_f32<T>(acc[j] * scale);
      }
      if (lane == 0) {
        row_m[t] = m;
        row_l[t] = l;
        row_delta[t] = delta;
      }
    }
    __syncthreads();

    // key pass: dk and dv, summed over the query rows in order
    for (int s = warp; s < T_; s += NW) {
      float p[SLOTS], ds[SLOTS];
      head_row(K, s, hd, 1.0f, hrow0);
      head_row(V, s, hd, 1.0f, hrow1);
      dots(hrow0, Q, T_, hd, scale, p);  // (q·scale)·k, the row pass's logits
      dots(hrow1, G, T_, hd, 1.0f, ds);  // g·v, the row pass's dp
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int t = lane + 32 * i;
        if (t < T_) {
          const size_t at = static_cast<size_t>(t) * T_ + s;
          const float x = add_bias(p[i], pe, pe_bf16, mask, mask_bf16, pe_base + at,
                                   mask_base + at);
          p[i] = expf(x - row_m[t]) / row_l[t];
          ds[i] = p[i] * (ds[i] - row_delta[t]);
        }
      }
      float acc_k[DSLOTS] = {}, acc_v[DSLOTS] = {};
      put_row(ds, T_, wrow);
      put_row(p, T_, prow);
      weighted_rows(wrow, Q, T_, hd, scale, acc_k);
      weighted_rows(prow, G, T_, hd, 1.0f, acc_v);
#pragma unroll
      for (int j = 0; j < DSLOTS; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) {
          const size_t at = base + static_cast<size_t>(s) * D + d;
          dk[at] = from_f32<T>(acc_k[j]);
          dv[at] = from_f32<T>(acc_v[j]);
        }
      }
    }
  }
  if (plane_in_smem) {
    __syncthreads();
    for (size_t i = threadIdx.x; i < plane; i += NT) own[i] = dpe[i];
  }
}

// dpe[i] = Σ_b partials[b][i] over the n blocks, in block order; one thread per value.
__global__ void __launch_bounds__(REDUCE_THREADS)
dpe_reduce_kernel(const float* __restrict__ partials, int n, size_t per, float* __restrict__ dpe) {
  const size_t i = blockIdx.x * static_cast<size_t>(REDUCE_THREADS) + threadIdx.x;
  if (i >= per) return;
  float acc = 0.0f;
  for (int b = 0; b < n; ++b) acc += partials[b * per + i];
  dpe[i] = acc;
}

template <int HD, bool SMALL>
cudaError_t launch_rt_width(const void* q, const void* k, const void* v, const void* g,
                            const void* pe, int pe_bf16, const void* mask, int mask_bf16, void* dq,
                            void* dk, void* dv, float* partials, int B, int nW, int T_, int N,
                            int hd, int per_block, int runs, int vec, float scale,
                            cudaStream_t st) {
  const int Hp = vtt_mma::round_up(hd, 16);
  const RtSmem L(T_, Hp, SMALL, pe_bf16, mask != nullptr, mask_bf16, true);
  return rt_launch(swin_bwd_rt_kernel<HD, SMALL>, nW * runs, N, L.tp / 16, L.total, st,
                   static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(g), pe, pe_bf16, mask,
                   mask_bf16, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), partials, B, nW, T_, N * hd, hd, Hp, per_block, runs,
                   vec, scale);
}

template <bool SMALL>
cudaError_t launch_rt(const void* q, const void* k, const void* v, const void* g, const void* pe,
                      int pe_bf16, const void* mask, int mask_bf16, void* dq, void* dk, void* dv,
                      float* partials, int B, int nW, int T_, int N, int hd, int per_block,
                      int runs, int vec, float scale, cudaStream_t st) {
  const int Hp = vtt_mma::round_up(hd, 16);
  auto fn = Hp <= 32   ? launch_rt_width<32, SMALL>
            : Hp <= 64 ? launch_rt_width<64, SMALL>
                       : launch_rt_width<128, SMALL>;
  return fn(q, k, v, g, pe, pe_bf16, mask, mask_bf16, dq, dk, dv, partials, B, nW, T_, N, hd,
            per_block, runs, vec, scale, st);
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* g, const void* pe,
                        int pe_bf16, const void* mask, int mask_bf16, void* dq, void* dk,
                        void* dv, float* partials, int B, int nW, int T_, int N, int hd,
                        int per_block, int runs, float scale, cudaStream_t st) {
  const size_t ops = staged_bytes<T>(4, T_, hd), stats = align16(3 * T_ * sizeof(float));
  const size_t plane = static_cast<size_t>(T_) * T_ * sizeof(float);
  const size_t rows = warp_rows_bytes(2, 2, T_, hd);
  const bool staged = rows + ops + stats <= kMaxSmem;
  const size_t base = rows + (staged ? ops : 0) + stats;
  const int plane_in_smem = base + plane <= kMaxSmem;
  const size_t dyn = base + (plane_in_smem ? plane : 0);
  auto kernel = staged ? swin_bwd_kernel<T, true> : swin_bwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nW * runs, N), NT, dyn, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), pe, pe_bf16, mask, mask_bf16, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), partials, B, nW, T_, N * hd, hd, per_block, runs,
      scale, plane_in_smem);
  return cudaGetLastError();
}

}  // namespace

// As vtt_swin_attention_fwd, with the cotangent g like q; dq, dk, dv like q; scratch
// `partials` (nW·⌈B / per_block⌉, N, T, T) f32 from the caller, one plane a block;
// dpe (N, T, T) f32.
extern "C" int vtt_swin_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                      const void* pe, int pe_bf16, const void* mask,
                                      int mask_bf16, int is_bf16, void* dq, void* dk, void* dv,
                                      float* partials, float* dpe, int B, int nW, int T, int N,
                                      int hd, int per_block, float scale, void* stream) {
  if (B < 1 || nW < 1 || T < 1 || T > MAX_SEQ || N < 1 || N > 65535 || hd < 1 ||
      hd > MAX_HEAD || per_block < 1 || static_cast<long long>(B) * nW > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int runs = (B + per_block - 1) / per_block;
  if (static_cast<long long>(nW) * runs > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = nW * runs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Route route = swin_route(T, hd, is_bf16, pe_bf16, mask != nullptr, mask_bf16, true);
  cudaError_t err;
  if (route != ROUTE_CORES) {
    // cp.async takes 16-byte rows: heads a multiple of 8, 16-byte-aligned operands
    int vec = hd % 8 == 0 && (N * hd) % 8 == 0;
    for (const void* p : {q, k, v, g}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    auto fn = route == ROUTE_SMALL ? launch_rt<true> : launch_rt<false>;
    err = fn(q, k, v, g, pe, pe_bf16, mask, mask_bf16, dq, dk, dv, partials, B, nW, T, N, hd,
             per_block, runs, vec, scale, st);
  } else {
    auto fn = is_bf16 ? launch_simt<bf16> : launch_simt<float>;
    err = fn(q, k, v, g, pe, pe_bf16, mask, mask_bf16, dq, dk, dv, partials, B, nW, T, N, hd,
             per_block, runs, scale, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t per = static_cast<size_t>(N) * T * T;
  dpe_reduce_kernel<<<static_cast<unsigned>((per + REDUCE_THREADS - 1) / REDUCE_THREADS),
                      REDUCE_THREADS, 0, st>>>(partials, blocks, per, dpe);
  return static_cast<int>(cudaGetLastError());
}
