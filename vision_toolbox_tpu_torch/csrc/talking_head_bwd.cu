// CaiT talking-head attention, backward (K5): from q, k, v, the mixes and
// dout, recompute the forward and return dq, dk, dv (in the input type) and
// the four mix-parameter gradients dml, dmlb, dmw, dmwb (f32, summed over
// the batch):
//   dv_g    = pw_gᵀ·do_g               dmixw_g = do_g·v_gᵀ
//   dmw     = Σ dmixw_g·p_h            dmwb_g  = Σ dmixw_g
//   dp_h    = Σ_g mw[g][h]·dmixw_g     dmixl_h = p_h·(dp_h − delta_h),
//                                      delta_h = rowsum(dp_h·p_h)
//   dml     = Σ dmixl_g·raw_h          dmlb_g  = Σ dmixl_g
//   draw_h  = Σ_g ml[g][h]·dmixl_g
//   dq_h    = (draw_h·k_h)·scale       dk_h    = (draw_hᵀ·q_h)·scale
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/cait_attention.py `_th_bwd`
// (`_bwd_kernel`). On the TPU one grid program holds an image's whole
// (H, T, S) intermediates (≈ 7.4 MB live at cait_s_24) and the programs run
// in order, adding the mix gradients into one output block. Hopper blocks
// hold 227 KB and run in no order, so the backward recomputes instead of
// storing, as FlashAttention-2's does, in three launches (talking_head.cuh
// has the tiles and phases):
//   (i)   rows pass, a block per R 16-row query tiles of an image: K and V
//         tiles of 16 keys stream twice. Sweep 1 forms raw and dmixw (A),
//         and per (row, head) the running max, Σe and Σ e·dp (B), so each
//         row's m, 1/Σe and delta = Σ e·dp / Σe leave as (B, T, 3, H) f32
//         for (ii). Sweep 2 forms raw and dmixw again (A), p, dp, dmixl
//         (B) and, per warp for its heads, draw = Σ_g ml[g][h]·dmixl_g, the
//         four mix-parameter sums over its positions (lane-local, fixed
//         order) and dq += draw·k (C). The block's sums leave as a partial
//         row;
//   (ii)  keys pass, a block per R 16-key tiles of an image (keys are the
//         products' rows): q and dout tiles of 16 queries stream once with
//         their rows' statistics. rawᵀ and dmixwᵀ (A), then p, pw, dp,
//         dmixl, draw per position (B), dv += pwᵀ·dout and dk += drawᵀ·q
//         per head (C);
//   (iii) the partial rows added over the row blocks, one block per value,
//         in a fixed order: with no atomics anywhere, a second backward
//         gives the same bits.
// Every value the TPU kernel holds in f32 is f32 here; dq, dk and dv are
// rounded once to the input type. No (B, H, T, S) tensor is stored.
//
// What bounds it on an H100: at cait_s_24 b128 bf16 q/k/v/dout in and
// dq/dk/dv out are 135 MB (0.040 ms at 3.35 TB/s); the five products 19
// GFLOP (0.019 ms on the tensor cores); the four mixes and two sums
// 12·B·H²·T·S = 3.8 GFLOP of f32 (0.056 ms at 67 TFLOP/s): the bound. The
// sweeps and the keys pass's recompute issue the mixes about twice over.
// It ran 1.19 ms there (rows pass 0.64, keys pass 0.52) against the first
// design's 2.88 (NVIDIA H100 80GB HBM3, 700 W, scripts/ab_talking_head.py);
// talking_head.cuh says what holds it back.
#include "talking_head.cuh"

using namespace vtt_th;

namespace {

constexpr int REDUCE_THREADS = 256;

// Heads per warp, warps per 16-row tile, positions per thread in phase B,
// threads per row there, and the mix-parameter sums a lane keeps (rows
// pass).
template <int MH>
struct RowsShape {
  static constexpr int G = heads_per_warp<MH>(), W = MH / G, PPT = 8 / W, LPR = KT / PPT;
  static constexpr int NS = 2 * MH * G + 2 * G;
};
template <int MH>
struct KeysShape {
  static constexpr int G = heads_per_warp<MH>(), W = MH / G, PPT = 8 / W, LPR = KT / PPT;
};

struct RowsLayout {
  int pitch;
  size_t mix, stats, x, red, qres, kpart, qpart, stage, total;
  __host__ __device__ RowsLayout(int H, int HC, int MH, int IN, int R, int stages, int nc) {
    const int G = MH == 16 ? 2 : HEADS_PER_WARP, W = MH / G, NS = 2 * MH * G + 2 * G;
    pitch = H * HC + 8;
    mix = align128((4 * MH * MH + 2 * MH) * 4);
    stats = align128(static_cast<size_t>(3) * MH * R * 16 * 4);
    x = align128(static_cast<size_t>(MH) * R * 16 * XP * 4);
    red = R > 1 ? align128(static_cast<size_t>(W) * R * NS * 4) : 0;
    qres = nc == 1 ? part_bytes(IN, R * 16, pitch) : 0;
    kpart = part_bytes(IN, KT, pitch);
    qpart = part_bytes(IN, R * 16, pitch);
    // K, V; with several chunks q's and dout's chunks and K's output chunk
    stage = 2 * kpart + (nc > 1 ? 2 * qpart + kpart : 0);
    total = mix + stats + 3 * x + red + 2 * qres + stages * stage;
  }
};

struct KeysLayout {
  int pitch;
  size_t mix, x, kres, qpart, kpart, stats, stage, total;
  __host__ __device__ KeysLayout(int H, int HC, int MH, int IN, int R, int stages, int nc) {
    pitch = H * HC + 8;
    mix = align128((4 * MH * MH + 2 * MH) * 4);
    x = align128(static_cast<size_t>(MH) * R * 16 * XP * 4);
    kres = nc == 1 ? part_bytes(IN, R * 16, pitch) : 0;
    qpart = part_bytes(IN, KT, pitch);
    kpart = part_bytes(IN, R * 16, pitch);
    stats = align128(static_cast<size_t>(KT) * 3 * MH * 4);
    // q, dout; with several chunks K's and V's chunks and q's and dout's
    // output chunks; the queries' statistics
    stage = 2 * qpart + (nc > 1 ? 2 * kpart + 2 * qpart : 0) + stats;
    total = mix + 2 * x + 2 * kres + stages * stage;
  }
};

template <typename T, int MH, int HC>
__global__ void __launch_bounds__(block_warps(ROWS_WARPS, RowsShape<MH>::W) * 32,
                                  sm_blocks(ROWS_BLOCKS, RowsShape<MH>::W))
th_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ mixp, T* __restrict__ dq,
                   float* __restrict__ stats_out, float* __restrict__ partials, int Tq, int S,
                   int H, int hdp, int nc, int R, int row_blocks, int stages, float scale) {
  constexpr int IN = kInPlanes<T>;
  using Sh = RowsShape<MH>;
  constexpr int G = Sh::G, W = Sh::W, PPT = Sh::PPT, LPR = Sh::LPR, NS = Sh::NS;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L(H, HC, MH, IN, R, stages, nc);
  const int nt = blockDim.x, tid = threadIdx.x, wi = tid >> 5, r = wi / W, w = wi % W;
  const int b = blockIdx.x / row_blocks, q0 = blockIdx.x % row_blocks * R * 16;
  const int D = H * hdp, zc = blockIdx.y * HC, zw = min(HC, hdp - zc);
  const bool sums = blockIdx.y == 0;  // one chunk's blocks take the statistics and the sums
  const int rows16 = R * 16, xplane = rows16 * XP, kplane = KT * L.pitch,
            qplane = rows16 * L.pitch;
  const Mix<MH> M(reinterpret_cast<float*>(smem));
  unsigned char* p = smem + L.mix;
  float* st = reinterpret_cast<float*>(p);  // the rows' max, 1/Σe, delta: [3][MH][rows16]
  float* Xr = reinterpret_cast<float*>(p += L.stats);  // raw
  float* Xd = reinterpret_cast<float*>(p += L.x);      // dmixw, then p
  float* Xl = reinterpret_cast<float*>(p += L.x);      // dmixl
  float* red = reinterpret_cast<float*>(p += L.x);
  bf16* qres = reinterpret_cast<bf16*>(p += L.red);
  bf16* dres = reinterpret_cast<bf16*>(p += L.qres);
  unsigned char* ring = p + L.qres;
  const size_t img_q = static_cast<size_t>(b) * Tq * D, img_k = static_cast<size_t>(b) * S * D;
  const int nkt = (S + KT - 1) / KT, per_sweep = nkt * nc, items = 2 * per_sweep;
  auto stage = [&](int it) { return ring + (stages == 1 ? 0 : it % 2) * L.stage; };
  auto part = [&](int it, size_t off) { return reinterpret_cast<bf16*>(stage(it) + off); };
  const size_t off_q = 2 * L.kpart, off_d = off_q + L.qpart, off_kz = off_d + L.qpart;
  const Pieces P(H, HC, tid, nt);
  auto load = [&](int it) {
    int kt, c;
    tile_chunk(it < per_sweep ? it : it - per_sweep, nc, kt, c);
    const int c0 = c * HC, cw = min(HC, hdp - c0);
    load_chunk<T, IN, HC>(part(it, 0), L.pitch, kplane, k + img_k, D, kt * KT, KT, S, hdp, c0,
                          cw, P);
    load_chunk<T, IN, HC>(part(it, L.kpart), L.pitch, kplane, v + img_k, D, kt * KT, KT, S, hdp, c0, cw, P);
    if (nc > 1) {
      load_chunk<T, IN, HC>(part(it, off_q), L.pitch, qplane, q + img_q, D, q0, rows16, Tq, hdp, c0, cw, P);
      load_chunk<T, IN, HC>(part(it, off_d), L.pitch, qplane, dout + img_q, D, q0, rows16, Tq, hdp, c0, cw, P);
      if (it >= per_sweep && c == nc - 1) {
        load_chunk<T, IN, HC>(part(it, off_kz), L.pitch, kplane, k + img_k, D, kt * KT, KT, S, hdp, zc, zw, P);
      }
    }
  };

  M.load(mixp, H, tid, nt);
  for (float* x : {Xr, Xd, Xl}) zero_padded<MH>(x, xplane, H, tid, nt);
  if (nc == 1) {
    load_chunk<T, IN, HC>(qres, L.pitch, qplane, q + img_q, D, q0, rows16, Tq, hdp, 0, hdp, P);
    load_chunk<T, IN, HC>(dres, L.pitch, qplane, dout + img_q, D, q0, rows16, Tq, hdp, 0, hdp, P);
  }
  if (stages == 2) load(0);
  cp_async_commit();

  const bool active = q0 + r * 16 < Tq;
  const int prow = tid / LPR, pc = tid % LPR * PPT;
  float acc[G][2][4], accd[G][2][4];  // raw and dmixw of the warp's heads
  const Lanes lanes(L.pitch);
  // The ring's head and phase A for item `it`: raw_h = q_h·k_hᵀ and
  // dmixw_h = dout_h·v_hᵀ for the warp's heads over this chunk; at a key
  // tile's last chunk both go to the exchange planes (true, after a barrier).
  auto step = [&](int it) {
    ring_head(it, items, stages, load);
    int kt, c;
    tile_chunk(it < per_sweep ? it : it - per_sweep, nc, kt, c);
    const bf16* ks = part(it, 0);
    const bf16* vs = part(it, L.kpart);
    const bf16* qs = nc == 1 ? qres : part(it, off_q);
    const bf16* ds = nc == 1 ? dres : part(it, off_d);
    if (c == 0) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi][n][e] = accd[gi][n][e] = 0.0f;
        }
      }
    }
    if (active) {
      const int nkh = min(HC, hdp - c * HC) / 16;
      const uint32_t rows_off = 2 * r * 16 * L.pitch + lanes.a;
      const uint32_t q0a = smem_addr(qs) + rows_off, d0a = smem_addr(ds) + rows_off;
      const uint32_t k0a = smem_addr(ks) + lanes.b, v0a = smem_addr(vs) + lanes.b;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int h = w * G + gi;
        if (h >= H) continue;
        const uint32_t col = 2 * h * HC;
        logits16<IN, HC>(acc[gi], q0a + col, k0a + col, 2 * qplane, 2 * kplane, nkh);
        logits16<IN, HC>(accd[gi], d0a + col, v0a + col, 2 * qplane, 2 * kplane, nkh);
      }
    }
    if (c < nc - 1) {
      if (stages == 1) __syncthreads();  // the one stage is refilled next
      return false;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int h = w * G + gi;
      if (h >= H) continue;
      put_tile(Xr + h * xplane, r * 16, acc[gi], scale);
      put_tile(Xd + h * xplane, r * 16, accd[gi], 1.0f);
    }
    __syncthreads();
    return true;
  };
  // B's common start: mixl and dp = Σ_g mw[g][h]·dmixw_g at the thread's
  // positions, every head
  auto mixes = [&](float (&ml)[PPT][MH], float (&dp)[PPT][MH]) {
    float x[PPT][MH];
    gather<MH, PPT>(Xr, xplane, prow, pc, x);
    mix<MH, PPT>(M.mlT, M.mlb, x, ml);
    gather<MH, PPT>(Xd, xplane, prow, pc, x);
    mix<MH, PPT>(M.mw, nullptr, x, dp);  // dp_h = Σ_g mw[g][h]·dmixw_g
  };

  // sweep 1: per (row, head) the running max, Σe and Σ e·dp
  {
    float m[MH], l[MH], d[MH];
#pragma unroll
    for (int h = 0; h < MH; ++h) m[h] = kNegInf, l[h] = 0.0f, d[h] = 0.0f;
    for (int it = 0; it < per_sweep; ++it) {
      if (!step(it)) continue;
      int kt, c;
      tile_chunk(it, nc, kt, c);
      const int key0 = kt * KT + pc;
      float ml[PPT][MH], dp[PPT][MH];
      mixes(ml, dp);
#pragma unroll
      for (int h = 0; h < MH; ++h) {
        float tmax = kNegInf;
#pragma unroll
        for (int jj = 0; jj < PPT; ++jj) {
          if (key0 + jj < S) tmax = fmaxf(tmax, ml[jj][h]);
        }
        const float mn = fmaxf(m[h], tmax), alpha = softmax_e(m[h], mn);
        float sl = 0.0f, sd = 0.0f;
#pragma unroll
        for (int jj = 0; jj < PPT; ++jj) {
          if (key0 + jj < S) {
            const float e = softmax_e(ml[jj][h], mn);
            sl += e;
            sd = fmaf(e, dp[jj][h], sd);
          }
        }
        l[h] = fmaf(l[h], alpha, sl);
        d[h] = fmaf(d[h], alpha, sd);
        m[h] = mn;
      }
      if (stages == 1) __syncthreads();
    }
    // the LPR threads of a row merge theirs; every padded head's too (the
    // keys pass mixes them, with zero weights)
    const int t = q0 + prow;
#pragma unroll
    for (int h = 0; h < MH; ++h) {
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
        const float dd = __shfl_xor_sync(0xffffffffu, d[h], off);
        const float mn = fmaxf(m[h], mo);
        const float a = softmax_e(m[h], mn), ao = softmax_e(mo, mn);
        l[h] = l[h] * a + lo * ao;
        d[h] = d[h] * a + dd * ao;
        m[h] = mn;
      }
      if (tid % LPR == 0) {  // seen by all after the next step's barrier
        const float il = 1.0f / l[h], vals[3] = {m[h], il, d[h] * il};
#pragma unroll
        for (int i = 0; i < 3; ++i) st[(i * MH + h) * rows16 + prow] = vals[i];
        if (sums && t < Tq) {
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            stats_out[(static_cast<size_t>(b) * Tq + t) * 3 * MH + i * MH + h] = vals[i];
          }
        }
      }
    }
  }

  // sweep 2: p and dmixl per position (B); per warp for its heads the
  // mix-parameter sums, draw and dq += draw·k (C)
  float dqa[G][HC / 8][4];
  float s_ml[G][MH], s_mw[G][MH], s_mlb[G], s_mwb[G];  // the lane's mix-parameter sums
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int jj = 0; jj < HC / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[gi][jj][e] = 0.0f;
    }
#pragma unroll
    for (int h = 0; h < MH; ++h) s_ml[gi][h] = s_mw[gi][h] = 0.0f;
    s_mlb[gi] = s_mwb[gi] = 0.0f;
  }
  for (int it = per_sweep; it < items; ++it) {
    if (!step(it)) continue;
    {
      int kt, c;
      tile_chunk(it - per_sweep, nc, kt, c);
      const int key0 = kt * KT + pc;
      float ml[PPT][MH], dp[PPT][MH];
      mixes(ml, dp);
      // p and dmixl = p·(dp − delta), to the planes (p in place of dmixw)
#pragma unroll
      for (int h = 0; h < MH; ++h) {
        const float mm = st[h * rows16 + prow], il = st[(MH + h) * rows16 + prow];
        const float dl = st[(2 * MH + h) * rows16 + prow];
#pragma unroll
        for (int jj = 0; jj < PPT; ++jj) {
          const float pp = key0 + jj < S ? softmax_e(ml[jj][h], mm) * il : 0.0f;
          ml[jj][h] = pp;
          dp[jj][h] = pp * (dp[jj][h] - dl);
        }
      }
      scatter<MH, PPT>(Xd, xplane, prow, pc, ml);
      scatter<MH, PPT>(Xl, xplane, prow, pc, dp);
    }
    __syncthreads();
    if (active) {
      float dl_own[G][2][4], draw[G][2][4];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) draw[gi][n][e] = dl_own[gi][n][e] = 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < MH; ++g) {  // draw_h = Σ_g ml[g][h]·dmixl_g, in order of g
        if (g >= H) break;
        float t[2][4];
        get_tile(Xl + g * xplane, r * 16, t);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float wgt = M.ml[g * MH + w * G + gi];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) draw[gi][n][e] = fmaf(wgt, t[n][e], draw[gi][n][e]);
          }
          if (g == w * G + gi) {
#pragma unroll
            for (int n = 0; n < 2; ++n) {
#pragma unroll
              for (int e = 0; e < 4; ++e) dl_own[gi][n][e] = t[n][e];
            }
          }
        }
      }
      if (sums) {
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          if (h >= H) break;
          float pt[2][4], rt[2][4];
          get_tile(Xd + h * xplane, r * 16, pt);
          get_tile(Xr + h * xplane, r * 16, rt);
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
#pragma unroll
            for (int n = 0; n < 2; ++n) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                s_mw[gi][h] = fmaf(accd[gi][n][e], pt[n][e], s_mw[gi][h]);
                s_ml[gi][h] = fmaf(dl_own[gi][n][e], rt[n][e], s_ml[gi][h]);
              }
            }
          }
        }
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s_mwb[gi] += accd[gi][n][e];
              s_mlb[gi] += dl_own[gi][n][e];
            }
          }
        }
      }
      const bf16* kz = nc == 1 ? part(it, 0) : part(it, off_kz);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int h = w * G + gi;
        if (h < H) {
          tile_product<MID, IN, HC>(dqa[gi], draw[gi], smem_addr(kz) + 2 * h * HC + lanes.a,
                                    2 * kplane, zw);
        }
      }
    }
    if (stages == 1) __syncthreads();  // the one stage is refilled next
  }

  if (active) {
    const int row0 = q0 + r * 16 + lane_g();
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int h = w * G + gi;
      if (h >= H) continue;
      T* dst = dq + static_cast<size_t>(b) * Tq * D + h * hdp + zc;
#pragma unroll
      for (int jj = 0; jj < HC / 8; ++jj) {
        if (jj * 8 >= zw) break;
        const float val[4] = {dqa[gi][jj][0] * scale, dqa[gi][jj][1] * scale,
                              dqa[gi][jj][2] * scale, dqa[gi][jj][3] * scale};
        store_acc<T>(dst, D, row0, Tq, jj * 8 + 2 * lane_t(), zw, val);
      }
    }
  }
  if (!sums) return;
  // the block's partial row of the mix-parameter sums: each warp's lanes
  // summed by a shuffle tree, then the R row tiles' warps in order
  float vals[NS];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int h = 0; h < MH; ++h) {
      vals[gi * MH + h] = s_ml[gi][h];
      vals[(G + gi) * MH + h] = s_mw[gi][h];
    }
    vals[2 * G * MH + gi] = s_mlb[gi];
    vals[2 * G * MH + G + gi] = s_mwb[gi];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) vals[i] = warp_sum(vals[i]);
  const int nv = 2 * H * H + 2 * H;
  float* part_row = partials + static_cast<size_t>(blockIdx.x) * nv;
  // value i of warp w's list → its place in the (dml, dmlb, dmw, dmwb) row
  auto place = [&](int w_, int i) {
    const int gi = i < 2 * G * MH ? i / MH % G : (i - 2 * G * MH) % G, g = w_ * G + gi;
    if (g >= H) return -1;
    if (i < G * MH) return i % MH < H ? g * H + i % MH : -1;
    if (i < 2 * G * MH) return i % MH < H ? H * H + H + g * H + i % MH : -1;
    return i < 2 * G * MH + G ? H * H + g : 2 * H * H + H + g;
  };
  if (R == 1) {
    if ((tid & 31) == 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int at = place(w, i);
        if (at >= 0) part_row[at] = vals[i];
      }
    }
    return;
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) red[wi * NS + i] = vals[i];
  }
  __syncthreads();
  for (int e = tid; e < W * NS; e += nt) {
    const int w_ = e / NS, i = e % NS, at = place(w_, i);
    if (at < 0) continue;
    float total = 0.0f;
    for (int rr = 0; rr < R; ++rr) total += red[(rr * W + w_) * NS + i];
    part_row[at] = total;
  }
}

template <typename T, int MH, int HC>
__global__ void __launch_bounds__(block_warps(KEYS_WARPS, KeysShape<MH>::W) * 32,
                                  sm_blocks(KEYS_BLOCKS, KeysShape<MH>::W))
th_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ mixp,
                   const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
                   int Tq, int S, int H, int hdp, int nc, int R, int key_blocks, int stages,
                   float scale) {
  constexpr int IN = kInPlanes<T>;
  using Sh = KeysShape<MH>;
  constexpr int G = Sh::G, W = Sh::W, PPT = Sh::PPT, LPR = Sh::LPR;
  extern __shared__ __align__(128) unsigned char smem[];
  const KeysLayout L(H, HC, MH, IN, R, stages, nc);
  const int nt = blockDim.x, tid = threadIdx.x, wi = tid >> 5, r = wi / W, w = wi % W;
  const int b = blockIdx.x / key_blocks, k0 = blockIdx.x % key_blocks * R * 16;
  const int D = H * hdp, zc = blockIdx.y * HC, zw = min(HC, hdp - zc);
  const int rows16 = R * 16, xplane = rows16 * XP, kplane = rows16 * L.pitch,
            qplane = KT * L.pitch;
  const Mix<MH> M(reinterpret_cast<float*>(smem));
  unsigned char* p = smem + L.mix;
  float* Xr = reinterpret_cast<float*>(p);         // rawᵀ, then pwᵀ
  float* Xd = reinterpret_cast<float*>(p += L.x);  // dmixwᵀ, then drawᵀ
  bf16* kres = reinterpret_cast<bf16*>(p += L.x);
  bf16* vres = reinterpret_cast<bf16*>(p += L.kres);
  unsigned char* ring = p + L.kres;
  const size_t img_q = static_cast<size_t>(b) * Tq * D, img_k = static_cast<size_t>(b) * S * D;
  const float* st_b = stats + static_cast<size_t>(b) * Tq * 3 * MH;
  const int nqt = (Tq + KT - 1) / KT, items = nqt * nc;
  auto stage = [&](int it) { return ring + (stages == 1 ? 0 : it % 2) * L.stage; };
  auto part = [&](int it, size_t off) { return reinterpret_cast<bf16*>(stage(it) + off); };
  const size_t off_k = 2 * L.qpart, off_v = off_k + L.kpart, off_qz = off_v + L.kpart,
               off_dz = off_qz + L.qpart;
  const size_t off_st = nc > 1 ? off_dz + L.qpart : off_k;
  const Pieces P(H, HC, tid, nt);
  auto load = [&](int it) {
    int qt, c;
    tile_chunk(it, nc, qt, c);
    const int c0 = c * HC, cw = min(HC, hdp - c0);
    load_chunk<T, IN, HC>(part(it, 0), L.pitch, qplane, q + img_q, D, qt * KT, KT, Tq, hdp,
                          c0, cw, P);
    load_chunk<T, IN, HC>(part(it, L.qpart), L.pitch, qplane, dout + img_q, D, qt * KT, KT, Tq, hdp, c0, cw, P);
    if (nc > 1) {
      load_chunk<T, IN, HC>(part(it, off_k), L.pitch, kplane, k + img_k, D, k0, rows16, S, hdp,
                            c0, cw, P);
      load_chunk<T, IN, HC>(part(it, off_v), L.pitch, kplane, v + img_k, D, k0, rows16, S, hdp,
                            c0, cw, P);
    }
    if (c == nc - 1) {
      if (nc > 1) {
        load_chunk<T, IN, HC>(part(it, off_qz), L.pitch, qplane, q + img_q, D, qt * KT, KT, Tq, hdp, zc, zw, P);
        load_chunk<T, IN, HC>(part(it, off_dz), L.pitch, qplane, dout + img_q, D, qt * KT, KT,
                              Tq, hdp, zc, zw, P);
      }
      // the queries' statistics; past T a max of 1e30 and 1/Σe = 0: p = 0
      float* sd = reinterpret_cast<float*>(stage(it) + off_st);
      for (int e = tid; e < KT * 3 * MH; e += nt) {
        const int t = qt * KT + e / (3 * MH), i = e % (3 * MH);
        sd[e] = t < Tq ? st_b[static_cast<size_t>(t) * 3 * MH + i]
                       : (i < MH ? 1e30f : 0.0f);
      }
    }
  };

  M.load(mixp, H, tid, nt);
  for (float* x : {Xr, Xd}) zero_padded<MH>(x, xplane, H, tid, nt);
  if (nc == 1) {
    load_chunk<T, IN, HC>(kres, L.pitch, kplane, k + img_k, D, k0, rows16, S, hdp, 0, hdp, P);
    load_chunk<T, IN, HC>(vres, L.pitch, kplane, v + img_k, D, k0, rows16, S, hdp, 0, hdp, P);
  }
  if (stages == 2) load(0);
  cp_async_commit();

  const bool active = k0 + r * 16 < S;  // the warp's key tile holds a key
  const int prow = tid / LPR, pc = tid % LPR * PPT;  // phase B: key row, queries
  float acc[G][2][4], accd[G][2][4];
  float dva[G][HC / 8][4], dka[G][HC / 8][4];
  const Lanes lanes(L.pitch);
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int jj = 0; jj < HC / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[gi][jj][e] = dka[gi][jj][e] = 0.0f;
    }
  }

  for (int it = 0; it < items; ++it) {
    ring_head(it, items, stages, load);
    int qt, c;
    tile_chunk(it, nc, qt, c);
    const bf16* qs = part(it, 0);
    const bf16* ds = part(it, L.qpart);
    const bf16* ks = nc == 1 ? kres : part(it, off_k);
    const bf16* vs = nc == 1 ? vres : part(it, off_v);
    if (c == 0) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi][n][e] = accd[gi][n][e] = 0.0f;
        }
      }
    }
    // A: rawᵀ_h = k_h·q_hᵀ and dmixwᵀ_h = v_h·dout_hᵀ, keys as rows
    if (active) {
      const int nkh = min(HC, hdp - c * HC) / 16;
      const uint32_t rows_off = 2 * r * 16 * L.pitch + lanes.a;
      const uint32_t k0a = smem_addr(ks) + rows_off, v0a = smem_addr(vs) + rows_off;
      const uint32_t q0a = smem_addr(qs) + lanes.b, d0a = smem_addr(ds) + lanes.b;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int h = w * G + gi;
        if (h >= H) continue;
        const uint32_t col = 2 * h * HC;
        logits16<IN, HC>(acc[gi], k0a + col, q0a + col, 2 * kplane, 2 * qplane, nkh);
        logits16<IN, HC>(accd[gi], v0a + col, d0a + col, 2 * kplane, 2 * qplane, nkh);
      }
    }
    if (c < nc - 1) {
      if (stages == 1) __syncthreads();
      continue;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int h = w * G + gi;
      if (h >= H) continue;
      put_tile(Xr + h * xplane, r * 16, acc[gi], scale);
      put_tile(Xd + h * xplane, r * 16, accd[gi], 1.0f);
    }
    __syncthreads();
    // B: p, pw, dp, dmixl and draw at the thread's positions (key prow,
    // queries pc..), every head
    {
      const float* sd = reinterpret_cast<const float*>(stage(it) + off_st);
      const bool key_ok = k0 + prow < S;
      float x[PPT][MH], y[PPT][MH];
      gather<MH, PPT>(Xr, xplane, prow, pc, x);
      mix<MH, PPT>(M.mlT, M.mlb, x, y);  // mixl
#pragma unroll
      for (int jj = 0; jj < PPT; ++jj) {
        const float* s = sd + (pc + jj) * 3 * MH;
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          y[jj][h] = key_ok ? softmax_e(y[jj][h], s[h]) * s[MH + h] : 0.0f;
        }
      }
      mix<MH, PPT>(M.mwT, M.mwb, y, x);  // pw
      scatter<MH, PPT>(Xr, xplane, prow, pc, x);
      gather<MH, PPT>(Xd, xplane, prow, pc, x);
      {
        float dp[PPT][MH];
        mix<MH, PPT>(M.mw, nullptr, x, dp);  // dp
#pragma unroll
        for (int jj = 0; jj < PPT; ++jj) {
          const float* s = sd + (pc + jj) * 3 * MH + 2 * MH;
#pragma unroll
          for (int h = 0; h < MH; ++h) dp[jj][h] = y[jj][h] * (dp[jj][h] - s[h]);  // dmixl
        }
        mix<MH, PPT>(M.ml, nullptr, dp, x);  // draw_h = Σ_g ml[g][h]·dmixl_g
      }
      scatter<MH, PPT>(Xd, xplane, prow, pc, x);
    }
    __syncthreads();
    // C: dv_g += pwᵀ_g·dout_g and dk_g += drawᵀ_g·q_g for the warp's heads
    if (active) {
      const bf16* qz = nc == 1 ? qs : part(it, off_qz);
      const bf16* dz = nc == 1 ? ds : part(it, off_dz);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int g = w * G + gi;
        if (g >= H) continue;
        float t[2][4];
        get_tile(Xr + g * xplane, r * 16, t);
        tile_product<MID, IN, HC>(dva[gi], t, smem_addr(dz) + 2 * g * HC + lanes.a, 2 * qplane,
                                  zw);
        get_tile(Xd + g * xplane, r * 16, t);
        tile_product<MID, IN, HC>(dka[gi], t, smem_addr(qz) + 2 * g * HC + lanes.a, 2 * qplane,
                                  zw);
      }
    }
    if (stages == 1) __syncthreads();
  }
  if (!active) return;

  const int row0 = k0 + r * 16 + lane_g();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int g = w * G + gi;
    if (g >= H) continue;
    const size_t off = static_cast<size_t>(b) * S * D + g * hdp + zc;
#pragma unroll
    for (int jj = 0; jj < HC / 8; ++jj) {
      if (jj * 8 >= zw) break;
      const float sk[4] = {dka[gi][jj][0] * scale, dka[gi][jj][1] * scale,
                           dka[gi][jj][2] * scale, dka[gi][jj][3] * scale};
      store_acc<T>(dv + off, D, row0, S, jj * 8 + 2 * lane_t(), zw, dva[gi][jj]);
      store_acc<T>(dk + off, D, row0, S, jj * 8 + 2 * lane_t(), zw, sk);
    }
  }
}

// out[j] = Σ_i partials[i][j] over the n row blocks, one block per value j.
__global__ void __launch_bounds__(REDUCE_THREADS)
th_param_reduce_kernel(const float* __restrict__ partials, int n, int nv, float* __restrict__ out) {
  __shared__ float warp_part[REDUCE_THREADS / 32];
  const int j = blockIdx.x;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += REDUCE_THREADS) {
    acc += partials[static_cast<size_t>(i) * nv + j];
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < REDUCE_THREADS / 32; ++w) total += warp_part[w];
    out[j] = total;
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float* mix;
  void *dq, *dk, *dv;
  float *scratch, *dmix;
  int B, T, S, H, hdp;
  float scale;
  cudaStream_t st;
};

template <typename T, int MH, int HC>
Geometry rows_geometry(int B, int T_, int H, int hdp) {
  const int nc = (hdp + HC - 1) / HC;
  constexpr int W = RowsShape<MH>::W;
  return pick_geometry(B, T_, W, block_warps(ROWS_WARPS, W), sm_blocks(ROWS_BLOCKS, W),
                       [&](int R, int st) {
                         return RowsLayout(H, HC, MH, kInPlanes<T>, R, st, nc).total;
                       });
}

template <typename T, int MH, int HC>
Geometry keys_geometry(int B, int S, int H, int hdp) {
  const int nc = (hdp + HC - 1) / HC;
  constexpr int W = KeysShape<MH>::W;
  return pick_geometry(B, S, W, block_warps(KEYS_WARPS, W), sm_blocks(KEYS_BLOCKS, W),
                       [&](int R, int st) {
                         return KeysLayout(H, HC, MH, kInPlanes<T>, R, st, nc).total;
                       });
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int MH, int HC>
cudaError_t launch(const BwdArgs& a) {
  const Geometry gr = rows_geometry<T, MH, HC>(a.B, a.T, a.H, a.hdp);
  const Geometry gk = keys_geometry<T, MH, HC>(a.B, a.S, a.H, a.hdp);
  if (gr.R == 0 || gk.R == 0) return cudaErrorInvalidValue;
  const int nc = (a.hdp + HC - 1) / HC, nv = 2 * a.H * a.H + 2 * a.H;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  // the scratch: the rows' statistics, (B, T, 3, MH) f32, then the row
  // blocks' partial rows, (B · blocks, 2H² + 2H) f32
  float* stats = a.scratch;
  float* partials = a.scratch + static_cast<size_t>(a.B) * a.T * 3 * MH;
  auto rows = th_bwd_rows_kernel<T, MH, HC>;
  cudaError_t err = set_smem(rows, gr.smem);
  if (err != cudaSuccess) return err;
  rows<<<dim3(a.B * gr.blocks, nc), gr.R * RowsShape<MH>::W * 32, gr.smem, a.st>>>(
      q, k, v, dout, a.mix, static_cast<T*>(a.dq), stats, partials, a.T, a.S, a.H, a.hdp, nc,
      gr.R, gr.blocks, gr.stages, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto keys = th_bwd_keys_kernel<T, MH, HC>;
  if ((err = set_smem(keys, gk.smem)) != cudaSuccess) return err;
  keys<<<dim3(a.B * gk.blocks, nc), gk.R * KeysShape<MH>::W * 32, gk.smem, a.st>>>(
      q, k, v, dout, a.mix, stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.T, a.S, a.H,
      a.hdp, nc, gk.R, gk.blocks, gk.stages, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  th_param_reduce_kernel<<<nv, REDUCE_THREADS, 0, a.st>>>(partials, a.B * gr.blocks, nv, a.dmix);
  return cudaGetLastError();
}

template <typename T, int HC>
cudaError_t launch_heads(const BwdArgs& a) {
  if (a.H <= 4) return launch<T, 4, HC>(a);
  if (a.H <= 8) return launch<T, 8, HC>(a);
  return launch<T, 16, HC>(a);
}

template <typename T, int HC, int MH>
void geometry_of(int B, int T_, int S, int H, int hdp, Geometry* g) {
  g[0] = rows_geometry<T, MH, HC>(B, T_, H, hdp);
  g[1] = keys_geometry<T, MH, HC>(B, S, H, hdp);
}

template <typename T, int HC>
void geometry_heads(int B, int T_, int S, int H, int hdp, Geometry* g) {
  if (H <= 4) return geometry_of<T, HC, 4>(B, T_, S, H, hdp, g);
  if (H <= 8) return geometry_of<T, HC, 8>(B, T_, S, H, hdp, g);
  return geometry_of<T, HC, 16>(B, T_, S, H, hdp, g);
}

void geometries(int B, int T_, int S, int H, int hdp, int is_bf16, Geometry* g) {
  if (!is_bf16) return geometry_heads<float, 16>(B, T_, S, H, hdp, g);
  if (chunk_width(hdp, true) == 48) return geometry_heads<bf16, 48>(B, T_, S, H, hdp, g);
  return geometry_heads<bf16, 64>(B, T_, S, H, hdp, g);
}

}  // namespace

// The backward's launches for B images: out = {R, blocks an image, ring
// stages, shared-memory bytes, threads} of the rows pass (which = 0) or the
// keys pass (which = 1).
extern "C" int vtt_talking_head_bwd_geometry(int B, int T, int S, int H, int hd, int is_bf16,
                                             int which, long long* out) {
  if (!admits(B, T, S, H, hd) || which < 0 || which > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g[2];
  geometries(B, T, S, H, hd, is_bf16, g);
  const int MH = mix_heads(H);
  const int W = MH / (MH == 16 ? 2 : HEADS_PER_WARP);
  const long long vals[5] = {g[which].R, g[which].blocks, g[which].stages,
                             static_cast<long long>(g[which].smem), g[which].R * W * 32};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return g[which].R == 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// f32 scratch the backward needs (the rows' statistics and the row blocks'
// partial sums); 0 when the shape has no kernel.
extern "C" long long vtt_talking_head_bwd_floats(int B, int T, int S, int H, int hd,
                                                 int is_bf16) {
  if (!admits(B, T, S, H, hd)) return 0;
  Geometry g[2];
  geometries(B, T, S, H, hd, is_bf16, g);
  if (g[0].R == 0 || g[1].R == 0) return 0;
  return static_cast<long long>(B) * T * 3 * mix_heads(H) +
         static_cast<long long>(B) * g[0].blocks * (2 * H * H + 2 * H);
}

// mix: ml (H²), mlb (H), mw (H²), mwb (H), f32. scratch: f32, at least
// vtt_talking_head_bwd_floats(...). dmix (2H² + 2H) f32 receives dml,
// dmlb, dmw, dmwb in that order.
extern "C" int vtt_talking_head_bwd(const void* q, const void* k, const void* v, const void* dout,
                                    int in_bf16, const float* mix, void* dq, void* dk, void* dv,
                                    float* scratch, float* dmix, int B, int T, int S, int H,
                                    int hd, float scale, void* stream) {
  if (!admits(B, T, S, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, mix, dq, dk, dv, scratch, dmix,
                  B, T, S, H, hd, scale, static_cast<cudaStream_t>(stream)};
  if (!in_bf16) return static_cast<int>(launch_heads<float, 16>(a));
  return static_cast<int>(chunk_width(hd, true) == 48 ? launch_heads<bf16, 48>(a)
                                                      : launch_heads<bf16, 64>(a));
}
