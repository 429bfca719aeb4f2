// CaiT talking-head attention, backward (K5): from q, k, v, the mixes and
// dout, recompute the forward and return dq, dk, dv (in the input type) and
// the four mix-parameter gradients dml, dmlb, dmw, dmwb (f32, summed over
// the batch):
//   dv_g    = pw_gᵀ·do_g               dmixw_g = do_g·v_gᵀ
//   dmw     = Σ dmixw_g·p_h            dmwb_g  = Σ dmixw_g
//   dp_h    = Σ_g mw[g][h]·dmixw_g     dmixl_h = p_h·(dp_h − rowsum(dp_h·p_h))
//   dml     = Σ dmixl_g·raw_h          dmlb_g  = Σ dmixl_g
//   draw_h  = Σ_g ml[g][h]·dmixl_g
//   dq_h    = draw_h·k_h·scale         dk_h    = draw_hᵀ·(q_h·scale)
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/cait_attention.py `_th_bwd`
// (`_bwd_kernel`). On the TPU one grid program holds an image's whole
// (H, T, S) intermediates (≈ 7.4 MB live at cait_s_24) and the programs run
// in order, adding the mix gradients into one output block. Hopper blocks
// hold 227 KB and run in no order, so the backward is three launches:
//   (i)   row pass, one block per (BQ query rows, image) for all heads, as
//         the forward: recompute raw, p and pw; dmixw, dp, dmixl, draw in
//         shared memory; dq in the block (it sums over keys only). pw and
//         draw go to device memory, (B, H, T, S) f32 each (157 MB at
//         cait_s_24, batch 128), for the sums over query rows; each block
//         writes its partial mix-parameter sums (2H² + 2H f32) to scratch;
//   (ii)  key pass, one block per (8 keys, image): dv and dk sum pw and
//         draw over all query rows of the image, read back in chunks;
//   (iii) the partial sums added over the row blocks, one block per value,
//         in a fixed order: the mix gradients are deterministic.
// Every value the TPU kernel holds in f32 is f32 here; dq, dk and dv are
// rounded once to the input type. Any head width (padded to a multiple of
// 16, logits in 64-, 48- or 16-column chunks) and any shape of the JAX rule: where a
// row block of four query rows does not fit shared memory (S = 512 at 16
// heads), a block takes two or one (talking_head.cuh `rows_per_block`).
//
// What bounds it on an H100: q/k/v/dout in and dq/dk/dv out (7·B·T·D
// elements) set the least time together with the H²-sized mixes and sums
// (12·B·H²·T·S f32 operations on the CUDA cores); this first version also
// runs the five per-head products (10·B·T·S·D) in f32 on the CUDA cores and
// moves pw and draw through device memory twice, so it is bound by f32
// issue rate and those 4·B·H·T·S·4 bytes.
#include "talking_head.cuh"

using namespace vtt_th;

namespace {

constexpr int KEYS = 8;         // keys per block of the key pass
constexpr int ROW_CHUNK = 32;   // query rows of pw/draw staged at a time there
constexpr int REDUCE_THREADS = 256;
constexpr int KEY_COLUMNS = 1024;  // columns (threads) of a key-pass block

// Σ_p grad[g][p]·act[h][p] into out[g·H + h] and Σ_p grad[g][p] into
// out[H² + g], over the block's positions (both are 0 at s ≥ S and
// grad is 0 past row T), one warp per value.
__device__ __forceinline__ void param_sums(const float* grad, const float* act, int H, int plane,
                                           float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < H * H + H; j += NT / 32) {
    const bool bias = j >= H * H;
    const float* gp = grad + (bias ? j - H * H : j / H) * plane;
    const float* ap = act + (bias ? 0 : j % H) * plane;
    float acc = 0.0f;
    for (int p = lane; p < plane; p += 32) acc += bias ? gp[p] : gp[p] * ap[p];
    acc = warp_sum(acc);
    if (lane == 0) out[j] = acc;
  }
}

// p·(dp − rowsum(dp·p)) in place of dp, over the S valid keys of each row.
__device__ __forceinline__ void softmax_bwd_rows(float* dp, const float* p, int rows, int S,
                                                 int SP) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += NT / 32) {
    float* d = dp + static_cast<size_t>(r) * SP;
    const float* pr = p + static_cast<size_t>(r) * SP;
    float rs = 0.0f;
    for (int s = lane; s < S; s += 32) rs += d[s] * pr[s];
    rs = warp_sum(rs);
    for (int s = lane; s < S; s += 32) d[s] = pr[s] * (d[s] - rs);
  }
}

template <int CH, int MH>
__global__ void __launch_bounds__(NT)
th_bwd_rows_kernel(const void* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v, const void* __restrict__ dout, int in_bf16,
                   const float* __restrict__ mix, void* __restrict__ dq, float* __restrict__ pw,
                   float* __restrict__ draw, float* __restrict__ partials, int T, int S, int H,
                   int HD, int BQ, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int D = H * HD, SP = pad4(S), plane = BQ * SP, nv = 2 * H * H + 2 * H;
  float* raw = smem;                 // H·BQ·SP raw logits
  float* prob = raw + H * plane;     // softmax probabilities
  float* grad = prob + H * plane;    // dmixw → dp → dmixl → draw
  float* tile = grad + H * plane;    // BQ·H·CH, a chunk of q·scale, then of dout
  float* mx = tile + BQ * H * CH;    // ml (H²), mlb (H), mw (H²), mwb (H)
  const float *ml = mx, *mlb = mx + H * H, *mw = mlb + H, *mwb = mw + H * H;
  const int t0 = blockIdx.x * BQ, b = blockIdx.y;
  const size_t rows_base = static_cast<size_t>(b) * T * D, keys_base = static_cast<size_t>(b) * S * D;
  // this block's rows of the (B, H, T, S) scratch, and its partial sums
  const size_t scratch = static_cast<size_t>(b) * H * T * S + static_cast<size_t>(t0) * S;
  float* part = partials + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * nv;

  for (int i = threadIdx.x; i < nv; i += NT) mx[i] = mix[i];
  chunked_dots<CH>(q, scale, k, in_bf16, rows_base, keys_base, t0, T, S, SP, D, HD, H, BQ, tile,
                   raw);
  mix_heads<MH, false>(raw, prob, ml, mlb, H, BQ, S, SP, nullptr, 0, T);
  __syncthreads();
  softmax_rows(prob, H * BQ, S, SP);
  __syncthreads();
  // pw to device memory only; dmixw = dout·vᵀ after it
  mix_heads<MH, false>(prob, nullptr, mw, mwb, H, BQ, S, SP, pw + scratch, T - t0, T);
  chunked_dots<CH>(dout, 1.0f, v, in_bf16, rows_base, keys_base, t0, T, S, SP, D, HD, H, BQ,
                   tile, grad);
  param_sums(grad, prob, H, plane, part + H * H + H);  // dmw, dmwb
  __syncthreads();
  mix_heads<MH, true>(grad, grad, mw, nullptr, H, BQ, S, SP, nullptr, 0, T);  // dp
  __syncthreads();
  softmax_bwd_rows(grad, prob, H * BQ, S, SP);  // dmixl
  __syncthreads();
  param_sums(grad, raw, H, plane, part);  // dml, dmlb
  __syncthreads();
  mix_heads<MH, true>(grad, grad, ml, nullptr, H, BQ, S, SP, draw + scratch, T - t0, T);
  __syncthreads();
  scores_times_rows(grad, k, in_bf16, keys_base, dq, rows_base, t0, T, S, SP, D, HD, BQ, scale);
}

// dv[s][c] = Σ_t pw[g][t][s]·dout[t][c], dk[s][c] = Σ_t draw[g][t][s]·q[t][c]·scale
// for KEYS keys of one image, g = c / hd; one thread per column, the columns
// split over blockIdx.z when D exceeds a block.
__global__ void th_bwd_keys_kernel(const void* __restrict__ q, const void* __restrict__ dout,
                                   int in_bf16, const float* __restrict__ pw,
                                   const float* __restrict__ draw, void* __restrict__ dk,
                                   void* __restrict__ dv, int T, int S, int H, int hd,
                                   float scale) {
  __shared__ __align__(16) float pws[MAX_HEADS * ROW_CHUNK * KEYS];
  __shared__ __align__(16) float drs[MAX_HEADS * ROW_CHUNK * KEYS];
  const int D = H * hd, s0 = blockIdx.x * KEYS, b = blockIdx.y;
  const int c = blockIdx.z * blockDim.x + threadIdx.x, g = c / hd;
  const size_t rows_base = static_cast<size_t>(b) * T * D;
  float acc_v[KEYS] = {}, acc_k[KEYS] = {};
  for (int r0 = 0; r0 < T; r0 += ROW_CHUNK) {
    const int rows = min(ROW_CHUNK, T - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < H * ROW_CHUNK * KEYS; i += blockDim.x) {
      const int j = i % KEYS, t = i / KEYS % ROW_CHUNK, h = i / (KEYS * ROW_CHUNK);
      const bool in = t < rows && s0 + j < S;
      const size_t at = ((static_cast<size_t>(b) * H + h) * T + r0 + t) * S + s0 + j;
      pws[i] = in ? pw[at] : 0.0f;
      drs[i] = in ? draw[at] : 0.0f;
    }
    __syncthreads();
    if (c >= D) continue;
    for (int t = 0; t < rows; ++t) {
      const size_t at = rows_base + static_cast<size_t>(r0 + t) * D + c;
      const float gd = ld(dout, at, in_bf16), qq = ld(q, at, in_bf16) * scale;
      const float4* pr = reinterpret_cast<const float4*>(pws + (g * ROW_CHUNK + t) * KEYS);
      const float4* dr = reinterpret_cast<const float4*>(drs + (g * ROW_CHUNK + t) * KEYS);
#pragma unroll
      for (int j = 0; j < KEYS / 4; ++j) {
        const float4 a = pr[j], d = dr[j];
        acc_v[4 * j] = fmaf(a.x, gd, acc_v[4 * j]);
        acc_v[4 * j + 1] = fmaf(a.y, gd, acc_v[4 * j + 1]);
        acc_v[4 * j + 2] = fmaf(a.z, gd, acc_v[4 * j + 2]);
        acc_v[4 * j + 3] = fmaf(a.w, gd, acc_v[4 * j + 3]);
        acc_k[4 * j] = fmaf(d.x, qq, acc_k[4 * j]);
        acc_k[4 * j + 1] = fmaf(d.y, qq, acc_k[4 * j + 1]);
        acc_k[4 * j + 2] = fmaf(d.z, qq, acc_k[4 * j + 2]);
        acc_k[4 * j + 3] = fmaf(d.w, qq, acc_k[4 * j + 3]);
      }
    }
  }
  if (c >= D) return;
#pragma unroll
  for (int j = 0; j < KEYS; ++j) {
    if (s0 + j < S) {
      const size_t at = (static_cast<size_t>(b) * S + s0 + j) * D + c;
      st(dv, at, acc_v[j], in_bf16);
      st(dk, at, acc_k[j], in_bf16);
    }
  }
}

// out[j] = Σ_i partials[i][j] over the n row blocks, one block per value j.
__global__ void __launch_bounds__(REDUCE_THREADS)
th_param_reduce_kernel(const float* __restrict__ partials, int n, int nv, float* __restrict__ out) {
  __shared__ float warp_part[REDUCE_THREADS / 32];
  const int j = blockIdx.x;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += REDUCE_THREADS) acc += partials[static_cast<size_t>(i) * nv + j];
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
  int in_bf16;
  const float* mix;
  void *dq, *dk, *dv;
  float *pw, *draw, *partials, *dmix;
  int B, T, S, H, HD;
  float scale;
  cudaStream_t st;
};

template <int CH, int MH>
cudaError_t launch(const BwdArgs& a) {
  const int bq = rows_per_block(true, a.S, a.H, CH);
  if (bq == 0) return cudaErrorInvalidValue;
  const size_t smem = row_tile_smem(true, bq, a.S, a.H, CH);
  cudaError_t err = cudaFuncSetAttribute(th_bwd_rows_kernel<CH, MH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 rows_grid((a.T + bq - 1) / bq, a.B);
  th_bwd_rows_kernel<CH, MH><<<rows_grid, NT, smem, a.st>>>(
      a.q, a.k, a.v, a.dout, a.in_bf16, a.mix, a.dq, a.pw, a.draw, a.partials, a.T, a.S, a.H,
      a.HD, bq, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int D = a.H * a.HD, cols = D < KEY_COLUMNS ? D : KEY_COLUMNS;
  const dim3 keys_grid((a.S + KEYS - 1) / KEYS, a.B, (D + cols - 1) / cols);
  th_bwd_keys_kernel<<<keys_grid, cols, 0, a.st>>>(a.q, a.dout, a.in_bf16, a.pw, a.draw, a.dk,
                                                   a.dv, a.T, a.S, a.H, a.HD, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nv = 2 * a.H * a.H + 2 * a.H;
  th_param_reduce_kernel<<<nv, REDUCE_THREADS, 0, a.st>>>(a.partials, rows_grid.x * a.B, nv,
                                                          a.dmix);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_heads(const BwdArgs& a) {
  if (a.H <= 4) return launch<CH, 4>(a);
  if (a.H <= 8) return launch<CH, 8>(a);
  return launch<CH, 16>(a);
}

}  // namespace

extern "C" int vtt_talking_head_rows(int S, int H, int hd, int bwd);

// mix: ml (H²), mlb (H), mw (H²), mwb (H), f32. Scratch from the caller: pw
// and draw (B, H, T, S) f32, partials (B·⌈T/BQ⌉, 2H² + 2H) f32 with BQ =
// vtt_talking_head_rows(S, H, hd, 1). dmix (2H² + 2H) f32 receives dml,
// dmlb, dmw, dmwb in that order.
extern "C" int vtt_talking_head_bwd(const void* q, const void* k, const void* v, const void* dout,
                                    int in_bf16, const float* mix, void* dq, void* dk, void* dv,
                                    float* pw, float* draw, float* partials, float* dmix, int B,
                                    int T, int S, int H, int hd, float scale, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || T > MAX_SEQ || vtt_talking_head_rows(S, H, hd, 1) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{q, k, v, dout, in_bf16, mix, dq, dk, dv, pw, draw, partials, dmix,
                  B, T, S, H, hd, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  switch (head_chunk(hd)) {
#define VTT_TH_CHUNK(C) \
  case C:               \
    err = launch_heads<C>(a); \
    break;
    VTT_TH_CHUNK(64) VTT_TH_CHUNK(48) VTT_TH_CHUNK(16)
#undef VTT_TH_CHUNK
  }
  return static_cast<int>(err);
}
