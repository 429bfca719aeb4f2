// Row kernels shared by the two half-block backward files
// (block_mlp_bwd.cu, block_attention_bwd.cu): the scaled output cotangent at
// the start of the backward and the LayerNorm backward at its end.
//
// Both are bound by device-memory bytes (a few flops per element read). The
// TPU kernels carry the column sums (bias, LayerScale and LayerNorm
// gradients) in constant-index f32 output blocks along their sequential
// grid; Hopper blocks run in no order, so each block sums its rows in f32 and
// adds the partial to the f32 output with one atomicAdd per column. The
// order of those additions changes from run to run: the column sums are held
// to their plain versions by relative L2, not bit for bit.
#pragma once

#include "gemm.cuh"

namespace vtt {

constexpr int ROW_THREADS = 256;
constexpr int DOUTS_ROWS = 64;  // rows summed per block before the atomics
constexpr int LN_ROWS = 32;

// douts = bf16(dout·dp·γ_ls) (M, D); dbias += Σ_rows dout·dp·γ_ls (f32, before
// the rounding); with `saved` (the pre-scale projection, bf16) also
// dls += Σ_rows dout·dp·saved. Grid (ceil(D / ROW_THREADS), ceil(M / DOUTS_ROWS)),
// one column per thread (block_mlp.py / block_attention.py _bwd_kernel,
// the douts / db2 / dγ_ls lines).
template <typename TX>
__global__ void __launch_bounds__(ROW_THREADS)
douts_kernel(const TX* __restrict__ dout, const float* __restrict__ dp, Vec ls,
             const bf16* __restrict__ saved, bf16* __restrict__ douts, float* __restrict__ dbias,
             float* __restrict__ dls, int M, int D, int T) {
  const int c = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (c >= D) return;
  const int m0 = blockIdx.y * DOUTS_ROWS;
  const int m1 = min(m0 + DOUTS_ROWS, M);
  const float g = ldv(ls, c, 1.0f);
  float sb = 0.0f, sl = 0.0f;
  for (int m = m0; m < m1; ++m) {
    const size_t o = static_cast<size_t>(m) * D + c;
    float d = to_f32(dout[o]);
    if (dp != nullptr) d = __fmul_rn(d, dp[m / T]);
    const float s = __fmul_rn(d, g);
    douts[o] = __float2bfloat16(s);
    sb += s;
    if (saved != nullptr) sl = __fadd_rn(sl, __fmul_rn(d, __bfloat162float(saved[o])));
  }
  atomicAdd(dbias + c, sb);
  if (dls != nullptr) atomicAdd(dls + c, sl);
}

// LayerNorm backward from the saved xhat (bf16) and rstd:
//   dxh = dy·γ_ln;  dx = rstd·(dxh − mean(dxh) − xhat·mean(dxh·xhat)) (+ dout),
//   dγ_ln += Σ_rows dy·xhat,  dβ_ln += Σ_rows dy.
// One block of ROW_THREADS threads walks LN_ROWS whole rows (the means need
// the full D-row); the column partials sit in shared memory, 2·D floats.
// Grid ceil(M / LN_ROWS), dynamic shared memory ln_bwd_smem_bytes(D).
template <typename TX>
__global__ void __launch_bounds__(ROW_THREADS)
ln_bwd_kernel(const float* __restrict__ dy, const bf16* __restrict__ xhat,
              const float* __restrict__ rstd, Vec lns, const TX* __restrict__ dout,
              TX* __restrict__ dx, float* __restrict__ dlns, float* __restrict__ dlnb, int M,
              int D) {
  extern __shared__ float sm[];
  float* s_g = sm;
  float* s_b = sm + D;
  float* red = sm + 2 * D;  // 2 × 8 warp partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < D; c += ROW_THREADS) s_g[c] = s_b[c] = 0.0f;
  const int m0 = blockIdx.x * LN_ROWS;
  const int m1 = min(m0 + LN_ROWS, M);
  for (int m = m0; m < m1; ++m) {
    const float* dyr = dy + static_cast<size_t>(m) * D;
    const bf16* xr = xhat + static_cast<size_t>(m) * D;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = threadIdx.x; c < D; c += ROW_THREADS) {
      const float d = dyr[c], xh = __bfloat162float(xr[c]);
      const float dxh = __fmul_rn(d, ldv(lns, c, 1.0f));
      s1 += dxh;
      s2 = __fadd_rn(s2, __fmul_rn(dxh, xh));
      s_g[c] = __fadd_rn(s_g[c], __fmul_rn(d, xh));
      s_b[c] += d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      red[warp] = s1;
      red[8 + warp] = s2;
    }
    __syncthreads();
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int w = 0; w < ROW_THREADS / 32; ++w) {
      t1 += red[w];
      t2 += red[8 + w];
    }
    const float mean1 = t1 / D, mean2 = t2 / D, rs = rstd[m];
    for (int c = threadIdx.x; c < D; c += ROW_THREADS) {
      const float xh = __bfloat162float(xr[c]);
      const float dxh = __fmul_rn(dyr[c], ldv(lns, c, 1.0f));
      float v = __fmul_rn(rs, __fsub_rn(__fsub_rn(dxh, mean1), __fmul_rn(xh, mean2)));
      const size_t o = static_cast<size_t>(m) * D + c;
      if (dout != nullptr) v = __fadd_rn(to_f32(dout[o]), v);
      dx[o] = from_f32<TX>(v);
    }
    __syncthreads();  // `red` is rewritten for the next row
  }
  for (int c = threadIdx.x; c < D; c += ROW_THREADS) {
    atomicAdd(dlns + c, s_g[c]);
    atomicAdd(dlnb + c, s_b[c]);
  }
}

inline size_t ln_bwd_smem_bytes(int D) { return (2 * static_cast<size_t>(D) + 16) * sizeof(float); }

// Launches douts_kernel; returns the launch's error.
template <typename TX>
inline cudaError_t launch_douts(const void* dout, const float* dp, Vec ls, const void* saved,
                                void* douts, float* dbias, float* dls, int M, int D, int T,
                                cudaStream_t st) {
  const dim3 grid((D + ROW_THREADS - 1) / ROW_THREADS, (M + DOUTS_ROWS - 1) / DOUTS_ROWS);
  douts_kernel<TX><<<grid, ROW_THREADS, 0, st>>>(
      static_cast<const TX*>(dout), dp, ls, static_cast<const bf16*>(saved),
      static_cast<bf16*>(douts), dbias, dls, M, D, T);
  return cudaGetLastError();
}

// Launches ln_bwd_kernel; `dout` null for a separate residual (dx = dx_ln).
template <typename TX>
inline cudaError_t launch_ln_bwd(const float* dy, const void* xhat, const float* rstd, Vec lns,
                                 const void* dout, void* dx, float* dlns, float* dlnb, int M,
                                 int D, cudaStream_t st) {
  const size_t smem = ln_bwd_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(ln_bwd_kernel<TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<TX><<<(M + LN_ROWS - 1) / LN_ROWS, ROW_THREADS, smem, st>>>(
      dy, static_cast<const bf16*>(xhat), rstd, lns, static_cast<const TX*>(dout),
      static_cast<TX*>(dx), dlns, dlnb, M, D);
  return cudaGetLastError();
}

}  // namespace vtt
