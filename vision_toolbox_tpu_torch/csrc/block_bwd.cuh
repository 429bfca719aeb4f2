// Row kernels shared by the two half-block backward files
// (block_mlp_bwd.cu, block_attention_bwd.cu): the scaled output cotangent at
// the start of the backward, the LayerNorm backward at its end, and the
// fixed-order sum of every column-sum partial.
//
// The first two are bound by device-memory bytes (a few flops per element
// read). The TPU kernels carry the column sums (bias, LayerScale and
// LayerNorm gradients) in constant-index f32 output blocks along their
// sequential grid; Hopper blocks run in no order, so each block sums its
// rows in f32 and writes the partial as one row of an f32 scratch (the
// wrapper's torch.empty), and colsum_kernel adds each scratch's rows in a
// fixed order at the end of the backward. No atomics: a second backward
// repeats the first bit for bit.
#pragma once

#include "gemm.cuh"

namespace vtt {

constexpr int ROW_THREADS = 256;
constexpr int DOUTS_ROWS = 64;  // rows summed per block into one partial row
constexpr int LN_ROWS = 32;  // rows a block of the LayerNorm backward, a warp a row at a time
constexpr int LN_WARPS = 8;

// douts = bf16(dout·dp·γ_ls) (M, D); the partial row Σ_rows dout·dp·γ_ls (f32,
// before the rounding) into dbias_part[blockIdx.y]; with `saved` (the
// pre-scale projection, bf16) also Σ_rows dout·dp·saved into dls_part.
// Blocks of min(ROW_THREADS, D rounded up to a warp) threads, one column a
// thread, grid (ceil(D / threads), ceil(M / DOUTS_ROWS)) (block_mlp.py /
// block_attention.py _bwd_kernel, the douts / db2 / dγ_ls lines).
template <typename TX>
__global__ void __launch_bounds__(ROW_THREADS)
douts_kernel(const TX* __restrict__ dout, const float* __restrict__ dp, Vec ls,
             const bf16* __restrict__ saved, bf16* __restrict__ douts,
             float* __restrict__ dbias_part, float* __restrict__ dls_part, int M, int D, int T) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
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
  const size_t p = static_cast<size_t>(blockIdx.y) * D + c;
  dbias_part[p] = sb;
  if (saved != nullptr) dls_part[p] = sl;
}

// LayerNorm backward from the saved xhat (bf16) and rstd:
//   dxh = dy·γ_ln;  dx = rstd·(dxh − mean(dxh) − xhat·mean(dxh·xhat)) (+ dout),
//   partial rows Σ_rows dy·xhat (dγ_ln) and Σ_rows dy (dβ_ln).
// A block of LN_WARPS warps takes LN_ROWS rows, a warp a whole row at a
// time (lane-strided columns, the means by the xor tree, so no block
// barrier a row: at D = 96 a row is three values a lane); each warp keeps
// its column partials in its own 2·D floats of shared memory, which the
// block adds in warp order into row blockIdx.x of dlns_part and dlnb_part.
// Grid ceil(M / LN_ROWS), dynamic shared memory ln_bwd_smem_bytes(D).
template <typename TX>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bwd_kernel(const float* __restrict__ dy, const bf16* __restrict__ xhat,
              const float* __restrict__ rstd, Vec lns, const TX* __restrict__ dout,
              TX* __restrict__ dx, float* __restrict__ dlns_part, float* __restrict__ dlnb_part,
              int M, int D) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_g = sm + static_cast<size_t>(warp) * 2 * D;
  float* s_b = s_g + D;
  for (int c = lane; c < D; c += 32) s_g[c] = s_b[c] = 0.0f;
  const int m0 = blockIdx.x * LN_ROWS;
  for (int m = m0 + warp; m < min(m0 + LN_ROWS, M); m += LN_WARPS) {
    const float* dyr = dy + static_cast<size_t>(m) * D;
    const bf16* xr = xhat + static_cast<size_t>(m) * D;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < D; c += 32) {
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
    const float mean1 = s1 / D, mean2 = s2 / D, rs = rstd[m];
    for (int c = lane; c < D; c += 32) {
      const float xh = __bfloat162float(xr[c]);
      const float dxh = __fmul_rn(dyr[c], ldv(lns, c, 1.0f));
      float v = __fmul_rn(rs, __fsub_rn(__fsub_rn(dxh, mean1), __fmul_rn(xh, mean2)));
      const size_t o = static_cast<size_t>(m) * D + c;
      if (dout != nullptr) v = __fadd_rn(to_f32(dout[o]), v);
      dx[o] = from_f32<TX>(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += LN_WARPS * 32) {
    float g = 0.0f, b = 0.0f;
#pragma unroll
    for (int w = 0; w < LN_WARPS; ++w) {
      g += sm[static_cast<size_t>(w) * 2 * D + c];
      b += sm[static_cast<size_t>(w) * 2 * D + D + c];
    }
    const size_t p = static_cast<size_t>(blockIdx.x) * D + c;
    dlns_part[p] = g;
    dlnb_part[p] = b;
  }
}

inline size_t ln_bwd_smem_bytes(int D) {
  return static_cast<size_t>(LN_WARPS) * 2 * D * sizeof(float);
}

// The widths the row kernels take: the LayerNorm backward's partials fit a
// block's shared memory (D ≤ 3632).
inline bool row_kernels_take(int D) { return ln_bwd_smem_bytes(D) <= 227 * 1024; }

// Launches douts_kernel; returns the launch's error.
template <typename TX>
inline cudaError_t launch_douts(const void* dout, const float* dp, Vec ls, const void* saved,
                                void* douts, float* dbias_part, float* dls_part, int M, int D,
                                int T, cudaStream_t st) {
  const int threads = min(ROW_THREADS, (D + 31) / 32 * 32);
  const dim3 grid((D + threads - 1) / threads, (M + DOUTS_ROWS - 1) / DOUTS_ROWS);
  douts_kernel<TX><<<grid, threads, 0, st>>>(
      static_cast<const TX*>(dout), dp, ls, static_cast<const bf16*>(saved),
      static_cast<bf16*>(douts), dbias_part, dls_part, M, D, T);
  return cudaGetLastError();
}

// Launches ln_bwd_kernel; `dout` null for a separate residual (dx = dx_ln).
template <typename TX>
inline cudaError_t launch_ln_bwd(const float* dy, const void* xhat, const float* rstd, Vec lns,
                                 const void* dout, void* dx, float* dlns_part, float* dlnb_part,
                                 int M, int D, cudaStream_t st) {
  const size_t smem = ln_bwd_smem_bytes(D);
  if (smem > 48 * 1024) {  // D > 768
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ln_bwd_kernel<TX><<<(M + LN_ROWS - 1) / LN_ROWS, LN_WARPS * 32, smem, st>>>(
      dy, static_cast<const bf16*>(xhat), rstd, lns, static_cast<const TX*>(dout),
      static_cast<TX*>(dx), dlns_part, dlnb_part, M, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The column sums: out[n] = Σ_p part[p, n], p = 0 … P − 1, in a fixed order
// (thread row r adds p = r, r + SUM_ROWS, … in turn, then the SUM_ROWS row
// sums in turn), for up to MAX_SUMS (part, out) pairs in one launch.

constexpr int MAX_SUMS = 5;
constexpr int SUM_COLS = 32, SUM_ROWS = 32;

struct ColSum {
  const float* part;  // (P, N) f32
  float* out;         // (N,) f32
  int P, N;
};

struct ColSums {
  ColSum s[MAX_SUMS];
  int n;
};

// Blocks of SUM_COLS × SUM_ROWS threads; block b takes the b-th column tile
// of the sums in order. Static: each backward file has its own copy.
static __global__ void __launch_bounds__(SUM_COLS * SUM_ROWS)
colsum_kernel(const __grid_constant__ ColSums cs) {
  __shared__ float red[SUM_ROWS][SUM_COLS + 1];
  int b = blockIdx.x, i = 0;
  while (i < cs.n && b >= (cs.s[i].N + SUM_COLS - 1) / SUM_COLS) {
    b -= (cs.s[i].N + SUM_COLS - 1) / SUM_COLS;
    ++i;
  }
  if (i >= cs.n) return;
  const ColSum& c = cs.s[i];
  const int tx = threadIdx.x % SUM_COLS, ty = threadIdx.x / SUM_COLS;
  const int col = b * SUM_COLS + tx;
  float acc = 0.0f;
  if (col < c.N) {
    for (int p = ty; p < c.P; p += SUM_ROWS) acc += c.part[static_cast<size_t>(p) * c.N + col];
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < c.N) {
    float t = 0.0f;
#pragma unroll
    for (int r = 0; r < SUM_ROWS; ++r) t += red[r][tx];
    c.out[col] = t;
  }
}

// Launches colsum_kernel over the pairs whose output is not null.
inline cudaError_t launch_colsums(const ColSum* sums, int n, cudaStream_t st) {
  ColSums cs{};
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (sums[i].out == nullptr) continue;
    cs.s[cs.n++] = sums[i];
    blocks += (sums[i].N + SUM_COLS - 1) / SUM_COLS;
  }
  if (blocks == 0) return cudaSuccess;
  colsum_kernel<<<blocks, SUM_COLS * SUM_ROWS, 0, st>>>(cs);
  return cudaGetLastError();
}

}  // namespace vtt
