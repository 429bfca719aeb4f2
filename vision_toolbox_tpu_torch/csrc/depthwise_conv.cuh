// Depthwise k×k convolution, stride 1, SAME padding (odd k), on NHWC
// tensors: the shared tile layout, the halo loader and the forward kernel
// (K9). depthwise_conv.cu launches the forward; depthwise_conv_bwd.cu
// launches it again on the output cotangent with the flipped kernel (dx) and
// adds the weight-gradient kernels.
//
// Replaces the TPU kernels of vision_toolbox_tpu/ops/depthwise_conv.py
// (`_dw_fwd` / `_fwd_kernel`, `_dw_bwd` / `_bwd_kernel`). The TPU kernel
// pads the input in device memory (jnp.pad, a TPU layout need) and holds a
// group of whole padded images per channel block in VMEM. Here a block owns
// an output tile of TH × TW pixels × CB channels of one image: the tile plus
// its k − 1 halo is staged in shared memory as f32, with zeros outside the
// image, so no padded copy of x exists. Channels are the contiguous NHWC
// axis: lane c of every warp owns channel c0 + c, so a warp reads and writes
// 32 neighbouring channels of one pixel. Warp r owns output row r of the
// tile and keeps its TW accumulators in registers; for each kernel row the
// TW + k − 1 inputs of that row are read once from shared memory into
// registers (k ∈ {3, 5, 7} compiled as constants; any other odd k ≤ MAX_K
// reads shared memory per tap).
//
// Rounding points are the TPU kernel's: every tap in f32, summed with dy
// outer and dx inner into one f32 accumulator per output, rounded once to
// x's type. A tap is a product then a sum, each rounded (the plain version's
// `acc + x·w`); with bf16 x and w the product is exact in f32, so that case
// uses one fused multiply-add, which rounds identically.
//
// What bounds it on an H100: 2·k² operations per output element against
// one read and one write of it; at ConvNeXt-T stage 1, bs128 (38.5 M
// elements, k = 7) 3.78 GFLOP, 0.056 ms at the 67 TFLOP/s f32 rate, above
// the 0.046 ms that its 154 MB of bf16 take at 3.35 TB/s. This first
// version stages f32 halos (the halo re-reads (TH + k − 1)(TW + k − 1) / TH·TW
// = 2.4× of the input at k = 7 from L2) and runs one channel per lane;
// bf16-pair lanes, cp.async halos and register blocking over rows are the
// levers for later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vtt {
namespace dw {

using bf16 = __nv_bfloat16;

constexpr int CB = 32;            // channels per block: one per lane
constexpr int TH = 8, TW = 16;    // output tile: one row per warp, TW pixels a thread
constexpr int NT = CB * TH;       // threads per block
constexpr int MAX_K = 21;         // the weight-gradient kernel's tiles fit 227 KB
constexpr int TILES_PER_BLOCK = 4;  // weight gradient: output tiles one block walks

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }

__host__ __device__ inline int halo_floats(int k) { return (TH + k - 1) * (TW + k - 1) * CB; }
inline size_t fwd_smem_bytes(int k) { return (halo_floats(k) + k * k * CB) * sizeof(float); }

// One tap, acc + a·b: fused where the product is exact in f32 (bf16 × bf16),
// else the product and the sum each rounded.
template <bool kExact>
__device__ __forceinline__ float tap(float acc, float a, float b) {
  if constexpr (kExact) {
    return fmaf(a, b, acc);
  } else {
    return __fadd_rn(acc, __fmul_rn(a, b));
  }
}

// The (TH + k − 1) × (TW + k − 1) patch around the output tile at (h0, w0),
// channels [c0, c0 + CB) of image b, into shared memory as f32 (pitch CB per
// pixel): zeros outside the image and past C.
template <typename TX>
__device__ __forceinline__ void load_halo(const TX* __restrict__ x, int b, int h0, int w0, int c0,
                                          int H, int W, int C, int k, float* xs) {
  const int p = k / 2, pw = TW + k - 1, n = (TH + k - 1) * pw;
  const int c = threadIdx.x % CB;
  const bool valid_c = c0 + c < C;
  for (int i = threadIdx.x / CB; i < n; i += TH) {
    const int h = h0 - p + i / pw, w = w0 - p + i % pw;
    float v = 0.0f;
    if (valid_c && h >= 0 && h < H && w >= 0 && w < W) {
      v = ld(x, ((static_cast<size_t>(b) * H + h) * W + w) * C + c0 + c);
    }
    xs[i * CB + c] = v;
  }
}

// y[b, h, w, c] = Σ_dy Σ_dx x[b, h + dy − p, w + dx − p, c]·w[dy, dx, c]
// (w[k − 1 − dy, k − 1 − dx, c] with `flip`: the backward's dx). Grid
// (tiles_h · tiles_w, ceil(C / CB), B), NT threads, fwd_smem_bytes(k) of
// dynamic shared memory; K = 0 reads k at run time.
template <typename TX, typename TWt, int K>
__global__ void __launch_bounds__(NT)
dw_conv_kernel(const TX* __restrict__ x, const TWt* __restrict__ wt, TX* __restrict__ y, int H,
               int W, int C, int k_rt, int flip, int tiles_w) {
  extern __shared__ float smem[];
  constexpr bool kExact = sizeof(TX) == 2 && sizeof(TWt) == 2;
  const int k = K > 0 ? K : k_rt;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int c0 = blockIdx.y * CB, b = blockIdx.z;
  const int c = threadIdx.x % CB, r = threadIdx.x / CB;
  float* xs = smem;
  float* ws = smem + halo_floats(k);
  for (int t = r; t < k * k; t += TH) {
    const int src = flip ? k * k - 1 - t : t;
    ws[t * CB + c] = c0 + c < C ? ld(wt, static_cast<size_t>(src) * C + c0 + c) : 0.0f;
  }
  load_halo(x, b, h0, w0, c0, H, W, C, k, xs);
  __syncthreads();

  float acc[TW];
#pragma unroll
  for (int j = 0; j < TW; ++j) acc[j] = 0.0f;
  const int pw = TW + k - 1;
  for (int dy = 0; dy < k; ++dy) {
    const float* row = xs + (r + dy) * pw * CB + c;
    if constexpr (K > 0) {
      float xr[TW + K - 1];
#pragma unroll
      for (int j = 0; j < TW + K - 1; ++j) xr[j] = row[j * CB];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float wv = ws[(dy * K + dx) * CB + c];
#pragma unroll
        for (int j = 0; j < TW; ++j) acc[j] = tap<kExact>(acc[j], xr[j + dx], wv);
      }
    } else {
      for (int dx = 0; dx < k; ++dx) {
        const float wv = ws[(dy * k + dx) * CB + c];
#pragma unroll
        for (int j = 0; j < TW; ++j) acc[j] = tap<kExact>(acc[j], row[(j + dx) * CB], wv);
      }
    }
  }
  const int h = h0 + r;
  if (h >= H || c0 + c >= C) return;
  const size_t base = (static_cast<size_t>(b) * H + h) * W * C + c0 + c;
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    if (w0 + j < W) st(y, base + static_cast<size_t>(w0 + j) * C, acc[j]);
  }
}

inline int tiles_h(int H) { return (H + TH - 1) / TH; }
inline int tiles_w(int W) { return (W + TW - 1) / TW; }

inline bool shape_ok(int B, int H, int W, int C, int k) {
  return B > 0 && H > 0 && W > 0 && C > 0 && k % 2 == 1 && k >= 1 && k <= MAX_K &&
         B <= 65535 && (C + CB - 1) / CB <= 65535 &&
         static_cast<long long>(tiles_h(H)) * tiles_w(W) <= 0x7fffffffLL;
}

template <typename TX, typename TWt, int K>
inline cudaError_t launch_conv_k(const void* x, const void* wt, void* y, int B, int H, int W,
                                 int C, int k, int flip, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(dw_conv_kernel<TX, TWt, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_h(H) * tiles_w(W), (C + CB - 1) / CB, B);
  dw_conv_kernel<TX, TWt, K><<<grid, NT, smem, st>>>(
      static_cast<const TX*>(x), static_cast<const TWt*>(wt), static_cast<TX*>(y), H, W, C, k,
      flip, tiles_w(W));
  return cudaGetLastError();
}

// The forward kernel for k, with k ∈ {3, 5, 7} compiled as constants.
template <typename TX, typename TWt>
inline cudaError_t launch_conv(const void* x, const void* wt, void* y, int B, int H, int W, int C,
                               int k, int flip, cudaStream_t st) {
  switch (k) {
    case 3: return launch_conv_k<TX, TWt, 3>(x, wt, y, B, H, W, C, k, flip, st);
    case 5: return launch_conv_k<TX, TWt, 5>(x, wt, y, B, H, W, C, k, flip, st);
    case 7: return launch_conv_k<TX, TWt, 7>(x, wt, y, B, H, W, C, k, flip, st);
    default: return launch_conv_k<TX, TWt, 0>(x, wt, y, B, H, W, C, k, flip, st);
  }
}

// Dispatch on the stored types of x (and the output) and of the weights.
inline cudaError_t launch_conv_typed(const void* x, const void* wt, void* y, int x_bf16,
                                     int w_bf16, int B, int H, int W, int C, int k, int flip,
                                     cudaStream_t st) {
  if (x_bf16) {
    return w_bf16 ? launch_conv<bf16, bf16>(x, wt, y, B, H, W, C, k, flip, st)
                  : launch_conv<bf16, float>(x, wt, y, B, H, W, C, k, flip, st);
  }
  return w_bf16 ? launch_conv<float, bf16>(x, wt, y, B, H, W, C, k, flip, st)
                : launch_conv<float, float>(x, wt, y, B, H, W, C, k, flip, st);
}

}  // namespace dw
}  // namespace vtt
