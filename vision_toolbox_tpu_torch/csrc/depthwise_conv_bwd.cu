// Depthwise k×k convolution, backward (K9): from x (B, H, W, C), the
// weights (k, k, C) and the output cotangent g (x's type),
//   dx[b, h, w, c]  = Σ_dy Σ_dx gpad[b, h + dy, w + dx, c]·w[k − 1 − dy, k − 1 − dx, c]
//                     (the forward kernel on g with the flipped weights),
//   dw[dy, dx, c]   = Σ_b Σ_h Σ_w xpad[b, h + dy, w + dx, c]·g[b, h, w, c]  (f32, in w's type).
//
// Replaces vision_toolbox_tpu/ops/depthwise_conv.py `_dw_bwd` (`_bwd_kernel`).
// The TPU kernel carries dw in a VMEM block along its sequential batch
// axis. Hopper blocks run in no order, so dw is two launches, with no
// atomics and the same result on every run:
//   (i)  each block walks TILES_PER_BLOCK output tiles of one image and one
//        channel block, stages the x halo and the g tile in shared memory,
//        and sums xpad·g per tap in f32 (for k ∈ {3, 5, 7} in registers, one
//        row of the tile per warp, the rows then added in a fixed order);
//        it writes its (k², CB) partial to device memory, (P, k², C) in all
//        with P = B · ceil(tiles / TILES_PER_BLOCK);
//   (ii) one thread per (tap, channel) adds the P partials in order and
//        rounds once to w's type.
// What bounds it: the dx pass is the forward's work; the dw pass reads x
// and g once (2·k² operations per element of g) and writes the partials
// (4·P·k²·C bytes: 2.4 MB at ConvNeXt-T stage 1, bs128, against 154 MB of
// bf16 x and g). Both are operation-bound at k = 7, like the forward.
#include "depthwise_conv.cuh"

using namespace vtt;

namespace {

using dw::CB;
using dw::NT;
using dw::TH;
using dw::TILES_PER_BLOCK;
using dw::TW;

inline size_t wgrad_smem_bytes(int k) {
  return (dw::halo_floats(k) + TH * TW * CB + k * k * CB) * sizeof(float);
}

inline int wgrad_blocks_x(int H, int W) {
  return (dw::tiles_h(H) * dw::tiles_w(W) + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK;
}

// Block partials of dw. Grid (wgrad_blocks_x, ceil(C / CB), B), NT threads,
// wgrad_smem_bytes(k) of dynamic shared memory. K = 0 reads k at run time
// and gives each warp whole taps of the tile instead of a row.
template <typename TX, int K>
__global__ void __launch_bounds__(NT)
dw_wgrad_kernel(const TX* __restrict__ x, const TX* __restrict__ g, float* __restrict__ partials,
                int H, int W, int C, int k_rt, int n_tiles, int tiles_w) {
  extern __shared__ float smem[];
  const int k = K > 0 ? K : k_rt, kk = k * k, pw = TW + k - 1;
  float* xs = smem;
  float* gs = smem + dw::halo_floats(k);
  float* part = gs + TH * TW * CB;
  const int c0 = blockIdx.y * CB, b = blockIdx.z;
  const int c = threadIdx.x % CB, r = threadIdx.x / CB;
  const int tile_end = min((static_cast<int>(blockIdx.x) + 1) * TILES_PER_BLOCK, n_tiles);

  float acc[K > 0 ? K * K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) acc[t] = 0.0f;
  } else {
    for (int t = r; t < kk; t += TH) part[t * CB + c] = 0.0f;  // tap t is warp (t % TH)'s
  }
  for (int tile = blockIdx.x * TILES_PER_BLOCK; tile < tile_end; ++tile) {
    const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
    __syncthreads();  // the previous tile's reads are done
    dw::load_halo(x, b, h0, w0, c0, H, W, C, k, xs);
    for (int i = r; i < TH * TW; i += TH) {
      const int h = h0 + i / TW, w = w0 + i % TW;
      float v = 0.0f;
      if (c0 + c < C && h < H && w < W) {
        v = dw::ld(g, ((static_cast<size_t>(b) * H + h) * W + w) * C + c0 + c);
      }
      gs[i * CB + c] = v;
    }
    __syncthreads();
    if constexpr (K > 0) {
      float gr[TW];
#pragma unroll
      for (int j = 0; j < TW; ++j) gr[j] = gs[(r * TW + j) * CB + c];
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const float* row = xs + (r + dy) * pw * CB + c;
        float xr[TW + K - 1];
#pragma unroll
        for (int j = 0; j < TW + K - 1; ++j) xr[j] = row[j * CB];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          float s = acc[dy * K + dx];
#pragma unroll
          for (int j = 0; j < TW; ++j) s = fmaf(xr[j + dx], gr[j], s);
          acc[dy * K + dx] = s;
        }
      }
    } else {
      for (int t = r; t < kk; t += TH) {
        const int dy = t / k, dx = t % k;
        float s = part[t * CB + c];
        for (int rr = 0; rr < TH; ++rr) {
#pragma unroll
          for (int j = 0; j < TW; ++j) {
            s = fmaf(xs[((rr + dy) * pw + j + dx) * CB + c], gs[(rr * TW + j) * CB + c], s);
          }
        }
        part[t * CB + c] = s;
      }
    }
  }
  if constexpr (K > 0) {  // the rows' sums, added in row order
    for (int rr = 0; rr < TH; ++rr) {
      if (r == rr) {
#pragma unroll
        for (int t = 0; t < K * K; ++t) part[t * CB + c] = rr == 0 ? acc[t] : part[t * CB + c] + acc[t];
      }
      __syncthreads();
    }
  } else {
    __syncthreads();
  }
  if (c0 + c >= C) return;
  float* out = partials + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kk * C + c0 + c;
  for (int t = r; t < kk; t += TH) out[static_cast<size_t>(t) * C] = part[t * CB + c];
}

// dw[i] = Σ_p partials[p, i] in order p = 0..P−1, rounded once to w's type;
// i runs over the k²·C taps and channels.
template <typename TWt>
__global__ void __launch_bounds__(256)
dw_reduce_kernel(const float* __restrict__ partials, TWt* __restrict__ dwt, int P, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += partials[static_cast<size_t>(p) * n + i];
  dw::st(dwt, i, s);
}

template <typename TX, int K>
cudaError_t launch_wgrad_k(const void* x, const void* g, float* partials, int B, int H, int W,
                           int C, int k, cudaStream_t st) {
  const size_t smem = wgrad_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(dw_wgrad_kernel<TX, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(wgrad_blocks_x(H, W), (C + CB - 1) / CB, B);
  dw_wgrad_kernel<TX, K><<<grid, NT, smem, st>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(g), partials, H, W, C, k,
      dw::tiles_h(H) * dw::tiles_w(W), dw::tiles_w(W));
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_wgrad(const void* x, const void* g, float* partials, int B, int H, int W,
                         int C, int k, cudaStream_t st) {
  switch (k) {
    case 3: return launch_wgrad_k<TX, 3>(x, g, partials, B, H, W, C, k, st);
    case 5: return launch_wgrad_k<TX, 5>(x, g, partials, B, H, W, C, k, st);
    case 7: return launch_wgrad_k<TX, 7>(x, g, partials, B, H, W, C, k, st);
    default: return launch_wgrad_k<TX, 0>(x, g, partials, B, H, W, C, k, st);
  }
}

}  // namespace

// Floats of the dw partials scratch the caller allocates for vtt_dw_bwd.
extern "C" long long vtt_dw_partial_floats(int B, int H, int W, int C, int k) {
  return static_cast<long long>(B) * wgrad_blocks_x(H, W) * k * k * C;
}

extern "C" int vtt_dw_bwd(const void* x, const void* g, const void* w, void* dx, void* dwt,
                          float* partials, int x_bf16, int w_bf16, int B, int H, int W, int C,
                          int k, void* stream) {
  if (!dw::shape_ok(B, H, W, C, k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dw::launch_conv_typed(g, w, dx, x_bf16, w_bf16, B, H, W, C, k, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = x_bf16 ? launch_wgrad<dw::bf16>(x, g, partials, B, H, W, C, k, st)
               : launch_wgrad<float>(x, g, partials, B, H, W, C, k, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = k * k * C, P = B * wgrad_blocks_x(H, W);
  if (w_bf16) {
    dw_reduce_kernel<dw::bf16><<<(n + 255) / 256, 256, 0, st>>>(
        partials, static_cast<dw::bf16*>(dwt), P, n);
  } else {
    dw_reduce_kernel<float><<<(n + 255) / 256, 256, 0, st>>>(partials, static_cast<float*>(dwt),
                                                             P, n);
  }
  return static_cast<int>(cudaGetLastError());
}
