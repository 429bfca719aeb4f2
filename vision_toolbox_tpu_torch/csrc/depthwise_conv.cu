// Depthwise k×k convolution, forward (K9): y = x ⊛ w, stride 1, SAME, NHWC
// x (B, H, W, C) in f32 or bf16, weights (k, k, C) in the compute type, y in
// x's type: the kernel, which depthwise_conv_bwd.cu also launches for dx,
// and its launcher. Replaces vision_toolbox_tpu/ops/depthwise_conv.py
// `_dw_fwd` (`_fwd_kernel`); the design, the rounding points and what bounds
// it are in depthwise_conv.cuh.
#include "depthwise_conv.cuh"

namespace vtt {
namespace dw {

// y[b, h, w, c] = Σ_dy Σ_dx x[b, h + dy − p, w + dx − p, c]·w[dy, dx, c]
// (w[k − 1 − dy, k − 1 − dx, c] with g.flip: the backward's dx). Grid
// (g.P, channel groups), 32·g.nw() threads; K = 0 reads k at run time.
template <typename TX, typename TWt, int K>
__global__ void __launch_bounds__(NT_MAX, sizeof(TX) == 2 && sizeof(TWt) == 2 ? MIN_BLOCKS : 1)
dw_conv_kernel(const TX* __restrict__ x, const TWt* __restrict__ wt, TX* __restrict__ y,
               Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kExact = sizeof(TX) == 2 && sizeof(TWt) == 2;
  constexpr bool kStoreTile = sizeof(TX) == 2;  // outputs through shared memory when g.wide
  const int k = K > 0 ? K : g.k, c0 = blockIdx.y * CG, c = c0 + threadIdx.x % 32;
  const int hcols = g.halo_cols(), stage_elems = g.halo_elems();
  const int trows = g.wr * TR, tcols = g.wc * TC, out_elems = kStoreTile ? g.tile_elems() : 0;
  TX* stages = reinterpret_cast<TX*>(smem_raw);
  TX* outs = stages + static_cast<size_t>(g.stages) * stage_elems;
  float wreg[K > 0 ? K * K : 1];
  float* ws = reinterpret_cast<float*>(
      smem_raw +
      ((static_cast<size_t>(g.stages) * stage_elems + out_elems) * sizeof(TX) + 15) / 16 * 16);
  load_weights<K>(wt, g, c, g.flip, wreg, ws);
  const WarpTile wt_ = warp_tile(g);
  const int first = blockIdx.x * g.per_block;
  ring(
      g, first, min(first + g.per_block, g.n_regions),
      [&](int r, int s) {
        const Origin o = region_origin(g, r);
        stage_patch(x, stages + static_cast<size_t>(s) * stage_elems, g, o.b0, o.h0, o.w0, c0,
                    g.halo_rows(), hcols, k / 2);
      },
      [&](int r, int s) {
        const Origin o = region_origin(g, r);
        float acc[TR][TC];
        conv_tile<kExact, K>(halo_corner(stages + static_cast<size_t>(s) * stage_elems, g, hcols),
                             hcols, wreg, ws + threadIdx.x % 32, k, acc);
        if (kStoreTile && g.wide) {
          TX* ot = outs + (static_cast<size_t>(wt_.img * trows + wt_.tr * TR) * tcols +
                           wt_.tc * TC) * CG + threadIdx.x % 32;
#pragma unroll
          for (int r_ = 0; r_ < TR; ++r_) {
#pragma unroll
            for (int j = 0; j < TC; ++j) st(ot, (r_ * tcols + j) * CG, acc[r_][j]);
          }
          __syncthreads();
          copy_out(y, outs, g, o.b0, o.h0, o.w0, c0, trows, tcols);
        } else {
          store_tile(y, g, o.b0 + wt_.img, o.h0 + wt_.tr * TR, o.w0 + wt_.tc * TC, c, acc);
        }
      });
}

template <typename TX, typename TWt, int K>
inline cudaError_t conv_k(const void* x, const void* wt, void* y, Geo& g, bool launch,
                          size_t* smem, cudaStream_t st) {
  const void* kernel = reinterpret_cast<const void*>(dw_conv_kernel<TX, TWt, K>);
  const size_t weights = K > 0 ? 0 : static_cast<size_t>(g.k) * g.k * CG * sizeof(float);
  cudaError_t err =
      make_geo(g, kernel, sizeof(TX), K > 0, 1, 0, sizeof(TX) == 2 ? 1 : 0, weights, 0, smem);
  if (err != cudaSuccess || !launch) return err;
  dw_conv_kernel<TX, TWt, K><<<dim3(g.P, (g.C + CG - 1) / CG), 32 * g.nw(), *smem, st>>>(
      static_cast<const TX*>(x), static_cast<const TWt*>(wt), static_cast<TX*>(y), g);
  return cudaGetLastError();
}

// k ∈ {3, 5, 7} compiled as constants, any other read at run time.
template <typename TX, typename TWt>
inline cudaError_t conv_any_k(const void* x, const void* wt, void* y, Geo& g, bool launch,
                              size_t* smem, cudaStream_t st) {
  switch (g.k) {
    case 3: return conv_k<TX, TWt, 3>(x, wt, y, g, launch, smem, st);
    case 5: return conv_k<TX, TWt, 5>(x, wt, y, g, launch, smem, st);
    case 7: return conv_k<TX, TWt, 7>(x, wt, y, g, launch, smem, st);
    default: return conv_k<TX, TWt, 0>(x, wt, y, g, launch, smem, st);
  }
}

cudaError_t conv(const void* x, const void* wt, void* y, Geo& g, int x_bf16, int w_bf16,
                 bool launch, size_t* smem, cudaStream_t st) {
  if (x_bf16) {
    return w_bf16 ? conv_any_k<bf16, bf16>(x, wt, y, g, launch, smem, st)
                  : conv_any_k<bf16, float>(x, wt, y, g, launch, smem, st);
  }
  return w_bf16 ? conv_any_k<float, bf16>(x, wt, y, g, launch, smem, st)
                : conv_any_k<float, float>(x, wt, y, g, launch, smem, st);
}

cudaError_t launch_conv(const void* x, const void* wt, void* y, int x_bf16, int w_bf16, int B,
                        int H, int W, int C, int k, int flip, bool wide, cudaStream_t st) {
  Geo g = geo_of(B, H, W, C, k);
  g.wide = wide;
  g.flip = flip;
  size_t smem = 0;
  return conv(x, wt, y, g, x_bf16, w_bf16, true, &smem, st);
}

}  // namespace dw
}  // namespace vtt

using namespace vtt;

extern "C" int vtt_dw_fwd(const void* x, const void* w, void* y, int x_bf16, int w_bf16, int B,
                          int H, int W, int C, int k, void* stream) {
  if (!dw::shape_ok(B, H, W, C, k)) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = dw::wide_route(x_bf16 ? 2 : 4, C, {x, y});
  return static_cast<int>(dw::launch_conv(x, w, y, x_bf16, w_bf16, B, H, W, C, k, 0, wide,
                                          static_cast<cudaStream_t>(stream)));
}
