// Depthwise k×k convolution, backward (K9): from x (B, H, W, C), the
// weights (k, k, C) and the output cotangent g (x's type),
//   dx[b, h, w, c]  = Σ_dy Σ_dx gpad[b, h + dy, w + dx, c]·w[k − 1 − dy, k − 1 − dx, c]
//                     (the forward kernel on g with the flipped weights),
//   dw[dy, dx, c]   = Σ_b Σ_h Σ_w xpad[b, h + dy, w + dx, c]·g[b, h, w, c]  (f32, in w's type).
//
// Replaces vision_toolbox_tpu/ops/depthwise_conv.py `_dw_bwd` (`_bwd_kernel`).
// The TPU kernel carries dw in a VMEM block along its sequential batch
// axis. Hopper blocks run in no order, so dw is two launches beside dx's,
// with no atomics and the same result on every run:
//   (i)  the forward's persistent blocks (depthwise_conv.cuh), each walking
//        a run of regions through the same ring, stage the x halo and the g
//        tile of a region; a thread keeps its channel's k² sums of xpad·g in
//        registers across the whole run (k ∈ {3, 5, 7}), walking the halo's
//        rows once per region against its 7 × 7 g tile held in registers;
//        at the end the block adds its warps' sums in warp order and writes
//        one (k², C) partial, (P, k², C) in all: P = the blocks of a channel
//        group (the card's resident blocks shared among the groups; 86 at
//        ConvNeXt-T stage 1, bs128: 1.6 MB of partials);
//   (ii) a fixed-shape two-level sum: each block takes 32 neighbouring
//        (tap, channel) columns, its 8 warps add every 8th partial in order,
//        then warp 0 adds the 8 sums in order and rounds once to w's type.
// Run-time k keeps one-warp blocks whose threads add each region's per-tap
// sums into their own slots of the partials. A one-pass form (dx and the
// partials over one staged region of x and g halos, as the TPU kernel's one
// body) held 255 registers a thread and ran 12% slower at ConvNeXt-T stage 1
// on an H100 (scripts/ab_depthwise_conv.py), so dx is the forward's launch.
// What bounds it: the dx pass is the forward's work; the dw pass reads x and
// g once (2·k² operations per element of g), operation-bound at k = 7 like
// the forward.
#include "depthwise_conv.cuh"

using namespace vtt;

namespace {

using dw::CG;
using dw::Geo;
using dw::TC;
using dw::TR;

constexpr int RED_WARPS = 8;  // the sum's warps, each adding every 8th partial

// Block partials of dw. Grid (g.P, channel groups), 32·g.nw() threads; a
// ring stage holds the x halo and the g tile of a region.
template <typename TX, int K>
__global__ void __launch_bounds__(dw::NT_MAX, dw::MIN_BLOCKS)
dw_wgrad_kernel(const TX* __restrict__ x, const TX* __restrict__ gt, float* __restrict__ partials,
                Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = K > 0 ? K : g.k, kk = k * k;
  const int c0 = blockIdx.y * CG, c = c0 + threadIdx.x % 32;
  const int hcols = g.halo_cols(), trows = g.wr * TR, tcols = g.wc * TC;
  const int halo = g.halo_elems(), stage_elems = halo + g.tile_elems();
  TX* stages = reinterpret_cast<TX*>(smem_raw);
  const dw::WarpTile wt_ = dw::warp_tile(g);
  float* out = partials + static_cast<size_t>(blockIdx.x) * kk * g.C;
  float acc[K > 0 ? K * K : 1];
#pragma unroll
  for (int t = 0; t < (K > 0 ? K * K : 1); ++t) acc[t] = 0.0f;

  const int first = blockIdx.x * g.per_block;
  dw::ring(
      g, first, min(first + g.per_block, g.n_regions),
      [&](int r, int s) {
        const dw::Origin o = dw::region_origin(g, r);
        TX* st = stages + static_cast<size_t>(s) * stage_elems;
        dw::stage_patch(x, st, g, o.b0, o.h0, o.w0, c0, g.halo_rows(), hcols, k / 2);
        dw::stage_patch(gt, st + halo, g, o.b0, o.h0, o.w0, c0, trows, tcols, 0);
      },
      [&](int r, int s) {
        const TX* st = stages + static_cast<size_t>(s) * stage_elems;
        const TX* xs = dw::halo_corner(st, g, hcols);
        const TX* gs = st + halo + (static_cast<size_t>(wt_.img * trows + wt_.tr * TR) * tcols +
                                    wt_.tc * TC) * CG + threadIdx.x % 32;
        float gr[TR][TC];
#pragma unroll
        for (int r_ = 0; r_ < TR; ++r_) {
#pragma unroll
          for (int j = 0; j < TC; ++j) gr[r_][j] = dw::to_f32(gs[(r_ * tcols + j) * CG]);
        }
        if constexpr (K > 0) {
          dw::wgrad_tile<K>(xs, hcols, gr, acc);
        } else {  // one-warp blocks: each thread owns its slots of the partials
          if (c >= g.C) return;
          for (int t = 0; t < kk; ++t) {
            const int dy = t / k, dx = t % k;
            float sum = r == first ? 0.0f : out[static_cast<size_t>(t) * g.C + c];
#pragma unroll
            for (int r_ = 0; r_ < TR; ++r_) {
#pragma unroll
              for (int j = 0; j < TC; ++j) {
                sum = fmaf(dw::to_f32(xs[((r_ + dy) * hcols + j + dx) * CG]), gr[r_][j], sum);
              }
            }
            out[static_cast<size_t>(t) * g.C + c] = sum;
          }
        }
      });
  if constexpr (K > 0) dw::block_partial<K>(reinterpret_cast<float*>(smem_raw), acc, out, g, c0);
}

// dw[i] = Σ_p partials[p, i], i over the k²·C taps and channels: block
// (32 columns) × 8 warps; warp w adds p = w, w + 8, … in order, then warp 0
// adds the eight sums in warp order and rounds once to w's type.
template <typename TWt>
__global__ void __launch_bounds__(32 * RED_WARPS)
dw_reduce_kernel(const float* __restrict__ partials, TWt* __restrict__ dwt, int P, int n) {
  __shared__ float red[RED_WARPS][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  float sum = 0.0f;
  if (i < n) {
    for (int p = warp; p < P; p += RED_WARPS) sum += partials[static_cast<size_t>(p) * n + i];
  }
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && i < n) {
    sum = red[0][lane];
#pragma unroll
    for (int w = 1; w < RED_WARPS; ++w) sum += red[w][lane];
    dw::st(dwt, i, sum);
  }
}

// The weight-gradient kernel on g's shape: its geometry (into g and *smem;
// g.P sizes the partials) and, with `launch`, the launch on stream st.
template <typename TX, int K>
cudaError_t wgrad_k(const void* x, const void* gt, float* partials, Geo& g, bool launch,
                    size_t* smem, cudaStream_t st) {
  const void* kernel = reinterpret_cast<const void*>(dw_wgrad_kernel<TX, K>);
  const size_t reduce = K > 0 ? static_cast<size_t>(K) * K * CG * sizeof(float) : 0;
  cudaError_t err = dw::make_geo(g, kernel, sizeof(TX), K > 0, 1, 1, 0, 0, reduce, smem);
  if (err != cudaSuccess || !launch) return err;
  dw_wgrad_kernel<TX, K><<<dim3(g.P, (g.C + CG - 1) / CG), 32 * g.nw(), *smem, st>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(gt), partials, g);
  return cudaGetLastError();
}

// k ∈ {3, 5, 7} compiled as constants, any other read at run time.
template <typename TX>
cudaError_t wgrad_any_k(const void* x, const void* gt, float* partials, Geo& g, bool launch,
                        size_t* smem, cudaStream_t st) {
  switch (g.k) {
    case 3: return wgrad_k<TX, 3>(x, gt, partials, g, launch, smem, st);
    case 5: return wgrad_k<TX, 5>(x, gt, partials, g, launch, smem, st);
    case 7: return wgrad_k<TX, 7>(x, gt, partials, g, launch, smem, st);
    default: return wgrad_k<TX, 0>(x, gt, partials, g, launch, smem, st);
  }
}

cudaError_t wgrad(const void* x, const void* gt, float* partials, Geo& g, int x_bf16, bool launch,
                  size_t* smem, cudaStream_t st) {
  return x_bf16 ? wgrad_any_k<dw::bf16>(x, gt, partials, g, launch, smem, st)
                : wgrad_any_k<float>(x, gt, partials, g, launch, smem, st);
}

}  // namespace

// 1 when a call on these operands takes the wide route (16-byte copies in
// and, for bf16, out), 0 when the scalar one (one element at a time); g may
// be null (the forward). The launchers ask the same rule of their tensors,
// outputs included (the wrappers' own allocations, 16-byte-aligned).
extern "C" int vtt_dw_route(const void* x, const void* g, int x_bf16, int C) {
  return dw::wide_route(x_bf16 ? 2 : 4, C, {x, g}) ? 1 : 0;
}

// Floats of the dw partials scratch the caller allocates for vtt_dw_bwd on
// the current device; negative on an error.
extern "C" long long vtt_dw_partial_floats(int B, int H, int W, int C, int k, int x_bf16) {
  if (!dw::shape_ok(B, H, W, C, k)) return -static_cast<long long>(cudaErrorInvalidValue);
  Geo g = dw::geo_of(B, H, W, C, k);
  size_t smem = 0;
  const cudaError_t err = wgrad(nullptr, nullptr, nullptr, g, x_bf16, false, &smem, nullptr);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(g.P) * k * k * C;
}

// The launch geometry of the forward kernel (bwd = 0) or of the weight-
// gradient kernel (bwd = 1) on the current device, into out[8]: wr, wc, ni
// (a block's region: rows and columns of 7 × 7 tiles, images), ring stages,
// P (blocks a channel group), regions a block walks, threads a block, bytes
// of shared memory.
extern "C" int vtt_dw_geometry(int B, int H, int W, int C, int k, int x_bf16, int w_bf16, int bwd,
                               long long* out) {
  if (!dw::shape_ok(B, H, W, C, k)) return static_cast<int>(cudaErrorInvalidValue);
  Geo g = dw::geo_of(B, H, W, C, k);
  size_t smem = 0;
  const cudaError_t err =
      bwd ? wgrad(nullptr, nullptr, nullptr, g, x_bf16, false, &smem, nullptr)
          : dw::conv(nullptr, nullptr, nullptr, g, x_bf16, w_bf16, false, &smem, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[8] = {g.wr, g.wc, g.ni, g.stages, g.P, g.per_block, 32 * g.nw(),
                             static_cast<long long>(smem)};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

extern "C" int vtt_dw_bwd(const void* x, const void* g, const void* w, void* dx, void* dwt,
                          float* partials, int x_bf16, int w_bf16, int B, int H, int W, int C,
                          int k, void* stream) {
  if (!dw::shape_ok(B, H, W, C, k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = dw::wide_route(x_bf16 ? 2 : 4, C, {x, g, dx});
  cudaError_t err = dw::launch_conv(g, w, dx, x_bf16, w_bf16, B, H, W, C, k, 1, wide, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geo geo = dw::geo_of(B, H, W, C, k);
  geo.wide = wide;
  size_t smem = 0;
  err = wgrad(x, g, partials, geo, x_bf16, true, &smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = k * k * C;
  if (w_bf16) {
    dw_reduce_kernel<dw::bf16><<<(n + 31) / 32, 32 * RED_WARPS, 0, st>>>(
        partials, static_cast<dw::bf16*>(dwt), geo.P, n);
  } else {
    dw_reduce_kernel<float><<<(n + 31) / 32, 32 * RED_WARPS, 0, st>>>(
        partials, static_cast<float*>(dwt), geo.P, n);
  }
  return static_cast<int>(cudaGetLastError());
}
