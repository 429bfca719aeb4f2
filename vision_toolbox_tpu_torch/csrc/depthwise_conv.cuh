// Depthwise k×k convolution, stride 1, SAME padding (odd k), on NHWC
// tensors (K9): the launch geometry, the staging ring and the declarations
// of the forward launchers. depthwise_conv.cu holds the forward kernel;
// depthwise_conv_bwd.cu launches it again on the output cotangent with the
// flipped kernel (dx) and adds the weight-gradient kernels.
//
// Replaces the TPU kernels of vision_toolbox_tpu/ops/depthwise_conv.py
// (`_dw_fwd` / `_fwd_kernel`, `_dw_bwd` / `_bwd_kernel`). The TPU kernel
// pads the input in device memory (jnp.pad, a TPU layout need) and holds a
// group of whole padded images per channel block in VMEM. Here no padded
// copy exists: blocks stage the halo of their tiles in shared memory with
// zeros outside the image.
//
// Rounding points are the TPU kernel's: every tap in f32, summed with dy
// outer and dx inner into one f32 accumulator per output, rounded once to
// x's type. A tap is a product then a sum, each rounded (the plain version's
// `acc + x·w`); with bf16 x and w the product is exact in f32, so that case
// uses one fused multiply-add, which rounds identically. The same rounding
// points rule out packed bf16 FMAs and tensor-core forms: K9 runs on the
// CUDA cores, and its floor is the f32 FMA rate.
//
// What bounds it on an H100: 2·k² operations per output element against one
// read and one write of it; at ConvNeXt-T stage 1, bs128 (38.5 M elements,
// k = 7) 3.78 GFLOP, 0.056 ms at the 67 TFLOP/s f32 rate, above the 0.046 ms
// that its 154 MB of bf16 take at 3.35 TB/s. So the design spends its effort
// on keeping the FMA pipe fed:
//   - a thread owns one channel (lane c of a warp, 32 neighbouring channels
//     a warp) and a TR × TC = 7 × 7 output tile, with its k² weights (k ∈
//     {3, 5, 7} compiled as constants) and its 49 accumulators in registers.
//     It walks the TR + k − 1 input rows of its halo in increasing order,
//     reading each row from shared memory once and feeding it to every
//     output row that needs it: 2401 FMAs at k = 7 against 169 shared loads.
//     Walking the rows upwards gives each output its taps in dy order, so the
//     rounding is the plain version's.
//   - 7 × 7 tiles fit ConvNeXt's 56/28/14/7 maps without idle lanes. A block
//     of up to 8 warps covers a region of wr × wc tiles of ni images (14 × 28
//     pixels at 56² and 28², 14 × 14 of two images at 14², 7 × 7 of several
//     images at 7²); ragged maps keep their masks.
//   - blocks are persistent: P blocks per channel group (the card's resident
//     blocks shared among the groups) each walk a run of regions through a
//     ring of one or two stages in shared memory, so the next region's halo
//     loads (cp.async) while this one computes. The halo is staged as stored
//     (bf16 for bf16 x), 16 bytes a copy where C and the pointers allow (the
//     "wide" route), one element at a time otherwise (the "scalar" route: C
//     not a multiple of 8 bf16 or 4 f32 values, or an offset view).
//   - on the wide route a bf16 region's outputs go through shared memory
//     and leave in 16-byte stores (1–5% faster than a warp's 64-byte rows
//     at 28² and below on an H100, even at 56²); f32 warps store their 128
//     contiguous bytes a pixel directly (no faster through the tile, which
//     would take the f32 ring's room).
// Other odd k ≤ MAX_K read k at run time: weights in shared memory, each tap
// read from shared memory, one-warp blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>

namespace vtt {
namespace dw {

using bf16 = __nv_bfloat16;

constexpr int CG = 32;               // channels per block (a channel group): one per lane
constexpr int TR = 7, TC = 7;        // a thread's output tile
constexpr int MAX_WARPS = 8;         // warps per block
constexpr int NT_MAX = 32 * MAX_WARPS;
constexpr int MAX_WC = 4;            // tile columns of a block region
constexpr int MAX_STAGES = 2;        // ring stages of a block that walks several regions
constexpr int MIN_BLOCKS = 2;        // blocks an SM of the bf16 × bf16 kernels: ≤ 128 registers
constexpr size_t SMEM_BUDGET = 113 * 1024;  // shared memory a block may take: two blocks an SM
constexpr int MAX_K = 21;            // run-time k: one-warp regions of (7 + k − 1)² fit 227 KB
constexpr size_t SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The wide route: 16-byte copies of the staged operands and of bf16
// outputs need C a multiple of 16 bytes' worth of channels and every tensor
// of the call (null ones skipped) 16-byte-aligned. The launchers and
// vtt_dw_route both ask this.
inline bool wide_route(int x_bytes, int C, std::initializer_list<const void*> tensors) {
  bool wide = C % (16 / x_bytes) == 0;
  for (const void* p : tensors) wide = wide && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return wide;
}

// A launch's geometry, passed to the kernels by value. A region is wr × wc
// thread tiles of ni images; regions are numbered image group slowest, then
// tile row, then tile column, and block (p, channel group) walks regions
// [p·per_block, (p + 1)·per_block).
struct Geo {
  int B, H, W, C, k;
  int wr, wc, ni;        // region: tile rows, tile columns, images
  int stages;            // ring stages in shared memory
  int tiles_h, tiles_w;  // regions per image, down and across
  int n_regions, per_block, P;
  int wide;              // 16-byte staging
  int flip;              // forward kernel: the flipped weights (the backward's dx)
  __host__ __device__ int nw() const { return wr * wc * ni; }
  __host__ __device__ int halo_rows() const { return wr * TR + k - 1; }
  __host__ __device__ int halo_cols() const { return wc * TC + k - 1; }
  __host__ __device__ int halo_elems() const { return ni * halo_rows() * halo_cols() * CG; }
  __host__ __device__ int tile_elems() const { return ni * wr * TR * wc * TC * CG; }
};

// Shared memory of a launch: `halos` halos and `tiles` tiles of x_bytes
// elements a ring stage, then `out_tiles` tiles (the forward's outputs) and
// `extra` bytes; `reduce` bytes reuse the ring after it.
inline size_t geo_smem(const Geo& g, int x_bytes, int halos, int tiles, int out_tiles,
                       size_t extra, size_t reduce) {
  const size_t stage =
      static_cast<size_t>(halos * g.halo_elems() + tiles * g.tile_elems()) * x_bytes;
  const size_t ring = (g.stages * stage + 15) / 16 * 16 +
                      static_cast<size_t>(out_tiles) * g.tile_elems() * x_bytes + extra;
  return ring > reduce ? ring : reduce;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The current device's SMs and the blocks of `kernel` (threads, dynamic
// shared bytes) one SM holds, its shared-memory limit raised to SMEM_LIMIT
// first (a limit, not a reservation); each (device, kernel, threads, bytes)
// asked of the runtime once, since a launch on a small map takes less time
// on the card than these queries on the host.
inline cudaError_t occupancy(const void* kernel, int threads, size_t smem, int* sms, int* per_sm) {
  struct Entry {
    int dev;
    const void* kernel;
    int threads;
    size_t smem;
    int sms, per_sm;
  };
  static Entry cache[128];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.dev == dev && e.kernel == kernel && e.threads == threads && e.smem == smem) {
      *sms = e.sms, *per_sm = e.per_sm;
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_LIMIT));
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (err == cudaSuccess && used < 128) cache[used++] = {dev, kernel, threads, smem, *sms, *per_sm};
  return err;
}

// The region for (H, W), the ring stages, and the persistent grid. `kernel`
// is the kernel to launch (its occupancy sets the grid); `compiled`: k is a
// compile-time constant (else one-warp regions); `halos`, `tiles`,
// `out_tiles`, `extra` and `reduce` as in geo_smem, `reduce` per warp.
inline cudaError_t make_geo(Geo& g, const void* kernel, int x_bytes, bool compiled, int halos,
                            int tiles, int out_tiles, size_t extra, size_t reduce_per_warp,
                            size_t* smem) {
  g.wc = compiled ? (cdiv(g.W, TC) < MAX_WC ? cdiv(g.W, TC) : MAX_WC) : 1;
  g.wr = compiled ? (cdiv(g.H, TR) < MAX_WARPS / g.wc ? cdiv(g.H, TR) : MAX_WARPS / g.wc) : 1;
  g.ni = compiled ? (g.B < MAX_WARPS / (g.wr * g.wc) ? g.B : MAX_WARPS / (g.wr * g.wc)) : 1;
  for (;;) {
    g.stages = MAX_STAGES;
    const auto bytes = [&] {
      return geo_smem(g, x_bytes, halos, tiles, out_tiles, extra, reduce_per_warp * g.nw());
    };
    while (g.stages > 1 && bytes() > SMEM_BUDGET) --g.stages;
    *smem = bytes();
    if (*smem <= SMEM_BUDGET || g.nw() == 1) break;
    if (g.ni > 1) {
      g.ni = cdiv(g.ni, 2);
    } else if (g.wr > 1) {
      g.wr = cdiv(g.wr, 2);
    } else {
      g.wc = cdiv(g.wc, 2);
    }
  }
  if (*smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  g.tiles_h = cdiv(g.H, g.wr * TR);
  g.tiles_w = cdiv(g.W, g.wc * TC);
  const long long regions = static_cast<long long>(cdiv(g.B, g.ni)) * g.tiles_h * g.tiles_w;
  if (regions > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.n_regions = static_cast<int>(regions);

  int sms = 0, per_sm = 0;
  cudaError_t err = occupancy(kernel, 32 * g.nw(), *smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int groups = cdiv(g.C, CG);
  int P = per_sm * sms / groups;
  P = P < 1 ? 1 : (P > g.n_regions ? g.n_regions : P);
  g.per_block = cdiv(g.n_regions, P);
  g.P = cdiv(g.n_regions, g.per_block);
  return cudaSuccess;
}

// A position (digit d0 fastest, then d1, d2, d3) in a mixed-radix count
// with radices r0, r1, r2; `step` adds the decomposition of an increment,
// each digit of which is below its radix, so every digit carries at most once.
struct Count {
  int d0, d1, d2, d3;
  __device__ __forceinline__ static Count of(int i, int r0, int r1, int r2) {
    const int a = i / r0, b = a / r1;
    return {i - a * r0, a - b * r1, b % r2, b / r2};
  }
  __device__ __forceinline__ void step(const Count& s, int r0, int r1, int r2) {
    d0 += s.d0;
    d1 += s.d1;
    d2 += s.d2;
    d3 += s.d3;
    if (d0 >= r0) d0 -= r0, ++d1;
    if (d1 >= r1) d1 -= r1, ++d2;
    if (d2 >= r2) d2 -= r2, ++d3;
  }
};

// Stage one operand's patch of a region into shared memory `dst` (pitch CG
// elements a pixel): `rows` × `cols` pixels of each of the region's ni
// images from (h0 − pad, w0 − pad), channels [c0, c0 + CG); zeros outside
// the image, past the batch and past C. The wide route issues 16-byte
// cp.async copies (zero-filled where there is nothing to read); the scalar
// route loads and stores one element at a time. Threads walk the patch with
// a mixed-radix count (part of a pixel, column, row, image), not divisions.
template <typename TX>
__device__ __forceinline__ void stage_patch(const TX* __restrict__ src, TX* dst, const Geo& g,
                                            int b0, int h0, int w0, int c0, int rows, int cols,
                                            int pad) {
  constexpr int EPC = 16 / sizeof(TX);  // elements a 16-byte copy
  const int per_pixel = g.wide ? CG / EPC : CG, unit = g.wide ? EPC : 1;
  const int n = g.ni * rows * cols * per_pixel;
  Count at = Count::of(threadIdx.x, per_pixel, cols, rows);
  const Count stride = Count::of(blockDim.x, per_pixel, cols, rows);
  for (int i = threadIdx.x; i < n; i += blockDim.x, at.step(stride, per_pixel, cols, rows)) {
    const int b = b0 + at.d3, h = h0 - pad + at.d2, w = w0 - pad + at.d1, c = c0 + at.d0 * unit;
    const bool ok = b < g.B && h >= 0 && h < g.H && w >= 0 && w < g.W && c < g.C;
    const size_t from = ok ? ((static_cast<size_t>(b) * g.H + h) * g.W + w) * g.C + c : 0;
    if (g.wide) {
      cp_async16(dst + static_cast<size_t>(i) * EPC, src + from, ok ? 16 : 0);
    } else {
      dst[i] = ok ? src[from] : TX(0.0f);
    }
  }
}

// Write a region's outputs, staged in shared memory `outs` (rows × cols
// pixels of each of ni images, pitch CG), to y at (h0, w0) with 16-byte
// stores; masked at the map's edges, the batch and C.
template <typename TX>
__device__ __forceinline__ void copy_out(TX* __restrict__ y, const TX* outs, const Geo& g, int b0,
                                         int h0, int w0, int c0, int rows, int cols) {
  constexpr int EPC = 16 / sizeof(TX), CPP = CG / EPC;
  const int n = g.ni * rows * cols * CPP;
  Count at = Count::of(threadIdx.x, CPP, cols, rows);
  const Count stride = Count::of(blockDim.x, CPP, cols, rows);
  for (int i = threadIdx.x; i < n; i += blockDim.x, at.step(stride, CPP, cols, rows)) {
    const int b = b0 + at.d3, h = h0 + at.d2, w = w0 + at.d1, c = c0 + at.d0 * EPC;
    if (b < g.B && h < g.H && w < g.W && c < g.C) {
      *reinterpret_cast<uint4*>(y + ((static_cast<size_t>(b) * g.H + h) * g.W + w) * g.C + c) =
          *reinterpret_cast<const uint4*>(outs + static_cast<size_t>(i) * EPC);
    }
  }
}

// Region r's origin: first image, first output row and column.
struct Origin {
  int b0, h0, w0;
};
__device__ __forceinline__ Origin region_origin(const Geo& g, int r) {
  const int per_image = g.tiles_h * g.tiles_w, rem = r % per_image;
  return {(r / per_image) * g.ni, (rem / g.tiles_w) * g.wr * TR, (rem % g.tiles_w) * g.wc * TC};
}

// This warp's tile in its region: (image slot, tile row, tile column).
struct WarpTile {
  int img, tr, tc;
};
__device__ __forceinline__ WarpTile warp_tile(const Geo& g) {
  const int w = threadIdx.x / 32;
  return {w / (g.wr * g.wc), (w / g.wc) % g.wr, w % g.wc};
}

// The ring over a block's regions [first, last): `load(region, stage)`
// issues the staging of a region (cp.async, committed here), `body(region,
// stage)` runs once its stage has landed and every thread sees it. With two
// stages the next region loads while this one computes; with one, after it.
template <typename Load, typename Body>
__device__ __forceinline__ void ring(const Geo& g, int first, int last, Load&& load, Body&& body) {
  load(first, 0);
  cp_async_commit();
  for (int r = first, it = 0; r < last; ++r, ++it) {
    const bool next = r + 1 < last;
    if (g.stages > 1 && next) {
      load(r + 1, (it + 1) % g.stages);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(r, it % g.stages);
    __syncthreads();  // every read of this stage is done before it is refilled
    if (g.stages == 1 && next) {
      load(r + 1, 0);
      cp_async_commit();
    }
  }
}

// This lane's weights, flipped for the backward's dx, into registers
// (`wreg`, compiled k) or shared memory (`ws`, pitch CG a tap, warps
// sharing the taps: run-time k).
template <int K, typename TWt>
__device__ __forceinline__ void load_weights(const TWt* __restrict__ wt, const Geo& g, int c,
                                             int flip, float* wreg, float* ws) {
  if constexpr (K > 0) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) {
      const int src = flip ? K * K - 1 - t : t;
      wreg[t] = c < g.C ? ld(wt, static_cast<size_t>(src) * g.C + c) : 0.0f;
    }
  } else {
    const int kk = g.k * g.k;
    for (int t = threadIdx.x / 32; t < kk; t += blockDim.x / 32) {
      const int src = flip ? kk - 1 - t : t;
      ws[t * CG + threadIdx.x % 32] = c < g.C ? ld(wt, static_cast<size_t>(src) * g.C + c) : 0.0f;
    }
  }
}

// acc[r][j] = Σ_dy Σ_dx h[r + dy, j + dx]·w[dy, dx] over this thread's
// staged halo `hs` (its tile's corner and lane; pitch `hcols` pixels of CG
// elements), taps in dy-then-dx order. A compiled k walks the TR + K − 1
// halo rows once each, upwards: row i feeds output rows i − K + 1 … i at tap
// row dy = i − r. A run-time k reads each tap's weight from `ws` and its
// inputs from shared memory.
template <bool kExact, int K, typename TX>
__device__ __forceinline__ void conv_tile(const TX* hs, int hcols, const float* wreg,
                                          const float* ws, int k, float (&acc)[TR][TC]) {
#pragma unroll
  for (int r = 0; r < TR; ++r) {
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[r][j] = 0.0f;
  }
  if constexpr (K > 0) {
#pragma unroll
    for (int i = 0; i < TR + K - 1; ++i) {
      float xr[TC + K - 1];
#pragma unroll
      for (int j = 0; j < TC + K - 1; ++j) xr[j] = to_f32(hs[(i * hcols + j) * CG]);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int dy = i - r;
        if (dy < 0 || dy >= K) continue;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            acc[r][j] = tap<kExact>(acc[r][j], xr[j + dx], wreg[dy * K + dx]);
          }
        }
      }
    }
  } else {
    for (int dy = 0; dy < k; ++dy) {
      for (int dx = 0; dx < k; ++dx) {
        const float wv = ws[(dy * k + dx) * CG];
#pragma unroll
        for (int r = 0; r < TR; ++r) {
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            acc[r][j] = tap<kExact>(acc[r][j], to_f32(hs[((r + dy) * hcols + j + dx) * CG]), wv);
          }
        }
      }
    }
  }
}

// dw's sums: acc[dy·K + dx] += Σ_r Σ_j x[r + dy, j + dx]·gr[r][j] over this
// thread's staged x halo `xs` (as conv_tile's `hs`), walking its rows once.
template <int K, typename TX>
__device__ __forceinline__ void wgrad_tile(const TX* xs, int hcols, const float (&gr)[TR][TC],
                                           float* acc) {
#pragma unroll
  for (int i = 0; i < TR + K - 1; ++i) {
    float xr[TC + K - 1];
#pragma unroll
    for (int j = 0; j < TC + K - 1; ++j) xr[j] = to_f32(xs[(i * hcols + j) * CG]);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int dy = i - r;
      if (dy < 0 || dy >= K) continue;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        float sum = acc[dy * K + dx];
#pragma unroll
        for (int j = 0; j < TC; ++j) sum = fmaf(xr[j + dx], gr[r][j], sum);
        acc[dy * K + dx] = sum;
      }
    }
  }
}

// This thread's 7 × 7 tile of channel c, image b, from (h0, w0), into y in
// y's type; masked at the map's edges.
template <typename TX>
__device__ __forceinline__ void store_tile(TX* __restrict__ y, const Geo& g, int b, int h0, int w0,
                                           int c, const float (&acc)[TR][TC]) {
  if (b >= g.B || c >= g.C) return;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    if (h0 + r >= g.H) continue;
    const size_t row = (static_cast<size_t>(b) * g.H + h0 + r) * g.W;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      if (w0 + j < g.W) st(y, (row + w0 + j) * g.C + c, acc[r][j]);
    }
  }
}

// A block's dw partial: its warps' k² sums per channel (`acc`, this
// thread's) added in warp order through shared memory `red` (free: the ring
// is done), written to `out` (k², C) for channels [c0, c0 + CG).
template <int K>
__device__ __forceinline__ void block_partial(float* red, const float* acc, float* out,
                                              const Geo& g, int c0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int t = 0; t < K * K; ++t) red[(warp * K * K + t) * CG + lane] = acc[t];
  __syncthreads();
  for (int i = threadIdx.x; i < K * K * CG; i += blockDim.x) {
    float sum = red[i];
    for (int w = 1; w < g.nw(); ++w) sum += red[w * K * K * CG + i];
    const int t = i / CG, cl = i % CG;
    if (c0 + cl < g.C) out[static_cast<size_t>(t) * g.C + c0 + cl] = sum;
  }
}

// This warp's tile corner (and lane) in a staged halo of pitch `hcols`.
template <typename TX>
__device__ __forceinline__ const TX* halo_corner(const TX* stage, const Geo& g, int hcols) {
  const WarpTile w = warp_tile(g);
  return stage + (static_cast<size_t>(w.img * g.halo_rows() + w.tr * TR) * hcols + w.tc * TC) * CG +
         threadIdx.x % 32;
}

inline bool shape_ok(int B, int H, int W, int C, int k) {
  return B > 0 && H > 0 && W > 0 && C > 0 && k % 2 == 1 && k >= 1 && k <= MAX_K &&
         C <= 65535 * CG;  // the grid's y: channel groups
}

inline Geo geo_of(int B, int H, int W, int C, int k) {
  Geo g{};
  g.B = B, g.H = H, g.W = W, g.C = C, g.k = k;
  return g;
}

// The forward kernel (depthwise_conv.cu) on g's shape: its geometry (into g
// and *smem) and, with `launch`, the launch on stream st.
cudaError_t conv(const void* x, const void* wt, void* y, Geo& g, int x_bf16, int w_bf16,
                 bool launch, size_t* smem, cudaStream_t st);

// Launch the forward kernel: y = x ⊛ w, or (flip) x ⊛ the flipped w; on
// the wide route where `wide` (wide_route of the call's tensors).
cudaError_t launch_conv(const void* x, const void* wt, void* y, int x_bf16, int w_bf16, int B,
                        int H, int W, int C, int k, int flip, bool wide, cudaStream_t st);

}  // namespace dw
}  // namespace vtt
