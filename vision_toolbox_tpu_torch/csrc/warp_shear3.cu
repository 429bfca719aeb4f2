// Three-shear affine warp for TrivialAugment's geometric ops (K1):
//   optional quarter turn, then up to three 1-D shear passes
//   (x-shear by p1·(y−c)+t1, y-shear by p2·(x−c)+t2, x-shear by p3·(y−c)),
//   2-tap linear interpolation, zero fill, on a zero-padded S×S canvas.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/warp_pallas.py
// `shear3_warp_pallas` (`_warp_kernel`). The per-image program (k90 and the
// pass flags, p1 t1 p2 t2 p3) comes from ops/warp.py `shear3_params`,
// computed once by the wrapper on the device and shared with the plain
// version `shear3_warp_plain`.
//
// The TPU design keeps one S×S f32 canvas per (image, channel) in VMEM
// (S = 512 at 176 px: 1 MiB) and rolls whole rows through a lane barrel
// shifter; the quarter turn is a matmul with a flip matrix. Here no canvas
// is formed: every pass reads only its own row or column, so an output
// pixel recomposes the three passes as a tree of taps. Pass 3 reads two taps
// of pass 2's row; each of those reads two taps of pass 1's column; each of
// those reads two taps of the quarter-turned padded image, which is an index
// remap of the input: at most 8 taps a channel. Each intermediate value is
// formed with the same f32 operations as in the three-pass form, tap1·(1−f)
// + tap2·f, with __fmul_rn/__fadd_rn so that no FMA contraction moves a
// rounding; a tap outside the canvas at any level reads 0, as in the padded
// form. The output is bit-equal to the plain version's.
//
// What bounds it: bytes. At bs256@176 f32 NHWC with C = 3 the warp reads
// ≈ 95 MB and writes ≈ 95 MB, ≈ 0.057 ms at 3.35 TB/s. Design:
//  - a block per (image, 32 × 32 output tile) on a 3-D grid (tile column,
//    tile row, image), so no index needs a division or 64-bit arithmetic
//    inside an image; the image's program is read once a block into shared
//    memory, and while it arrives each warp loads its tile rows (one 16-byte
//    load a lane: a tile row of 32 × 3 f32 is 384 contiguous bytes);
//  - an image whose flags are all 0 (a pixel op was drawn: most of a
//    TrivialAugment batch) stores those rows back: a copy;
//  - a warped tile stages its source footprint in shared memory with 16-byte
//    cp.async copies along input rows, then forms every tap from shared
//    memory. The footprint follows the tree: the tile's rows give the
//    columns pass 3 reads (its shift at the first and the last row bound it,
//    as a shift is monotone in its index, also in f32), clipped to the
//    canvas; those columns give the rows pass 2 reads, those rows the
//    columns pass 1 reads. Their rectangle on the quarter-turned canvas is
//    staged whole, zeros where it lies off the image, so no tap is checked.
//    For k90 ≠ 0 the rectangle is a run of input rows too (canvas columns
//    are input rows), copied the same way and read transposed from shared
//    memory: the quarter turn the TPU kernel does as a flip-matrix product.
//    Pass 2's shift by column and pass 1's by row are tabled once a block;
//  - a thread owns a run of 4 consecutive pixels of a tile row; they share
//    pass 3's taps (5 columns of pass 2's row for 4 pixels, each formed
//    once) and are written as whole 16-byte chunks (4 × 3 f32 = 3 float4).
// Why 32 × 32: a thread's run of 4 pixels and 256 threads make 32 × 32, and
// the footprint's overhead is set by the program, not by the tile: a
// rotation by θ' ≤ 45° (|p1|, |p3| ≤ tan 22.5°, |p2| ≤ sin 45°) spans
// ≈ 1.4·n columns for pass 3, ≈ 2.0·n rows for pass 2 and ≈ 2.3·n columns
// for pass 1 at tile side n, about 4.7× the tile's pixels at n = 32 and at
// 64 alike. At n = 32 the worst footprint over the draw set (ops/warp.py
// `stage_footprint` sweeps it) is 74 × 74 pixels, 60 KB at C = 3, so three
// blocks fit an SM; n = 64 would need 224 KB, one block an SM, and n = 16
// spends more of each block on its program and footprint. Shared memory is
// sized at the worst case of the draw set (STAGE_EDGE). A tile whose
// footprint does not fit (a program outside the draw set), and every warped
// tile at C ≠ 3, gathers its taps from device memory instead, each checked,
// with the same arithmetic. A warped tile is a chain of two round trips
// (the program, then the footprint), its compute and its stores, three
// blocks an SM: on all-warped batches a variant without the staging copies
// ran 0.003–0.024 ms faster, one without the compute 0.015–0.033, against
// 0.116–0.174 ms (scripts/ab_warp.py on an H100).
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int TILE = 32;      // output tile side, pixels
constexpr int RUN = 4;        // consecutive pixels a thread owns
constexpr int THREADS = TILE * TILE / RUN;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_EDGE = 76;  // worst footprint side over the draw set (74) and 2 to spare
constexpr int ROW_PAD = 12;     // floats a staged row may add: 16-byte ends and the bank pad
constexpr int TAB = 128;        // entries of a block's shift tables (pass 2 by x3, pass 1 by y2)
constexpr int kMaxSmem = 227 * 1024;
// blocks an SM: the stage (73 KB at C = 3) allows three, and registers are
// held to 80 a thread to match (unbounded, the identity copy's early loads
// took 116: two blocks an SM, warped tiles 1.3× slower)
constexpr int MIN_BLOCKS = 3;

struct Shear {
  int k;    // floor of the shift
  float f;  // fractional part
};

// Shift of a pass at canvas row/column `idx`: δ = p·(idx − c) + t.
__device__ __forceinline__ Shear shear_at(float p, float t, int idx, float c) {
  float d = __fadd_rn(__fmul_rn(p, __fsub_rn(static_cast<float>(idx), c)), t);
  float k = floorf(d);
  return {static_cast<int>(k), __fsub_rn(d, k)};
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__device__ __forceinline__ bool in_canvas(int v, int S) { return v >= 0 && v < S; }

struct Span {  // inclusive; empty where lo > hi
  int lo, hi;
};

// Canvas positions a pass reads from the positions `r` of its output, its
// shift taken over the positions `idx` of the other axis: [r.lo + min k,
// r.hi + max k + 1]. k is monotone in idx, also in f32, so its extremes lie
// at idx's ends.
__device__ __forceinline__ Span reads(Span r, Span idx, float p, float t, float c) {
  if (r.lo > r.hi || idx.lo > idx.hi) return {1, 0};
  const int ka = shear_at(p, t, idx.lo, c).k, kb = shear_at(p, t, idx.hi, c).k;
  return {r.lo + min(ka, kb), r.hi + max(ka, kb) + 1};
}

struct Program {
  int k90, on1, on2, on3;
  float p1, t1, p2, t2, p3;
};

// Where a tap (y, x) of the quarter-turned canvas is read: inside the
// window ys × xs it is at src[y·sy + x·sx + o0 + channel], elsewhere it is 0.
struct View {
  Span ys, xs;
  int sy, sx, o0;
};

// The view of an image held as rows r0 … of `pitch` floats, each starting
// at float f0 of its image row, for the canvas window ys × xs.
//   k90 = 0: c0[y, x] = img[y − P, x − P];
//   k90 = +1: c0[y, x] = img[S−1−x−P, y − P];  k90 = −1: c0[y, x] = img[x − P, S−1−y−P].
__device__ __forceinline__ View make_view(int k90, int S, int P, int C, Span ys, Span xs, int r0,
                                          int f0, int pitch) {
  View v{ys, xs, pitch, C, 0};
  if (k90 == 1) {
    v.sy = C;
    v.sx = -pitch;
    v.o0 = (S - 1 - P - r0) * pitch - P * C - f0;
  } else if (k90 == -1) {
    v.sy = -C;
    v.sx = pitch;
    v.o0 = (-P - r0) * pitch + (S - 1 - P) * C - f0;
  } else {
    v.o0 = (-P - r0) * pitch - P * C - f0;
  }
  return v;
}

// The fallback: the taps of one output pixel at canvas (Y, X), offsets
// (−1: reads 0) and fractions of the three levels, as the three-pass form
// forms them, each tap checked against the view's window.
struct Taps {
  int off[2][2][2];
  float f1[2][2], f2[2], f3;
};

__device__ __forceinline__ Taps taps_at(const Program& g, const View& v, Shear s3, int Y, int X,
                                        float cen, int S) {
  Taps tp;
  int x3[2] = {X, X};
  tp.f3 = 0.0f;
  if (g.on3) {
    x3[0] = X + s3.k;
    x3[1] = X + s3.k + 1;
    tp.f3 = s3.f;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const bool va = in_canvas(x3[a], S);
    int y2[2] = {Y, Y};
    tp.f2[a] = 0.0f;
    if (g.on2) {
      Shear s = shear_at(g.p2, g.t2, x3[a], cen);
      y2[0] = Y + s.k;
      y2[1] = Y + s.k + 1;
      tp.f2[a] = s.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool vr = va && y2[r] >= v.ys.lo && y2[r] <= v.ys.hi;
      int x1[2] = {x3[a], x3[a]};
      tp.f1[a][r] = 0.0f;
      if (g.on1) {
        Shear s = shear_at(g.p1, g.t1, y2[r], cen);
        x1[0] = x3[a] + s.k;
        x1[1] = x3[a] + s.k + 1;
        tp.f1[a][r] = s.f;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        tp.off[a][r][t] = (vr && x1[t] >= v.xs.lo && x1[t] <= v.xs.hi)
                              ? y2[r] * v.sy + x1[t] * v.sx + v.o0
                              : -1;
      }
    }
  }
  return tp;
}

// Channel c of the pixel whose taps are `tp`, read from `src`.
__device__ __forceinline__ float value_at(const float* src, const Taps& tp, const Program& g,
                                          int c) {
  float v2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a == 1 && !g.on3) break;
    float v1[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !g.on2) break;
      const float t0 = tp.off[a][r][0] >= 0 ? src[tp.off[a][r][0] + c] : 0.0f;
      if (g.on1) {
        const float tb = tp.off[a][r][1] >= 0 ? src[tp.off[a][r][1] + c] : 0.0f;
        v1[r] = lerp_rn(t0, tb, tp.f1[a][r]);
      } else {
        v1[r] = t0;
      }
    }
    v2[a] = g.on2 ? lerp_rn(v1[0], v1[1], tp.f2[a]) : v1[0];
  }
  return g.on3 ? lerp_rn(v2[0], v2[1], tp.f3) : v2[0];
}

// The fallback for a thread's run of n pixels at (i, j): every tap gathered
// from the image through `v` with its window checked.
__device__ __forceinline__ void gather_run(const float* img, const View& v, const Program& g,
                                           float* dst, int i, int j, int n, int W, int C, int S,
                                           int P) {
  const float cen = 0.5f * static_cast<float>(S - 1);
  const int Y = P + i;
  const Shear s3 = g.on3 ? shear_at(g.p3, 0.0f, Y, cen) : Shear{0, 0.0f};
  float* px = dst + (i * W + j) * C;
  for (int e = 0; e < n; ++e) {
    const Taps tp = taps_at(g, v, s3, Y, P + j + e, cen, S);
    for (int c = 0; c < C; ++c) px[e * C + c] = value_at(img, tp, g, c);
  }
}

// The staged route for a thread's run of n pixels at (i, j). The footprint
// in shared memory holds every tap the run reads (zeros off the image), so
// no tap is checked. Neighbouring pixels share pass 3's taps: the run reads
// n + 1 columns x3 of pass 2's row (n without pass 3), each a pass-2 value
// from two pass-1 values, each from two taps; the shifts of pass 2 (by x3)
// and pass 1 (by y2) come from the block's tables.
template <int CT>
__device__ __forceinline__ void staged_run(const float* st, const View& v, const Program& g,
                                           const Shear* t2, int x3lo, const Shear* t1, int y2lo,
                                           float* dst, int i, int j, int n, int W, int S, int P,
                                           bool vec) {
  const float cen = 0.5f * static_cast<float>(S - 1);
  const int Y = P + i;
  const Shear s3 = g.on3 ? shear_at(g.p3, 0.0f, Y, cen) : Shear{0, 0.0f};
  const int xs = P + j + s3.k;
  float o[RUN * CT], prev[CT];
#pragma unroll
  for (int m = 0; m <= RUN; ++m) {
    if (m > n || (m == n && !g.on3)) break;  // the tile's columns only
    const int x3 = xs + m;
    float v2[CT];
    if (!in_canvas(x3, S)) {
#pragma unroll
      for (int c = 0; c < CT; ++c) v2[c] = 0.0f;
    } else {
      const Shear s2 = g.on2 ? t2[x3 - x3lo] : Shear{0, 0.0f};
      float v1[2][CT];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && !g.on2) break;
        const int y2 = Y + s2.k + r;
        const Shear s1 = g.on1 ? t1[y2 - y2lo] : Shear{0, 0.0f};
        const float* tap = st + y2 * v.sy + (x3 + s1.k) * v.sx + v.o0;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          v1[r][c] = g.on1 ? lerp_rn(tap[c], tap[v.sx + c], s1.f) : tap[c];
        }
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) v2[c] = g.on2 ? lerp_rn(v1[0][c], v1[1][c], s2.f) : v1[0][c];
    }
    if (g.on3) {
      if (m > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) o[(m - 1) * CT + c] = lerp_rn(prev[c], v2[c], s3.f);
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) prev[c] = v2[c];
    } else if (m < RUN) {
#pragma unroll
      for (int c = 0; c < CT; ++c) o[m * CT + c] = v2[c];
    }
  }
  float* px = dst + (i * W + j) * CT;
  if (vec && n == RUN) {  // whole 16-byte chunks
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      reinterpret_cast<float4*>(px)[q] =
          make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < RUN * CT; ++e) {
      if (e < n * CT) px[e] = o[e];
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One block: a TILE × TILE output tile (blockIdx.x, blockIdx.y) of images
// blockIdx.z, blockIdx.z + gridDim.z, …; `cap` floats of dynamic shared
// memory (0: every warped tile gathers); `vec`: rows of W·C floats and both
// pointers 16-byte aligned. CT: the channel count it is built for (3), or 0
// for any other, read from C_rt.
template <int CT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    warp_shear3_kernel(const float* __restrict__ x, float* __restrict__ out,
                       const int* __restrict__ flags, const float* __restrict__ coef, int B,
                       int H, int W, int C_rt, int S, int P, int cap, int vec_rows) {
  extern __shared__ __align__(16) float stage[];
  __shared__ int prog_i[4];
  __shared__ float prog_f[5];
  __shared__ Shear tables[2 * TAB];  // pass 2's shifts by x3, then pass 1's by y2
  const int C = CT > 0 ? CT : C_rt;
  const bool vec = vec_rows != 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int th = min(TILE, H - i0), tw = min(TILE, W - j0);
  const int row_floats = W * C;
  const int i = i0 + tid / (TILE / RUN), jr = (tid % (TILE / RUN)) * RUN;
  const int n = min(RUN, tw - jr);  // the thread's pixels (≤ 0: none)
  const int base = i0 * row_floats + j0 * C;  // the tile within its image
  const int chunks = vec ? tw * C / 4 : 0;    // 16-byte chunks of a tile row
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const long long image = static_cast<long long>(b) * H * row_floats;
    const float* img = x + image;
    float* dst = out + image;
    // the tile's own rows, loaded while the program arrives: an identity
    // program copies them (a tile row of 32 × 3 f32 is 24 chunks)
    float4 own[TILE / WARPS];
    static_assert(TILE * CT / 4 <= 32, "a lane a chunk of a tile row");
    const bool early = CT > 0 && vec;
    if (early) {
#pragma unroll
      for (int k = 0; k < TILE / WARPS; ++k) {
        const int r = warp + k * WARPS;
        if (r < th && lane < chunks) {
          own[k] = reinterpret_cast<const float4*>(img + base + r * row_floats)[lane];
        }
      }
    }
    if (tid < 4) {
      prog_i[tid] = flags[4 * b + tid];
    } else if (tid < 9) {
      prog_f[tid - 4] = coef[5 * b + tid - 4];
    }
    __syncthreads();
    const Program g{prog_i[0], prog_i[1], prog_i[2], prog_i[3],
                    prog_f[0], prog_f[1], prog_f[2], prog_f[3], prog_f[4]};

    if (!(g.k90 | g.on1 | g.on2 | g.on3)) {  // identity warp: copy the tile
      if (early) {
#pragma unroll
        for (int k = 0; k < TILE / WARPS; ++k) {
          const int r = warp + k * WARPS;
          if (r < th && lane < chunks) {
            reinterpret_cast<float4*>(dst + base + r * row_floats)[lane] = own[k];
          }
        }
      } else {
        for (int r = warp; r < th; r += WARPS) {
          for (int q = lane; q < tw * C; q += 32) {
            dst[base + r * row_floats + q] = img[base + r * row_floats + q];
          }
        }
      }
    } else {
      bool done = false;
      if constexpr (CT > 0) {
        // the tile's footprint on the quarter-turned canvas (a pass that is
        // off shifts by 0 and still spans two taps): pass 3's columns,
        // clipped to the canvas (a column off it reads nothing), pass 2's
        // rows and pass 1's columns, not clipped (rows and columns off the
        // image are staged as zeros). A program with a shear factor above 4
        // or a shift above S takes the gather: its spans could overflow.
        const float cen = 0.5f * static_cast<float>(S - 1), fs = static_cast<float>(S);
        const bool tame = fabsf(g.p1) <= 4.0f && fabsf(g.p2) <= 4.0f && fabsf(g.p3) <= 4.0f &&
                          fabsf(g.t1) <= fs && fabsf(g.t2) <= fs;
        const Span rows{P + i0, P + i0 + th - 1}, cols{P + j0, P + j0 + tw - 1};
        Span x3 = reads(cols, rows, g.on3 ? g.p3 : 0.0f, 0.0f, cen);
        x3 = {max(x3.lo, 0), min(x3.hi, S - 1)};
        const Span y2 = reads(rows, x3, g.on2 ? g.p2 : 0.0f, g.on2 ? g.t2 : 0.0f, cen);
        const Span x1 = reads(x3, y2, g.on1 ? g.p1 : 0.0f, g.on1 ? g.t1 : 0.0f, cen);
        // its image rows and columns (k90 = ±1: canvas columns are image rows)
        Span ir{y2.lo - P, y2.hi - P}, ic{x1.lo - P, x1.hi - P};
        if (g.k90 == 1) {
          ir = {S - 1 - x1.hi - P, S - 1 - x1.lo - P};
          ic = {y2.lo - P, y2.hi - P};
        } else if (g.k90 == -1) {
          ir = {x1.lo - P, x1.hi - P};
          ic = {S - 1 - y2.hi - P, S - 1 - y2.lo - P};
        }
        const int f0 = vec ? (ic.lo * C) & ~3 : ic.lo * C;
        const int f1 = vec ? ((ic.hi + 1) * C + 3) & ~3 : (ic.hi + 1) * C;
        const int nf = f1 - f0;
        // an odd count of 16-byte chunks (or of floats) a row spreads a
        // transposed read over the banks
        const int pitch = vec ? nf + ((nf / 4) % 2 == 0 ? 4 : 0) : nf + (nf % 2 == 0 ? 1 : 0);
        const int nrows = ir.hi - ir.lo + 1;
        const int n2 = x3.hi - x3.lo + 1, n1 = y2.hi - y2.lo + 1;
        // (every column off the canvas: nothing is staged, every pixel is 0)
        if (tame && n2 <= TAB && n1 <= TAB && nrows * pitch <= cap) {
          for (int r = warp; r < nrows; r += WARPS) {
            const int a = ir.lo + r;
            const bool on_image = a >= 0 && a < H;
            const float* src = img + a * row_floats;
            float* d = stage + r * pitch;
            if (vec) {
              for (int q = lane; q < nf / 4; q += 32) {
                const int f = f0 + 4 * q;
                if (on_image && f >= 0 && f + 4 <= row_floats) {
                  cp_async16(d + 4 * q, src + f);
                } else {
                  reinterpret_cast<float4*>(d)[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                }
              }
            } else {
              for (int q = lane; q < nf; q += 32) {
                const int f = f0 + q;
                if (on_image && f >= 0 && f < row_floats) {
                  cp_async4(d + q, src + f);
                } else {
                  d[q] = 0.0f;
                }
              }
            }
          }
          for (int e = tid; e < n2 + n1; e += THREADS) {
            if (e < n2) {
              tables[e] = g.on2 ? shear_at(g.p2, g.t2, x3.lo + e, cen) : Shear{0, 0.0f};
            } else {
              tables[TAB + e - n2] =
                  g.on1 ? shear_at(g.p1, g.t1, y2.lo + e - n2, cen) : Shear{0, 0.0f};
            }
          }
          cp_async_wait_all();
          __syncthreads();
          const View v = make_view(g.k90, S, P, C, y2, x1, ir.lo, f0, pitch);
          if (i < i0 + th && n > 0) {
            staged_run<CT>(stage, v, g, tables, x3.lo, tables + TAB, y2.lo, dst, i, j0 + jr, n,
                           W, S, P, vec);
          }
          done = true;
        }
      }
      if (!done) {  // the footprint does not fit (or C ≠ 3): gather from the image
        Span wy{P, P + H - 1}, wx{P, P + W - 1};
        if (g.k90 == 1) {
          wy = {P, P + W - 1};
          wx = {S - P - H, S - 1 - P};
        } else if (g.k90 == -1) {
          wy = {S - P - W, S - 1 - P};
          wx = {P, P + H - 1};
        }
        const View v = make_view(g.k90, S, P, C, wy, wx, 0, 0, row_floats);
        if (i < i0 + th && n > 0) {
          gather_run(img, v, g, dst, i, j0 + jr, n, W, C, S, P);
        }
      }
    }
    __syncthreads();  // the program, the tables and the stage are the next image's
  }
}

template <int CT>
cudaError_t launch(const float* x, float* out, const int* flags, const float* coef, int B,
                   int H, int W, int C, int S, int P, bool vec, cudaStream_t st) {
  const long long want = CT > 0 ? 4LL * STAGE_EDGE * (STAGE_EDGE * C + ROW_PAD) : 0;
  const int bytes = static_cast<int>(want < kMaxSmem ? want : kMaxSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      warp_shear3_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B < 65535 ? B : 65535);
  warp_shear3_kernel<CT><<<grid, THREADS, bytes, st>>>(x, out, flags, coef, B, H, W, C, S, P,
                                                       bytes / 4, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, H, W, C) f32 contiguous, H == W; flags: (B, 4) int32
// [k90, pass1, pass2, pass3]; coef: (B, 5) f32 [p1, t1, p2, t2, p3];
// S, P: canvas size and padding (ops/warp.py `canvas_size`).
extern "C" int vtt_warp_shear3(const float* x, float* out, const int* flags, const float* coef,
                               int B, int H, int W, int C, int S, int P, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || C <= 0 || S < H + 2 * P || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  if (static_cast<long long>(H) * W * C > 0x7fffffffLL ||
      static_cast<long long>(S) * (static_cast<long long>(W) * C + 4) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (W * C) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = C == 3 ? launch<3>(x, out, flags, coef, B, H, W, C, S, P, vec, st)
                                 : launch<0>(x, out, flags, coef, B, H, W, C, S, P, vec, st);
  return static_cast<int>(err);
}
