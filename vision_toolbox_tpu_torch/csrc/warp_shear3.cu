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
// shifter; the quarter turn is a matmul with a flip matrix. A Hopper block
// has 227 KB of shared memory, and none of that is needed: every pass reads
// only its own row or column, so one thread per output pixel recomposes the
// three passes. Pass 3 reads two taps of pass 2's row; each of those reads
// two taps of pass 1's column; each of those reads two taps of the
// quarter-turned padded image, which is an index remap of the input. That is
// at most 8 loads per channel from the input (it stays in L1/L2) and no
// scratch canvas. Each intermediate value is formed with the same f32
// operations as in the three-pass form, tap1·(1−f) + tap2·f, with
// __fmul_rn/__fadd_rn so that no FMA contraction moves a rounding; a tap
// outside the canvas at any level reads 0, as in the padded form. An image
// whose flags are all 0 (a pixel op was drawn) is a copy.
//
// What bounds it: bytes. At bs256@176 f32 NHWC with C = 3 the warp reads
// ≈ 95 MB and writes ≈ 95 MB, ≈ 0.06 ms at 3.35 TB/s; the taps beyond the
// first hit L1/L2. The design does one read of each needed input line and
// one write per pixel, with no intermediate round trip to device memory.
#include <cuda_runtime.h>

namespace {

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

// Offset (in floats, channel 0) of canvas pixel (y, x) of the quarter-turned
// padded canvas inside the image, or -1 where that canvas pixel is zero.
//   k90 = +1: c0[y, x] = pad[S-1-x, y];  k90 = -1: c0[y, x] = pad[x, S-1-y].
__device__ __forceinline__ int c0_offset(int y, int x, int k90, int S, int P, int H, int W,
                                         int C) {
  int a = y, b = x;
  if (k90 == 1) {
    a = S - 1 - x;
    b = y;
  } else if (k90 == -1) {
    a = x;
    b = S - 1 - y;
  }
  a -= P;
  b -= P;
  if (a < 0 || a >= H || b < 0 || b >= W) return -1;
  return (a * W + b) * C;
}

__global__ void warp_shear3_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   const int* __restrict__ flags,
                                   const float* __restrict__ coef, int B, int H, int W, int C,
                                   int S, int P) {
  const long long n = static_cast<long long>(B) * H * W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx % W);
  const int i = static_cast<int>((idx / W) % H);
  const int b = static_cast<int>(idx / (static_cast<long long>(H) * W));
  const float* img = x + static_cast<long long>(b) * H * W * C;
  float* dst = out + idx * C;

  const int k90 = flags[4 * b], on1 = flags[4 * b + 1], on2 = flags[4 * b + 2],
            on3 = flags[4 * b + 3];
  if (!(k90 | on1 | on2 | on3)) {  // identity warp
    const float* src = img + (static_cast<long long>(i) * W + j) * C;
    for (int c = 0; c < C; ++c) dst[c] = src[c];
    return;
  }
  const float p1 = coef[5 * b], t1 = coef[5 * b + 1], p2 = coef[5 * b + 2],
              t2 = coef[5 * b + 3], p3 = coef[5 * b + 4];
  const float cen = 0.5f * static_cast<float>(S - 1);
  const int Y = P + i, X = P + j;

  // Tree of taps: [a] pass-3 tap (a column of pass 2's output on row Y),
  // [r] pass-2 tap (a row of pass 1's output on that column), [t] pass-1
  // tap (a column of the quarter-turned canvas on that row).
  int off[2][2][2];
  float f1[2][2], f2[2], f3 = 0.0f;
  int x3[2] = {X, X};
  if (on3) {
    Shear s = shear_at(p3, 0.0f, Y, cen);
    x3[0] = X + s.k;
    x3[1] = X + s.k + 1;
    f3 = s.f;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const bool va = in_canvas(x3[a], S);
    int y2[2] = {Y, Y};
    f2[a] = 0.0f;
    if (on2) {
      Shear s = shear_at(p2, t2, x3[a], cen);
      y2[0] = Y + s.k;
      y2[1] = Y + s.k + 1;
      f2[a] = s.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool vr = va && in_canvas(y2[r], S);
      int x1[2] = {x3[a], x3[a]};
      f1[a][r] = 0.0f;
      if (on1) {
        Shear s = shear_at(p1, t1, y2[r], cen);
        x1[0] = x3[a] + s.k;
        x1[1] = x3[a] + s.k + 1;
        f1[a][r] = s.f;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        off[a][r][t] = (vr && in_canvas(x1[t], S)) ? c0_offset(y2[r], x1[t], k90, S, P, H, W, C)
                                                   : -1;
      }
    }
  }

  for (int c = 0; c < C; ++c) {
    float v2[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float v1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float t0 = off[a][r][0] >= 0 ? img[off[a][r][0] + c] : 0.0f;
        if (on1) {
          const float tb = off[a][r][1] >= 0 ? img[off[a][r][1] + c] : 0.0f;
          v1[r] = lerp_rn(t0, tb, f1[a][r]);
        } else {
          v1[r] = t0;
        }
      }
      v2[a] = on2 ? lerp_rn(v1[0], v1[1], f2[a]) : v1[0];
    }
    dst[c] = on3 ? lerp_rn(v2[0], v2[1], f3) : v2[0];
  }
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
  const long long n = static_cast<long long>(B) * H * W;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL || static_cast<long long>(H) * W * C > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  warp_shear3_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, flags, coef, B, H, W, C, S,
                                                            P);
  return static_cast<int>(cudaGetLastError());
}
