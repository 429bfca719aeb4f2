// Swin's shifted-window relayout (K8), both directions:
//   partition:   y[b][ih·nW + iw][r·w + c][:] = x[b][(ih·w + r + s) mod H][(iw·w + c + s) mod W][:]
//                (a cyclic roll by (−s, −s), then (B, H, W, C) → (B, nH·nW, w², C));
//   unpartition: the inverse, (B, nH·nW, w², C) → (B, H, W, C), then the roll by (+s, +s).
// Each direction is the other's gradient (ops/swin_relayout.py).
//
// Replaces the TPU kernels vision_toolbox_tpu/ops/swin_relayout.py `_part_call`
// (`_partition_kernel`) and `_unpart_call` (`_unpartition_kernel`), which hold one
// whole image in VMEM, roll it with two concatenations and write each window row as a
// strided slice. Here nothing is staged: one thread per vector of the channel axis of
// one output pixel computes the pixel it comes from and copies it, so the output is
// written in order and each input pixel's C elements are read once, as 16-byte loads
// where the pixel's bytes allow (C·element size a multiple of 16), else 8, 4, 2 or 1.
// It is a permutation of whole elements: the result is bit-exact for any type.
//
// What bounds it: pure data movement, one read and one write of the map; at swin_t
// stage 1, batch 128 (56² × 96 bf16) that is 154 MB, 0.046 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

// Source pixel (y, x) of token `tok` of window `win` in the partition direction.
__device__ __forceinline__ void window_pixel(int win, int tok, int w, int nWc, int H, int W, int s,
                                             int& y, int& x) {
  const int ih = win / nWc, iw = win % nWc, r = tok / w, c = tok % w;
  y = ih * w + r + s;
  x = iw * w + c + s;
  if (y >= H) y -= H;
  if (x >= W) x -= W;
}

// y = partition(x): one thread per V-sized piece of an output token's channels.
template <typename V>
__global__ void __launch_bounds__(NT)
partition_kernel(const V* __restrict__ x, V* __restrict__ out, long long n, int per_pixel,
                 int H, int W, int w, int s) {
  const int nWc = W / w, n_win = (H / w) * nWc, w2 = w * w;
  for (long long i = blockIdx.x * static_cast<long long>(NT) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * NT) {
    const int v = static_cast<int>(i % per_pixel);
    const long long pix = i / per_pixel;  // (b, win, tok) of the output
    const int tok = static_cast<int>(pix % w2);
    const long long bw = pix / w2;
    const int win = static_cast<int>(bw % n_win);
    const long long b = bw / n_win;
    int y, xx;
    window_pixel(win, tok, w, nWc, H, W, s, y, xx);
    out[i] = x[((b * H + y) * W + xx) * per_pixel + v];
  }
}

// x = unpartition(y): one thread per V-sized piece of an output pixel's channels.
template <typename V>
__global__ void __launch_bounds__(NT)
unpartition_kernel(const V* __restrict__ y, V* __restrict__ out, long long n, int per_pixel,
                   int H, int W, int w, int s) {
  const int nWc = W / w, n_win = (H / w) * nWc, w2 = w * w;
  for (long long i = blockIdx.x * static_cast<long long>(NT) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * NT) {
    const int v = static_cast<int>(i % per_pixel);
    const long long pix = i / per_pixel;  // (b, py, px) of the output
    const int px = static_cast<int>(pix % W);
    const long long by = pix / W;
    const int py = static_cast<int>(by % H);
    const long long b = by / H;
    int ry = py - s, rx = px - s;  // the rolled image's pixel this one came from
    if (ry < 0) ry += H;
    if (rx < 0) rx += W;
    const int win = (ry / w) * nWc + rx / w, tok = (ry % w) * w + rx % w;
    out[i] = y[((b * n_win + win) * w2 + tok) * per_pixel + v];
  }
}

template <typename V>
cudaError_t launch(bool unpart, const void* in, void* out, long long pixels, long long row_bytes,
                   int H, int W, int w, int s, cudaStream_t st) {
  const int per_pixel = static_cast<int>(row_bytes / sizeof(V));
  const long long n = pixels * per_pixel;
  const long long blocks = (n + NT - 1) / NT;
  const int grid = static_cast<int>(blocks < 132LL * 64 ? blocks : 132LL * 64);
  if (unpart) {
    unpartition_kernel<V><<<grid, NT, 0, st>>>(static_cast<const V*>(in), static_cast<V*>(out),
                                                n, per_pixel, H, W, w, s);
  } else {
    partition_kernel<V><<<grid, NT, 0, st>>>(static_cast<const V*>(in), static_cast<V*>(out), n,
                                              per_pixel, H, W, w, s);
  }
  return cudaGetLastError();
}

int relayout(bool unpart, const void* in, void* out, int B, int H, int W, int C, int elem_bytes,
             int w, int s, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || elem_bytes < 1 || w < 1 || H % w || W % w || s < 0 ||
      s >= w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pixels = static_cast<long long>(B) * H * W;
  const long long row = static_cast<long long>(C) * elem_bytes;
  // the widest piece that divides a pixel's bytes and the buffers' alignment
  const uintptr_t align = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
  cudaError_t err;
  if (row % 16 == 0 && align % 16 == 0) {
    err = launch<uint4>(unpart, in, out, pixels, row, H, W, w, s, st);
  } else if (row % 8 == 0 && align % 8 == 0) {
    err = launch<uint2>(unpart, in, out, pixels, row, H, W, w, s, st);
  } else if (row % 4 == 0 && align % 4 == 0) {
    err = launch<uint32_t>(unpart, in, out, pixels, row, H, W, w, s, st);
  } else if (row % 2 == 0 && align % 2 == 0) {
    err = launch<uint16_t>(unpart, in, out, pixels, row, H, W, w, s, st);
  } else {
    err = launch<uint8_t>(unpart, in, out, pixels, row, H, W, w, s, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// x (B, H, W, C) → out (B, (H/w)·(W/w), w², C), any element size; 0 ≤ s < w.
extern "C" int vtt_swin_partition(const void* x, void* out, int B, int H, int W, int C,
                                  int elem_bytes, int w, int s, void* stream) {
  return relayout(false, x, out, B, H, W, C, elem_bytes, w, s, stream);
}

// y (B, (H/w)·(W/w), w², C) → out (B, H, W, C), the inverse of vtt_swin_partition.
extern "C" int vtt_swin_unpartition(const void* y, void* out, int B, int H, int W, int C,
                                    int elem_bytes, int w, int s, void* stream) {
  return relayout(true, y, out, B, H, W, C, elem_bytes, w, s, stream);
}
