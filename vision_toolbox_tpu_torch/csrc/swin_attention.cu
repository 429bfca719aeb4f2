// Swin window attention, forward (K7): per window and head,
//   out = softmax((q·scale)·kᵀ + pe + mask)·v,
// q/k/v/out (B, nW, T, N·hd) in the projections' packed layout, f32 or bf16; pe
// (1, N, T, T) and the optional constant shift mask (nW, T, T), each f32 or bf16 and
// added separately in f32; scale = hd^−½; out rounded once to the input type.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/swin_attention.py
// `_swin_attention_fwd` (`_fwd_kernel`): one grid program per image walks its windows
// in a fori loop and slices heads out of the packed lanes, the whole (T, T) score
// matrix in VMEM. Here the programs run in parallel, a block per (run of windows,
// head), reading the packed layout directly, with two kernels:
//  - bf16 operands, windows of up to 64 tokens (window 7 and 8: every registered
//    Swin's but the S3 variants' window 14), heads a multiple of 16: the tensor
//    cores. The block holds the window-head whole in shared memory: q·kᵀ on wmma
//    tiles with f32 accumulation, then ·scale + pe + mask, the softmax in f32 a
//    warp a row, p as two bf16 planes (never rounded to bf16 once), p·v on the
//    tensor cores (swin_attention.cuh TcSmem). The logits are (q·kᵀ)·scale, where
//    the TPU kernel sums (q·scale)·k: the same value up to f32 rounding.
//  - everything else (f32 operands, windows of 14 or 16): the CUDA cores, a warp
//    a query row with its score row in registers (swin_attention.cuh), the
//    TPU kernel's f32 arithmetic in its order.
// No (T, T) matrix goes to device memory.
//
// What bounds it: at swin_t stage 1, batch 128 (24,576 window-head pairs of 49 × 49 ×
// 32, bf16) q, k, v and out are 308 MB, 0.092 ms at 3.35 TB/s; its 7.6 GFLOP of
// products take 0.008 ms at the tensor cores' 989 TFLOP/s (0.11 ms at the CUDA
// cores' 67). The tensor-core kernel pads each window to 64 rows and runs p·v on
// two planes of p: 4.6× the products the window needs.
#include "wmma_planes.cuh"
#include "swin_attention.cuh"

using namespace vtt_swin;

namespace {

namespace wmma = nvcuda::wmma;
using vtt_flash::Acc;

// Forward on the tensor cores (swin_attention.cuh TcSmem): per window-head, S = q·kᵀ,
// the row step, O = p·v, O rounded once to bf16.
__global__ void __launch_bounds__(NT)
swin_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const void* __restrict__ pe, int pe_bf16,
                   const void* __restrict__ mask, int mask_bf16, bf16* __restrict__ out,
                   int n_windows, int nW, int T_, int D, int hd, int per_block, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TcSmem L(T_, hd, 3, 1, 1, false);
  const int h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tp = L.tp, tiles = tp / 16, op_plane = tp * L.ldh, p_plane = tp * L.ldp;
  bf16* qs = reinterpret_cast<bf16*>(smem + L.ops);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.ops + L.op_bytes);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.ops + 2 * L.op_bytes);
  float* sf = reinterpret_cast<float*>(smem + L.f);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
  float* of = reinterpret_cast<float*>(smem + L.o);
  const size_t pe_base = static_cast<size_t>(h) * T_ * T_;
  const int first = blockIdx.x * per_block, last = min(n_windows, first + per_block);

  for (int bw = first; bw < last; ++bw) {
    const size_t base = static_cast<size_t>(bw) * T_ * D + static_cast<size_t>(h) * hd;
    const size_t mask_base = static_cast<size_t>(bw % nW) * T_ * T_;
    __syncthreads();  // the last window is done with every tile
    vtt_flash::load_rows<bf16, 1>(q + base, 0, tp, T_, D, hd, qs, L.ldh, op_plane);
    vtt_flash::load_rows<bf16, 1>(k + base, 0, tp, T_, D, hd, ks, L.ldh, op_plane);
    vtt_flash::load_rows<bf16, 1>(v + base, 0, tp, T_, D, hd, vs, L.ldh, op_plane);
    __syncthreads();
    for (int t = warp; t < tiles * tiles; t += NW) {  // S = q·kᵀ
      const int i = t % tiles, j = t / tiles;
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      vtt_flash::mma_planes<wmma::row_major, wmma::col_major, 1, 1>(
          acc, qs + i * 16 * L.ldh, L.ldh, 16, op_plane, ks + j * 16 * L.ldh, L.ldh, 16,
          op_plane, hd);
      wmma::store_matrix_sync(sf + i * 16 * L.lds + j * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncthreads();
    for (int r = warp; r < tp; r += NW) {  // the row step
      float p[2];
      tc_softmax_row(sf + r * L.lds, r, T_, scale, pe, pe_bf16, pe_base, mask, mask_bf16,
                     mask_base, p);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        if (s < tp) vtt_flash::split_store<2>(p[u], ps + r * L.ldp + s, p_plane);
      }
    }
    __syncthreads();
    for (int t = warp; t < tiles * (hd / 16); t += NW) {  // O = p·v
      const int i = t % tiles, j = t / tiles;
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      vtt_flash::mma_planes<wmma::row_major, wmma::row_major, 2, 1>(
          acc, ps + i * 16 * L.ldp, L.ldp, 16, p_plane, vs + j * 16, L.ldh, 16 * L.ldh,
          op_plane, tp);
      wmma::store_matrix_sync(of + i * 16 * L.ldo + j * 16, acc, L.ldo, wmma::mem_row_major);
    }
    __syncthreads();
    for (int r = warp; r < T_; r += NW) {
      for (int c = lane; c < hd; c += 32) {
        out[base + static_cast<size_t>(r) * D + c] = __float2bfloat16(of[r * L.ldo + c]);
      }
    }
  }
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(NT)
swin_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const void* __restrict__ pe, int pe_bf16, const void* __restrict__ mask,
                int mask_bf16, T* __restrict__ out, int n_windows, int nW, int T_, int D, int hd,
                int per_block, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pitch = stage_pitch<T>(hd);
  const size_t op_bytes = staged_bytes<T>(1, T_, hd);
  float* prow = reinterpret_cast<float*>(smem) + warp * warp_row_floats(1, 1, T_, hd);
  float* qrow = prow + pad4(T_);  // the row's probabilities, then its q·scale
  T* sq = reinterpret_cast<T*>(smem + warp_rows_bytes(1, 1, T_, hd));
  T* sk = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sq) + op_bytes);
  T* sv = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sq) + 2 * op_bytes);
  const size_t pe_base = static_cast<size_t>(h) * T_ * T_;
  const int first = blockIdx.x * per_block, last = min(n_windows, first + per_block);

  for (int bw = first; bw < last; ++bw) {
    const size_t base = static_cast<size_t>(bw) * T_ * D + static_cast<size_t>(h) * hd;
    View<T> Q{q + base, D}, K{k + base, D}, V{v + base, D};
    if constexpr (STAGED) {
      __syncthreads();  // the last window's rows are done with the staged operands
      stage(q + base, T_, D, hd, sq, pitch);
      stage(k + base, T_, D, hd, sk, pitch);
      stage(v + base, T_, D, hd, sv, pitch);
      __syncthreads();
      Q = View<T>{sq, pitch};
      K = View<T>{sk, pitch};
      V = View<T>{sv, pitch};
    }
    const size_t mask_base = static_cast<size_t>(bw % nW) * T_ * T_;
    for (int t = warp; t < T_; t += NW) {
      float p[SLOTS], m, l;
      head_row(Q, t, hd, scale, qrow);
      logits_row(qrow, K, t, T_, hd, pe, pe_bf16, pe_base, mask, mask_bf16, mask_base, p);
      softmax_row(p, T_, m, l);
      float acc[DSLOTS] = {};
      put_row(p, T_, prow);
      weighted_rows(prow, V, T_, hd, 1.0f, acc);
#pragma unroll
      for (int j = 0; j < DSLOTS; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) out[base + static_cast<size_t>(t) * D + d] = from_f32<T>(acc[j]);
      }
    }
  }
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* pe, int pe_bf16,
                      const void* mask, int mask_bf16, void* out, int B, int nW, int T_, int N,
                      int hd, int per_block, float scale, cudaStream_t st) {
  const int n_windows = B * nW;
  const TcSmem L(T_, hd, 3, 1, 1, false);
  cudaError_t err = cudaFuncSetAttribute(swin_fwd_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_windows + per_block - 1) / per_block, N);
  swin_fwd_tc_kernel<<<grid, NT, L.total, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), pe,
      pe_bf16, mask, mask_bf16, static_cast<bf16*>(out), n_windows, nW, T_, N * hd, hd,
      per_block, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pe, int pe_bf16,
                   const void* mask, int mask_bf16, void* out, int B, int nW, int T_, int N,
                   int hd, int per_block, float scale, cudaStream_t st) {
  const int n_windows = B * nW;
  const size_t rows = warp_rows_bytes(1, 1, T_, hd), ops = staged_bytes<T>(3, T_, hd);
  const bool staged = rows + ops <= kMaxSmem;
  const size_t dyn = rows + (staged ? ops : 0);
  auto kernel = staged ? swin_fwd_kernel<T, true> : swin_fwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_windows + per_block - 1) / per_block, N);
  kernel<<<grid, NT, dyn, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                static_cast<const T*>(v), pe, pe_bf16, mask, mask_bf16,
                                static_cast<T*>(out), n_windows, nW, T_, N * hd, hd, per_block,
                                scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (B, nW, T, N·hd), f32 or bf16 (is_bf16); pe (1, N, T, T); mask (nW, T, T) or
// null; a block takes `per_block` consecutive windows of the B·nW (ops/swin_attention.py).
extern "C" int vtt_swin_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* pe, int pe_bf16, const void* mask,
                                      int mask_bf16, int is_bf16, void* out, int B, int nW,
                                      int T, int N, int hd, int per_block, float scale,
                                      void* stream) {
  if (B < 1 || nW < 1 || T < 1 || T > MAX_SEQ || N < 1 || N > 65535 || hd < 1 ||
      hd > MAX_HEAD || per_block < 1 || static_cast<long long>(B) * nW > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_tc(is_bf16, T, hd)) {
    err = launch_tc(q, k, v, pe, pe_bf16, mask, mask_bf16, out, B, nW, T, N, hd, per_block,
                    scale, st);
  } else if (is_bf16) {
    err = launch<bf16>(q, k, v, pe, pe_bf16, mask, mask_bf16, out, B, nW, T, N, hd, per_block,
                       scale, st);
  } else {
    err = launch<float>(q, k, v, pe, pe_bf16, mask, mask_bf16, out, B, nW, T, N, hd, per_block,
                        scale, st);
  }
  return static_cast<int>(err);
}
