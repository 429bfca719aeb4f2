// Swin window attention, backward (K7): from q, k, v, pe, the mask and the output
// cotangent g, per window and head, with p recomputed,
//   dv = pᵀ·g,   dp = g·vᵀ,   ds = p ⊙ (dp − rowsum(dp ⊙ p)),
//   dq = (ds·k)·scale,   dk = dsᵀ·(q·scale),   dPE[h] = Σ_{batch, windows} ds,
// dq, dk, dv (B, nW, T, N·hd) in the input type, dPE (1, N, T, T) f32; every
// intermediate f32. The mask's cotangent is zero and is not computed here.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/swin_attention.py
// `_swin_attention_bwd` (`_bwd_kernel`), which walks the images in order and carries
// dPE in a VMEM scratch across its sequential grid. Here blocks run in parallel
// (swin_attention.cuh's blocks: a run of windows, one head), each adding ds into its
// own (T, T) dPE partial, row t always by warp t mod 8, so in a fixed order; a
// second launch sums the blocks' partials in block order. No atomics: the same bits
// on every run. Two kernels, as in the forward (swin_attention.cu):
//  - the tensor cores (bf16, windows of up to 64 tokens, heads a multiple of 16):
//    the window-head whole in shared memory; q·kᵀ and g·vᵀ on wmma tiles; the row
//    step (p, delta, ds, the dPE partial) a warp a row; p and ds as two bf16
//    planes each; dv = pᵀ·g, dk = dsᵀ·q·scale, dq = ds·k·scale on the tensor cores.
//  - the CUDA cores (everything else): a row pass, a warp per query row t (p and
//    m, l (max, Σe) recomputed, dp, delta, ds, dq), then a key pass, a warp per key
//    s, lane j the rows j + 32i, that recomputes p and ds bit for bit from the row
//    pass's m, l and delta and sums dk and dv over the rows in order: no (T, T)
//    plane of p or ds is kept. The dPE partial is a shared-memory plane where it
//    fits beside the staged operands (150 KB at window 14, T = 196), else in device
//    memory.
//
// What bounds it: at swin_t stage 1, batch 128 (bf16), q, k, v, g in and dq, dk, dv
// out are 539 MB, 0.16 ms at 3.35 TB/s; its five products (q·kᵀ, g·vᵀ and the three
// gradients) are 19 GFLOP, 0.02 ms on the tensor cores.
#include "wmma_planes.cuh"
#include "swin_attention.cuh"

using namespace vtt_swin;

namespace {

namespace wmma = nvcuda::wmma;
using vtt_flash::Acc;

constexpr int REDUCE_THREADS = 256;

// One gradient of the tensor-core backward: acc = a·b over the window (depth `depth`)
// tile by tile into the staging tile, then rows < T × `cols` columns, times `alpha`,
// rounded to bf16 into out (row stride D). LA and a_step pick pᵀ/dsᵀ (column-major
// reads of the [query][key] planes) or ds (row-major).
template <typename LA, int NA>
__device__ __forceinline__ void tc_gradient(const bf16* a, int lda, int a_step, int a_plane,
                                            int a_tile_step, const bf16* b, int ldb, int b_plane,
                                            int depth, int tiles, int hd, float* of, int ldo,
                                            int T_, int D, float alpha, bf16* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < tiles * (hd / 16); t += NW) {
    const int i = t % tiles, j = t / tiles;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    vtt_flash::mma_planes<LA, wmma::row_major, NA, 1>(acc, a + i * a_tile_step, lda, a_step,
                                                      a_plane, b + j * 16, ldb, 16 * ldb, b_plane,
                                                      depth);
    wmma::store_matrix_sync(of + i * 16 * ldo + j * 16, acc, ldo, wmma::mem_row_major);
  }
  __syncthreads();
  for (int r = warp; r < T_; r += NW) {
    for (int c = lane; c < hd; c += 32) {
      out[static_cast<size_t>(r) * D + c] = __float2bfloat16(of[r * ldo + c] * alpha);
    }
  }
  __syncthreads();  // the staging tile is free again
}

// Backward on the tensor cores (swin_attention.cuh TcSmem): per window-head, S = q·kᵀ
// and dP = g·vᵀ, the row step (p, delta, ds, the dPE partial: row r by warp r mod
// 8), then dv = pᵀ·g, dk = dsᵀ·q·scale, dq = ds·k·scale through the staging tile.
__global__ void __launch_bounds__(NT)
swin_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const void* __restrict__ pe, int pe_bf16, const void* __restrict__ mask,
                   int mask_bf16, bf16* __restrict__ dq, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, float* __restrict__ partials, int n_windows, int nW,
                   int T_, int D, int hd, int per_block, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TcSmem L(T_, hd, 4, 2, 2, true);
  const int h = blockIdx.y, N = gridDim.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tp = L.tp, tiles = tp / 16, op_plane = tp * L.ldh, p_plane = tp * L.ldp;
  bf16* qs = reinterpret_cast<bf16*>(smem + L.ops);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.ops + L.op_bytes);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.ops + 2 * L.op_bytes);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.ops + 3 * L.op_bytes);
  float* sf = reinterpret_cast<float*>(smem + L.f);
  float* dpf = reinterpret_cast<float*>(smem + L.f + L.f_bytes);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
  bf16* dss = reinterpret_cast<bf16*>(smem + L.p + L.p_bytes);
  float* of = reinterpret_cast<float*>(smem + L.o);
  float* dpe = reinterpret_cast<float*>(smem + L.dpe);
  const size_t plane = static_cast<size_t>(T_) * T_, pe_base = static_cast<size_t>(h) * plane;
  for (size_t i = threadIdx.x; i < plane; i += NT) dpe[i] = 0.0f;
  const int first = blockIdx.x * per_block, last = min(n_windows, first + per_block);

  for (int bw = first; bw < last; ++bw) {
    const size_t base = static_cast<size_t>(bw) * T_ * D + static_cast<size_t>(h) * hd;
    const size_t mask_base = static_cast<size_t>(bw % nW) * plane;
    __syncthreads();  // the last window is done with every tile
    vtt_flash::load_rows<bf16, 1>(q + base, 0, tp, T_, D, hd, qs, L.ldh, op_plane);
    vtt_flash::load_rows<bf16, 1>(k + base, 0, tp, T_, D, hd, ks, L.ldh, op_plane);
    vtt_flash::load_rows<bf16, 1>(v + base, 0, tp, T_, D, hd, vs, L.ldh, op_plane);
    vtt_flash::load_rows<bf16, 1>(g + base, 0, tp, T_, D, hd, gs, L.ldh, op_plane);
    __syncthreads();
    for (int t = warp; t < 2 * tiles * tiles; t += NW) {  // S = q·kᵀ, dP = g·vᵀ
      const int which = t / (tiles * tiles), rem = t % (tiles * tiles);
      const int i = rem % tiles, j = rem / tiles;
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      vtt_flash::mma_planes<wmma::row_major, wmma::col_major, 1, 1>(
          acc, (which ? gs : qs) + i * 16 * L.ldh, L.ldh, 16, op_plane,
          (which ? vs : ks) + j * 16 * L.ldh, L.ldh, 16, op_plane, hd);
      wmma::store_matrix_sync((which ? dpf : sf) + i * 16 * L.lds + j * 16, acc, L.lds,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int r = warp; r < tp; r += NW) {  // the row step
      float p[2], ds[2];
      tc_softmax_row(sf + r * L.lds, r, T_, scale, pe, pe_bf16, pe_base, mask, mask_bf16,
                     mask_base, p);
      float pdp = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        ds[u] = s < tp ? dpf[r * L.lds + s] : 0.0f;
        pdp += p[u] * ds[u];
      }
      const float delta = warp_sum(pdp);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        ds[u] = p[u] * (ds[u] - delta);
        if (r < T_ && s < T_) dpe[static_cast<size_t>(r) * T_ + s] += ds[u];
        if (s < tp) {
          vtt_flash::split_store<2>(p[u], ps + r * L.ldp + s, p_plane);
          vtt_flash::split_store<2>(ds[u], dss + r * L.ldp + s, p_plane);
        }
      }
    }
    __syncthreads();
    // dv = pᵀ·g and dk = dsᵀ·q (depth: the query rows), dq = ds·k (depth: the keys)
    tc_gradient<wmma::col_major, 2>(ps, L.ldp, 16 * L.ldp, p_plane, 16, gs, L.ldh, op_plane,
                                    tp, tiles, hd, of, L.ldo, T_, D, 1.0f, dv + base);
    tc_gradient<wmma::col_major, 2>(dss, L.ldp, 16 * L.ldp, p_plane, 16, qs, L.ldh, op_plane,
                                    tp, tiles, hd, of, L.ldo, T_, D, scale, dk + base);
    tc_gradient<wmma::row_major, 2>(dss, L.ldp, 16, p_plane, 16 * L.ldp, ks, L.ldh, op_plane,
                                    tp, tiles, hd, of, L.ldo, T_, D, scale, dq + base);
  }
  __syncthreads();
  float* own = partials + (static_cast<size_t>(blockIdx.x) * N + h) * plane;
  for (size_t i = threadIdx.x; i < plane; i += NT) own[i] = dpe[i];
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(NT)
swin_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ g, const void* __restrict__ pe, int pe_bf16,
                const void* __restrict__ mask, int mask_bf16, T* __restrict__ dq,
                T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ partials,
                int n_windows, int nW, int T_, int D, int hd, int per_block, float scale,
                int plane_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, N = gridDim.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pitch = stage_pitch<T>(hd);
  const size_t op_bytes = staged_bytes<T>(1, T_, hd), plane = static_cast<size_t>(T_) * T_;
  // this warp's rows: two of T (score gradients, probabilities), two of hd
  float* wrow = reinterpret_cast<float*>(smem) + warp * warp_row_floats(2, 2, T_, hd);
  float* prow = wrow + pad4(T_);
  float* hrow0 = prow + pad4(T_);  // q·scale (row pass) or k (key pass)
  float* hrow1 = hrow0 + pad4(hd);  // g (row pass) or v (key pass)
  unsigned char* ops = smem + warp_rows_bytes(2, 2, T_, hd);
  unsigned char* rest = ops + (STAGED ? 4 * op_bytes : 0);
  float* row_m = reinterpret_cast<float*>(rest);  // per query row: max, Σe, delta
  float* row_l = row_m + T_;
  float* row_delta = row_l + T_;
  float* own = partials + (static_cast<size_t>(blockIdx.x) * N + h) * plane;
  float* dpe = plane_in_smem ? reinterpret_cast<float*>(rest + align16(3 * T_ * sizeof(float)))
                             : own;
  for (size_t i = threadIdx.x; i < plane; i += NT) dpe[i] = 0.0f;
  const size_t pe_base = static_cast<size_t>(h) * plane;
  const int first = blockIdx.x * per_block, last = min(n_windows, first + per_block);

  for (int bw = first; bw < last; ++bw) {
    const size_t base = static_cast<size_t>(bw) * T_ * D + static_cast<size_t>(h) * hd;
    View<T> Q{q + base, D}, K{k + base, D}, V{v + base, D}, G{g + base, D};
    __syncthreads();  // the last window's key pass is done with the stats and operands
    if constexpr (STAGED) {
      T* s0 = reinterpret_cast<T*>(ops);
      T* s1 = reinterpret_cast<T*>(ops + op_bytes);
      T* s2 = reinterpret_cast<T*>(ops + 2 * op_bytes);
      T* s3 = reinterpret_cast<T*>(ops + 3 * op_bytes);
      stage(q + base, T_, D, hd, s0, pitch);
      stage(k + base, T_, D, hd, s1, pitch);
      stage(v + base, T_, D, hd, s2, pitch);
      stage(g + base, T_, D, hd, s3, pitch);
      __syncthreads();
      Q = View<T>{s0, pitch};
      K = View<T>{s1, pitch};
      V = View<T>{s2, pitch};
      G = View<T>{s3, pitch};
    }
    const size_t mask_base = static_cast<size_t>(bw % nW) * plane;

    // row pass: dq, the row statistics and the dPE partial
    for (int t = warp; t < T_; t += NW) {
      float p[SLOTS], ds[SLOTS], m, l;
      head_row(Q, t, hd, scale, hrow0);
      head_row(G, t, hd, 1.0f, hrow1);
      logits_row(hrow0, K, t, T_, hd, pe, pe_bf16, pe_base, mask, mask_bf16, mask_base, p);
      softmax_row(p, T_, m, l);
      dots(hrow1, V, T_, hd, 1.0f, ds);  // dp = g·vᵀ
      float pdp = 0.0f;
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) pdp += ds[i] * p[i];
      const float delta = warp_sum(pdp);
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int s = lane + 32 * i;
        ds[i] = p[i] * (ds[i] - delta);
        if (s < T_) dpe[static_cast<size_t>(t) * T_ + s] += ds[i];
      }
      float acc[DSLOTS] = {};
      put_row(ds, T_, wrow);
      weighted_rows(wrow, K, T_, hd, 1.0f, acc);
#pragma unroll
      for (int j = 0; j < DSLOTS; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) dq[base + static_cast<size_t>(t) * D + d] = from_f32<T>(acc[j] * scale);
      }
      if (lane == 0) {
        row_m[t] = m;
        row_l[t] = l;
        row_delta[t] = delta;
      }
    }
    __syncthreads();

    // key pass: dk and dv, summed over the query rows in order
    for (int s = warp; s < T_; s += NW) {
      float p[SLOTS], ds[SLOTS];
      head_row(K, s, hd, 1.0f, hrow0);
      head_row(V, s, hd, 1.0f, hrow1);
      dots(hrow0, Q, T_, hd, scale, p);  // (q·scale)·k, the row pass's logits
      dots(hrow1, G, T_, hd, 1.0f, ds);  // g·v, the row pass's dp
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int t = lane + 32 * i;
        if (t < T_) {
          const size_t at = static_cast<size_t>(t) * T_ + s;
          const float x = add_bias(p[i], pe, pe_bf16, mask, mask_bf16, pe_base + at,
                                   mask_base + at);
          p[i] = expf(x - row_m[t]) / row_l[t];
          ds[i] = p[i] * (ds[i] - row_delta[t]);
        }
      }
      float acc_k[DSLOTS] = {}, acc_v[DSLOTS] = {};
      put_row(ds, T_, wrow);
      put_row(p, T_, prow);
      weighted_rows(wrow, Q, T_, hd, scale, acc_k);
      weighted_rows(prow, G, T_, hd, 1.0f, acc_v);
#pragma unroll
      for (int j = 0; j < DSLOTS; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) {
          const size_t at = base + static_cast<size_t>(s) * D + d;
          dk[at] = from_f32<T>(acc_k[j]);
          dv[at] = from_f32<T>(acc_v[j]);
        }
      }
    }
  }
  if (plane_in_smem) {
    __syncthreads();
    for (size_t i = threadIdx.x; i < plane; i += NT) own[i] = dpe[i];
  }
}

// dpe[i] = Σ_b partials[b][i] over the n blocks, in block order; one thread per value.
__global__ void __launch_bounds__(REDUCE_THREADS)
dpe_reduce_kernel(const float* __restrict__ partials, int n, size_t per, float* __restrict__ dpe) {
  const size_t i = blockIdx.x * static_cast<size_t>(REDUCE_THREADS) + threadIdx.x;
  if (i >= per) return;
  float acc = 0.0f;
  for (int b = 0; b < n; ++b) acc += partials[b * per + i];
  dpe[i] = acc;
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* g, const void* pe,
                      int pe_bf16, const void* mask, int mask_bf16, void* dq, void* dk, void* dv,
                      float* partials, int n_windows, int blocks, int nW, int T_, int N, int hd,
                      int per_block, float scale, cudaStream_t st) {
  const TcSmem L(T_, hd, 4, 2, 2, true);
  cudaError_t err = cudaFuncSetAttribute(swin_bwd_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  swin_bwd_tc_kernel<<<dim3(blocks, N), NT, L.total, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), pe, pe_bf16, mask, mask_bf16, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), partials, n_windows, nW, T_, N * hd, hd,
      per_block, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* g, const void* pe,
                        int pe_bf16, const void* mask, int mask_bf16, void* dq, void* dk,
                        void* dv, float* partials, int n_windows, int blocks, int nW, int T_,
                        int N, int hd, int per_block, float scale, cudaStream_t st) {
  const size_t ops = staged_bytes<T>(4, T_, hd), stats = align16(3 * T_ * sizeof(float));
  const size_t plane = static_cast<size_t>(T_) * T_ * sizeof(float);
  const size_t rows = warp_rows_bytes(2, 2, T_, hd);
  const bool staged = rows + ops + stats <= kMaxSmem;
  const size_t base = rows + (staged ? ops : 0) + stats;
  const int plane_in_smem = base + plane <= kMaxSmem;
  const size_t dyn = base + (plane_in_smem ? plane : 0);
  auto kernel = staged ? swin_bwd_kernel<T, true> : swin_bwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, N), NT, dyn, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), pe, pe_bf16, mask, mask_bf16, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), partials, n_windows, nW, T_, N * hd, hd,
      per_block, scale, plane_in_smem);
  return cudaGetLastError();
}

}  // namespace

// As vtt_swin_attention_fwd, with the cotangent g like q; dq, dk, dv like q; scratch
// `partials` (⌈B·nW / per_block⌉, N, T, T) f32 from the caller; dpe (N, T, T) f32.
extern "C" int vtt_swin_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                      const void* pe, int pe_bf16, const void* mask,
                                      int mask_bf16, int is_bf16, void* dq, void* dk, void* dv,
                                      float* partials, float* dpe, int B, int nW, int T, int N,
                                      int hd, int per_block, float scale, void* stream) {
  if (B < 1 || nW < 1 || T < 1 || T > MAX_SEQ || N < 1 || N > 65535 || hd < 1 ||
      hd > MAX_HEAD || per_block < 1 || static_cast<long long>(B) * nW > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_windows = B * nW, blocks = (n_windows + per_block - 1) / per_block;
  cudaError_t err;
  if (use_tc(is_bf16, T, hd)) {
    err = launch_tc(q, k, v, g, pe, pe_bf16, mask, mask_bf16, dq, dk, dv, partials, n_windows,
                    blocks, nW, T, N, hd, per_block, scale, st);
  } else if (is_bf16) {
    err = launch_simt<bf16>(q, k, v, g, pe, pe_bf16, mask, mask_bf16, dq, dk, dv, partials,
                            n_windows, blocks, nW, T, N, hd, per_block, scale, st);
  } else {
    err = launch_simt<float>(q, k, v, g, pe, pe_bf16, mask, mask_bf16, dq, dk, dv, partials,
                             n_windows, blocks, nW, T, N, hd, per_block, scale, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t per = static_cast<size_t>(N) * T * T;
  dpe_reduce_kernel<<<static_cast<unsigned>((per + REDUCE_THREADS - 1) / REDUCE_THREADS),
                      REDUCE_THREADS, 0, st>>>(partials, blocks, per, dpe);
  return static_cast<int>(cudaGetLastError());
}
