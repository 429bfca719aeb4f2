// Swin window attention, forward (K7): per window and head,
//   out = softmax((q·scale)·kᵀ + pe + mask)·v,
// q/k/v/out (B, nW, T, N·hd) in the projections' packed layout, f32 or bf16; pe
// (1, N, T, T) and the optional constant shift mask (nW, T, T), each f32 or bf16 and
// added separately in f32; scale = hd^−½; out rounded once to the input type.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/swin_attention.py
// `_swin_attention_fwd` (`_fwd_kernel`): one grid program per image walks its windows
// in a fori loop and slices heads out of the packed lanes, the whole (T, T) score
// matrix in VMEM. Here a block owns one head, one window index and a run of images
// (swin_attention.cuh), reading the packed layout in place, with two kernels:
//  - bf16 windows whose tiles fit shared memory (every registered Swin's): the
//    register tiles (swin_attention.cuh, attention_mma.cuh). A warp owns 16 query
//    rows of the window-head: s = q·kᵀ in mma.sync accumulators over key tiles,
//    the logits s·scale + pe + mask in registers (pe and mask from the block's
//    staged tables for windows of up to 64 tokens), the softmax running over the
//    key tiles as K2's does (one tile for window 7 and 8), o += p·v with p split
//    into two bf16 planes in registers, out = o / Σe rounded once. The logits are
//    (q·kᵀ)·scale where the TPU kernel sums (q·scale)·k, and the softmax
//    normalises after the product: the same values up to f32 rounding.
//  - f32 operands, and bf16 windows above 208 tokens or whose wide heads
//    overflow shared memory: the CUDA cores, a warp a query row with its score row in
//    registers (swin_attention.cuh), the TPU kernel's f32 arithmetic in its order.
// No (T, T) matrix goes to device memory.
//
// What bounds it: at swin_t stage 1, batch 128 (24,576 window-head pairs of 49 × 49 ×
// 32, bf16) q, k, v and out are 308 MB, 0.092 ms at 3.35 TB/s; its 7.6 GFLOP of
// products take 0.008 ms at the tensor cores' 989 TFLOP/s. The register tiles
// issue 3 product units of 64 × 64 × 32 a window-head (q·kᵀ, and p·v on p's two
// planes): 19 GFLOP.
#include "swin_attention.cuh"

using namespace vtt_swin;
using vtt_mma::kLog2e;
using vtt_mma::kNegInf;

namespace {

// Forward on the register tiles; warp r owns query rows 16r..16r + 15 of each
// window-head of the block's run.
template <int HD, bool SMALL>
__global__ void __launch_bounds__(rt_threads<SMALL>(), (rt_min_blocks<SMALL, HD, false>()))
swin_fwd_rt_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const void* __restrict__ pe, int pe_bf16,
                   const void* __restrict__ mask, int mask_bf16, bf16* __restrict__ out, int B,
                   int nW, int T_, int D, int hd, int Hp, int per_block, int runs, int vec,
                   float scale) {
  constexpr int FBK = SMALL ? BK : 32;  // the key tile: Large windows' keeps 78 registers
  extern __shared__ __align__(128) unsigned char smem[];
  const RtSmem L(T_, Hp, SMALL, pe_bf16, mask != nullptr, mask_bf16, false);
  const int tid = threadIdx.x, nt = blockDim.x, r = tid >> 5;
  const int t = vtt_mma::lane_t(), g = vtt_mma::lane_g();
  const BlockJob job(D / hd, runs);
  const int h = job.h, w = job.w, run = job.run;
  const int b0 = run * per_block, n = min(B, b0 + per_block) - b0;
  const int nkh = Hp / 16;
  auto op = [&](int s, int i) { return reinterpret_cast<bf16*>(smem + (3 * s + i) * L.tile); };
  auto load = [&](int it) {  // window w of image b0 + it: q, k, v into its ring stage
    const size_t base = window_head(b0 + it, w, h, nW, T_, D, hd);
    const bf16* src[3] = {q + base, k + base, v + base};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      vtt_mma::load_tile<bf16, 1>(op(it % FWD_STAGES, i), L.ldh, 0, src[i], D, 0, L.tp, T_, hd,
                                  Hp, vec, tid, nt);
    }
  };
#pragma unroll
  for (int it = 0; it < FWD_STAGES - 1; ++it) {  // the ring's first tiles, each its own group
    if (it < n) load(it);
    vtt_mma::cp_async_commit();
  }

  const size_t plane = static_cast<size_t>(T_) * T_;
  const void* pe_h = static_cast<const char*>(pe) + h * plane * (pe_bf16 ? 2 : 4);
  const void* mask_w =
      mask == nullptr ? nullptr : static_cast<const char*>(mask) + w * plane * (mask_bf16 ? 2 : 4);
  Table pe_t{pe_h, pe_bf16, T_}, mask_t{mask_w, mask_bf16, T_};
  if constexpr (SMALL) {  // once a block; the first ring step's barrier publishes them
    pe_t = stage_table(pe_h, pe_bf16, T_, smem + L.pe);
    if (mask_w != nullptr) mask_t = stage_table(mask_w, mask_bf16, T_, smem + L.mask);
  }
  const int row0 = 16 * r + g;  // this thread's rows: row0 and row0 + 8

  for (int it = 0; it < n; ++it) {
    vtt_mma::ring_step<FWD_STAGES>(it, n, load);
    const int st = it % FWD_STAGES;
    const bf16 *qs = op(st, 0), *ks = op(st, 1), *vs = op(st, 2);
    float o[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // rows g, g + 8 (l: this thread's part)

    for (int k0 = 0; k0 < T_; k0 += FBK) {
      const int nkg = groups16(k0, FBK, T_);
      float s[FBK / 8][4];
#pragma unroll
      for (int j = 0; j < FBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      vtt_mma::scores_t<1, FBK, HD>(s, qs, ks + k0 * L.ldh, 0, 0, L.ldh, r, nkh, nkg);
      logits<SMALL>(s, k0, row0, T_, scale, pe_t, mask_t, mask_w != nullptr);

      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < FBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
      float alpha[2], mb[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], vtt_mma::quad_max(mx[hh]));
        alpha[hh] = vtt_mma::exp2_approx((m[hh] - m_new) * kLog2e);
        m[hh] = m_new;
        mb[hh] = m_new * kLog2e;
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int j = 0; j < FBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = vtt_mma::exp2_approx(fmaf(s[j][e], kLog2e, -mb[e >> 1]));
          s[j][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // o += p·v, p's two planes from registers
      vtt_mma::grad_step<2, 1, FBK, HD>(o, s, vs + k0 * L.ldh, 0, L.ldh, 0, Hp, nkg);
    }

    bf16* dst = out + window_head(b0 + it, w, h, nW, T_, D, hd);
    const float lt[2] = {vtt_mma::quad_sum(l[0]), vtt_mma::quad_sum(l[1])};
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (j * 8 >= Hp) break;
      const float val[4] = {o[j][0] / lt[0], o[j][1] / lt[0], o[j][2] / lt[1], o[j][3] / lt[1]};
      vtt_mma::store_acc<bf16>(dst, D, row0, T_, j * 8 + 2 * t, hd, val);
    }
    if constexpr (FWD_STAGES == 1) __syncthreads();  // the one stage is refilled next
  }
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(NT)
swin_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const void* __restrict__ pe, int pe_bf16, const void* __restrict__ mask,
                int mask_bf16, T* __restrict__ out, int B, int nW, int T_, int D, int hd,
                int per_block, int runs, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, w = blockIdx.x / runs, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pitch = stage_pitch<T>(hd);
  const size_t op_bytes = staged_bytes<T>(1, T_, hd);
  float* prow = reinterpret_cast<float*>(smem) + warp * warp_row_floats(1, 1, T_, hd);
  float* qrow = prow + pad4(T_);  // the row's probabilities, then its q·scale
  T* sq = reinterpret_cast<T*>(smem + warp_rows_bytes(1, 1, T_, hd));
  T* sk = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sq) + op_bytes);
  T* sv = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sq) + 2 * op_bytes);
  const size_t pe_base = static_cast<size_t>(h) * T_ * T_;
  const size_t mask_base = static_cast<size_t>(w) * T_ * T_;
  const int b0 = blockIdx.x % runs * per_block, b1 = min(B, b0 + per_block);

  for (int b = b0; b < b1; ++b) {
    const size_t base = window_head(b, w, h, nW, T_, D, hd);
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

template <int HD, bool SMALL>
cudaError_t launch_rt_width(const void* q, const void* k, const void* v, const void* pe,
                            int pe_bf16, const void* mask, int mask_bf16, void* out, int B, int nW,
                            int T_, int N, int hd, int per_block, int runs, int vec, float scale,
                            cudaStream_t st) {
  const int Hp = vtt_mma::round_up(hd, 16);
  const RtSmem L(T_, Hp, SMALL, pe_bf16, mask != nullptr, mask_bf16, false);
  return rt_launch(swin_fwd_rt_kernel<HD, SMALL>, nW * runs, N, L.tp / 16, L.total, st,
                   static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), pe, pe_bf16, mask, mask_bf16,
                   static_cast<bf16*>(out), B, nW, T_, N * hd, hd, Hp, per_block, runs, vec,
                   scale);
}

template <bool SMALL>
cudaError_t launch_rt(const void* q, const void* k, const void* v, const void* pe, int pe_bf16,
                      const void* mask, int mask_bf16, void* out, int B, int nW, int T_, int N,
                      int hd, int per_block, int runs, int vec, float scale, cudaStream_t st) {
  const int Hp = vtt_mma::round_up(hd, 16);
  auto fn = Hp <= 32   ? launch_rt_width<32, SMALL>
            : Hp <= 64 ? launch_rt_width<64, SMALL>
                       : launch_rt_width<128, SMALL>;
  return fn(q, k, v, pe, pe_bf16, mask, mask_bf16, out, B, nW, T_, N, hd, per_block, runs, vec,
            scale, st);
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* pe, int pe_bf16,
                        const void* mask, int mask_bf16, void* out, int B, int nW, int T_, int N,
                        int hd, int per_block, int runs, float scale, cudaStream_t st) {
  const size_t rows = warp_rows_bytes(1, 1, T_, hd), ops = staged_bytes<T>(3, T_, hd);
  const bool staged = rows + ops <= kMaxSmem;
  const size_t dyn = rows + (staged ? ops : 0);
  auto kernel = staged ? swin_fwd_kernel<T, true> : swin_fwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nW * runs, N), NT, dyn, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pe, pe_bf16,
      mask, mask_bf16, static_cast<T*>(out), B, nW, T_, N * hd, hd, per_block, runs, scale);
  return cudaGetLastError();
}

}  // namespace

// The kernels (`Route`) that vtt_swin_attention_fwd (bwd = 0) or vtt_swin_attention_bwd
// (bwd = 1) runs for these operands' types; masked: a mask is given.
extern "C" int vtt_swin_attention_route(int T, int hd, int is_bf16, int pe_bf16, int masked,
                                        int mask_bf16, int bwd) {
  return swin_route(T, hd, is_bf16, pe_bf16, masked != 0, mask_bf16, bwd != 0);
}

// q, k, v, out (B, nW, T, N·hd), f32 or bf16 (is_bf16); pe (1, N, T, T); mask (nW, T, T) or
// null; a block takes window w of `per_block` consecutive images for one head
// (ops/swin_attention.py `windows_per_block`).
extern "C" int vtt_swin_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* pe, int pe_bf16, const void* mask,
                                      int mask_bf16, int is_bf16, void* out, int B, int nW,
                                      int T, int N, int hd, int per_block, float scale,
                                      void* stream) {
  if (B < 1 || nW < 1 || T < 1 || T > MAX_SEQ || N < 1 || N > 65535 || hd < 1 ||
      hd > MAX_HEAD || per_block < 1 || static_cast<long long>(B) * nW > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int runs = (B + per_block - 1) / per_block;
  if (static_cast<long long>(nW) * runs > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Route route = swin_route(T, hd, is_bf16, pe_bf16, mask != nullptr, mask_bf16, false);
  cudaError_t err;
  if (route != ROUTE_CORES) {
    // cp.async takes 16-byte rows: heads a multiple of 8, 16-byte-aligned operands
    int vec = hd % 8 == 0 && (N * hd) % 8 == 0;
    for (const void* p : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    auto fn = route == ROUTE_SMALL ? launch_rt<true> : launch_rt<false>;
    err = fn(q, k, v, pe, pe_bf16, mask, mask_bf16, out, B, nW, T, N, hd, per_block, runs, vec,
             scale, st);
  } else {
    auto fn = is_bf16 ? launch_simt<bf16> : launch_simt<float>;
    err = fn(q, k, v, pe, pe_bf16, mask, mask_bf16, out, B, nW, T, N, hd, per_block, runs, scale,
             st);
  }
  return static_cast<int>(err);
}
