// CaiT talking-head attention, forward (K5):
//   raw_h  = (q_h·scale)·k_hᵀ                       per head h, f32
//   mixl_g = mlb_g + Σ_h ml[g][h]·raw_h              pre-softmax head mix
//   p_g    = softmax_s(mixl_g)
//   pw_g   = mwb_g + Σ_h mw[g][h]·p_h                post-softmax head mix
//   o_g    = pw_g·v_g
// q/k/v/o are (B, T|S, H·hd) in the projections' packed layout, f32 or bf16;
// the mixes f32.
//
// Replaces the TPU kernel vision_toolbox_tpu/ops/cait_attention.py `_th_fwd`
// (`_fwd_kernel`), which runs one image per grid program with all heads'
// (T, S) f32 score matrices in VMEM (8·196²·4 B = 1.23 MB at cait_s_24), far
// above a Hopper block's 227 KB. Here a block owns BQ query rows of one
// image for all heads (the mixes join the heads at each (t, s), and the
// softmax is over whole rows), so its scores are H·BQ·S f32 (50 KB at
// cait_s_24 with BQ = 8; talking_head.cuh picks BQ: down to one row at
// S = 512, 16 heads). Keys and values are read from device memory (L2) by
// every row tile of their image. Any head width: the wrapper pads it to a
// multiple of 16 and the logits run in 64-, 48- or 16-column chunks
// (talking_head.cuh).
//
// Every value the TPU kernel holds in f32 is f32 here, and every product
// runs on the CUDA cores in f32: the probabilities and the mixed
// probabilities are f32 operands of o = pw·v, which bf16 tensor cores would
// round. What bounds it on an H100: q/k/v/o (4·B·T·D elements) set the
// least time (bytes); the two mixes, 4·B·H²·T·S f32 operations, come close
// to it on the CUDA cores, and the per-head products (4·B·T·S·D) run there
// too in this first version, so it is bound by f32 issue rate, far above
// the bytes. Tensor-core products for the bf16 operands are the next step.
#include "talking_head.cuh"

using namespace vtt_th;

namespace {

// Three blocks an SM for chunks up to 48 columns (at most 85 registers a
// thread: cait_s_24's 8 heads of 48 otherwise take 99 and two blocks, 1.25×
// slower), two for 64-column chunks, whose key rows alone take 64 registers.
template <int CH, int MH>
__global__ void __launch_bounds__(NT, CH <= 48 ? 3 : 2)
th_fwd_kernel(const void* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
              int in_bf16, const float* __restrict__ mix, void* __restrict__ out, int T, int S,
              int H, int HD, int BQ, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int D = H * HD, SP = pad4(S), plane = BQ * SP;
  float* sc = smem;                      // H·BQ·SP scores
  float* qs = sc + H * plane;            // BQ·H·CH, a chunk of q·scale
  float* mx = qs + BQ * H * CH;          // ml (H²), mlb (H), mw (H²), mwb (H)
  const float *ml = mx, *mlb = mx + H * H, *mw = mlb + H, *mwb = mw + H * H;
  const int t0 = blockIdx.x * BQ, b = blockIdx.y;

  for (int i = threadIdx.x; i < 2 * H * H + 2 * H; i += NT) mx[i] = mix[i];
  chunked_dots<CH>(q, scale, k, in_bf16, static_cast<size_t>(b) * T * D,
                   static_cast<size_t>(b) * S * D, t0, T, S, SP, D, HD, H, BQ, qs, sc);
  mix_heads<MH, false>(sc, sc, ml, mlb, H, BQ, S, SP, nullptr, 0, T);
  __syncthreads();
  softmax_rows(sc, H * BQ, S, SP);
  __syncthreads();
  mix_heads<MH, false>(sc, sc, mw, mwb, H, BQ, S, SP, nullptr, 0, T);
  __syncthreads();
  scores_times_rows(sc, v, in_bf16, static_cast<size_t>(b) * S * D, out,
                    static_cast<size_t>(b) * T * D, t0, T, S, SP, D, HD, BQ, 1.0f);
}

template <int CH, int MH>
cudaError_t launch(const void* q, const void* k, const void* v, int in_bf16, const float* mix,
                   void* out, int B, int T, int S, int H, int HD, float scale, cudaStream_t st) {
  const int bq = rows_per_block(false, S, H, CH);
  if (bq == 0) return cudaErrorInvalidValue;
  const size_t smem = row_tile_smem(false, bq, S, H, CH);
  cudaError_t err = cudaFuncSetAttribute(th_fwd_kernel<CH, MH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + bq - 1) / bq, B);
  th_fwd_kernel<CH, MH><<<grid, NT, smem, st>>>(q, k, v, in_bf16, mix, out, T, S, H, HD, bq,
                                                scale);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_heads(const void* q, const void* k, const void* v, int in_bf16,
                         const float* mix, void* out, int B, int T, int S, int H, int HD,
                         float scale, cudaStream_t st) {
  if (H <= 4) return launch<CH, 4>(q, k, v, in_bf16, mix, out, B, T, S, H, HD, scale, st);
  if (H <= 8) return launch<CH, 8>(q, k, v, in_bf16, mix, out, B, T, S, H, HD, scale, st);
  return launch<CH, 16>(q, k, v, in_bf16, mix, out, B, T, S, H, HD, scale, st);
}

}  // namespace

// Query rows per block of the forward (bwd = 0) or backward (bwd = 1) row
// pass; 0 when the shape has no kernel. hd is the padded head width, a
// multiple of 16.
extern "C" int vtt_talking_head_rows(int S, int H, int hd, int bwd) {
  if (S < 1 || S > MAX_SEQ || H < 1 || H > MAX_HEADS || hd < 16 || hd % 16) return 0;
  return rows_per_block(bwd != 0, S, H, head_chunk(hd));
}

// mix: ml (H²), mlb (H), mw (H²), mwb (H), f32, contiguous.
extern "C" int vtt_talking_head_fwd(const void* q, const void* k, const void* v, int in_bf16,
                                    const float* mix, void* out, int B, int T, int S, int H,
                                    int hd, float scale, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || T > MAX_SEQ || vtt_talking_head_rows(S, H, hd, 1) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (head_chunk(hd)) {
#define VTT_TH_CHUNK(C) \
  case C:               \
    err = launch_heads<C>(q, k, v, in_bf16, mix, out, B, T, S, H, hd, scale, st); \
    break;
    VTT_TH_CHUNK(64) VTT_TH_CHUNK(48) VTT_TH_CHUNK(16)
#undef VTT_TH_CHUNK
  }
  return static_cast<int>(err);
}
