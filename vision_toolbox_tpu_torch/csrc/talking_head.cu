// CaiT talking-head attention, forward (K5):
//   raw_h  = (q_h·k_hᵀ)·scale                       per head h, f32
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
// above a Hopper block's 227 KB.
//
// What bounds it on an H100: at cait_s_24 b128 (T = S = 196, 8 heads of
// 48, bf16) q/k/v/o are 77 MB (0.023 ms at 3.35 TB/s); the two per-head
// products are 7.6 GFLOP (0.008 ms on the tensor cores) and the two head
// mixes 4·B·H²·T·S = 2.0 GFLOP of f32 fused multiply-adds on the CUDA cores
// (0.030 ms at 67 TFLOP/s), which the softmax's two sweeps make three:
// the f32 lane work, not the products, sets the pace. It ran 0.348 ms
// there against the first design's 0.958 (NVIDIA H100 80GB HBM3, 700 W,
// scripts/ab_talking_head.py); talking_head.cuh says what holds it back.
//
// Design (talking_head.cuh): a block owns R 16-row query tiles of one image
// (two at cait_s_24 b128: eight warps, each of 2 of the 8 heads of one
// tile; one at b8, whose grid would not fill the card twice); K and V
// tiles of 16 keys stream through a cp.async ring. Two sweeps over
// the keys, three phases a tile:
//   sweep 1: A. raw_h for the warp's heads on the tensor cores, to the
//            exchange planes; B. per position, mixl for every head and the
//            running max and Σe of each (row, head) in the thread's
//            registers (the 8, 4 or 16 threads of a row merge them at the
//            end);
//   sweep 2: A. raw_h again; B. mixl, p_h = e^(mixl − m)/Σe, pw for every
//            head, in place; C. o_g += pw_g·v_g, pw read back in the
//            accumulator layout and split into bf16 planes in registers.
// The softmax's Σe is taken under a running max over the key tiles, not
// over the whole row at once, and p = e·(1/Σe) (each an f32 rounding apart
// from the TPU kernel's e/Σe).
#include "talking_head.cuh"

using namespace vtt_th;

namespace {

struct FwdLayout {
  int pitch;
  size_t stats, x, qres, kpart, qpart, stage, total;
  __host__ __device__ FwdLayout(int H, int HC, int MH, int IN, int R, int stages, int nc) {
    pitch = H * HC + 8;
    stats = align128(static_cast<size_t>(2) * MH * R * 16 * 4);
    x = align128(static_cast<size_t>(MH) * R * 16 * XP * 4);
    qres = nc == 1 ? part_bytes(IN, R * 16, pitch) : 0;
    kpart = part_bytes(IN, KT, pitch);
    qpart = nc == 1 ? 0 : part_bytes(IN, R * 16, pitch);
    stage = 2 * kpart + qpart;  // K, V (the output chunk), q's chunk when the head has several
    total = align128((4 * MH * MH + 2 * MH) * 4) + stats + x + qres + stages * stage;
  }
};

// Heads per warp, warps per row tile, positions per thread in phase B.
template <int MH>
struct FwdShape {
  static constexpr int G = heads_per_warp<MH>(), W = MH / G, PPT = 8 / W, LPR = KT / PPT;
};

template <typename T, int MH, int HC>
__global__ void __launch_bounds__(block_warps(FWD_WARPS, FwdShape<MH>::W) * 32,
                                  sm_blocks(FWD_BLOCKS, FwdShape<MH>::W))
th_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ mixp, T* __restrict__ out, int Tq, int S, int H, int hdp,
              int nc, int R, int row_blocks, int stages, float scale) {
  constexpr int IN = kInPlanes<T>;
  using Sh = FwdShape<MH>;
  constexpr int G = Sh::G, W = Sh::W, PPT = Sh::PPT, LPR = Sh::LPR;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L(H, HC, MH, IN, R, stages, nc);
  const int nt = blockDim.x, tid = threadIdx.x, wi = tid >> 5, r = wi / W, w = wi % W;
  const int b = blockIdx.x / row_blocks, q0 = blockIdx.x % row_blocks * R * 16;
  const int D = H * hdp, zc = blockIdx.y * HC, zw = min(HC, hdp - zc);
  const int rows16 = R * 16, xplane = rows16 * XP, kplane = KT * L.pitch,
            qplane = rows16 * L.pitch;
  const Mix<MH> M(reinterpret_cast<float*>(smem));
  unsigned char* p = smem + Mix<MH>::kBytes;
  float* mstat = reinterpret_cast<float*>(p);  // the rows' max [MH][rows16], then 1/Σe
  float* X = reinterpret_cast<float*>(p += L.stats);
  bf16* qres = reinterpret_cast<bf16*>(p += L.x);
  unsigned char* ring = p + L.qres;
  const T* qb = q + static_cast<size_t>(b) * Tq * D;
  const T* kb = k + static_cast<size_t>(b) * S * D;
  const T* vb = v + static_cast<size_t>(b) * S * D;
  const int nkt = (S + KT - 1) / KT, per_sweep = nkt * nc, items = 2 * per_sweep;
  auto stage = [&](int it) { return ring + (stages == 1 ? 0 : it % 2) * L.stage; };
  const Pieces P(H, HC, tid, nt);
  auto load = [&](int it) {  // K's chunk, q's chunk (several chunks), V at the last chunk
    int kt, c;
    tile_chunk(it < per_sweep ? it : it - per_sweep, nc, kt, c);
    const int c0 = c * HC, cw = min(HC, hdp - c0);
    bf16* s = reinterpret_cast<bf16*>(stage(it));
    load_chunk<T, IN, HC>(s, L.pitch, kplane, kb, D, kt * KT, KT, S, hdp, c0, cw, P);
    if (nc > 1) {
      load_chunk<T, IN, HC>(reinterpret_cast<bf16*>(stage(it) + 2 * L.kpart), L.pitch, qplane,
                            qb, D, q0, rows16, Tq, hdp, c0, cw, P);
    }
    if (it >= per_sweep && c == nc - 1) {
      load_chunk<T, IN, HC>(reinterpret_cast<bf16*>(stage(it) + L.kpart), L.pitch, kplane, vb, D,
                            kt * KT, KT, S, hdp, zc, zw, P);
    }
  };

  M.load(mixp, H, tid, nt);
  zero_padded<MH>(X, xplane, H, tid, nt);
  if (nc == 1) load_chunk<T, IN, HC>(qres, L.pitch, qplane, qb, D, q0, rows16, Tq, hdp, 0, hdp, P);
  if (stages == 2) load(0);
  cp_async_commit();

  const bool active = q0 + r * 16 < Tq;  // the warp's row tile holds a query row
  const int prow = tid / LPR, pc = tid % LPR * PPT;  // phase B: the thread's row and keys
  float acc[G][2][4];
  const Lanes lanes(L.pitch);
  // The ring's head and phase A for item `it`: the warp's heads' logits
  // over this chunk of the head; at a key tile's last chunk they go to the
  // exchange planes (true, after a barrier).
  auto step = [&](int it) {
    ring_head(it, items, stages, load);
    int kt, c;
    tile_chunk(it < per_sweep ? it : it - per_sweep, nc, kt, c);
    const bf16* ks = reinterpret_cast<const bf16*>(stage(it));
    const bf16* qs = nc == 1 ? qres : reinterpret_cast<const bf16*>(stage(it) + 2 * L.kpart);
    if (c == 0) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi][n][e] = 0.0f;
        }
      }
    }
    if (active) {
      const int nkh = min(HC, hdp - c * HC) / 16;
      const uint32_t q0a = smem_addr(qs) + 2 * r * 16 * L.pitch + lanes.a;
      const uint32_t k0a = smem_addr(ks) + lanes.b;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int h = w * G + gi;
        if (h < H) logits16<IN, HC>(acc[gi], q0a + 2 * h * HC, k0a + 2 * h * HC, 2 * qplane,
                                    2 * kplane, nkh);
      }
    }
    if (c < nc - 1) {
      if (stages == 1) __syncthreads();  // the one stage is refilled next
      return false;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int h = w * G + gi;
      if (h < H) put_tile(X + h * xplane, r * 16, acc[gi], scale);
    }
    __syncthreads();
    return true;
  };

  // sweep 1: per (row, head) the running max and Σe of mixl, in the
  // thread's registers, merged over the LPR threads of a row at the end
  {
    float m[MH], l[MH];
#pragma unroll
    for (int g = 0; g < MH; ++g) m[g] = kNegInf, l[g] = 0.0f;
    for (int it = 0; it < per_sweep; ++it) {
      if (!step(it)) continue;
      int kt, c;
      tile_chunk(it, nc, kt, c);
      const int key0 = kt * KT + pc;
      float x[PPT][MH], ml[PPT][MH];
      gather<MH, PPT>(X, xplane, prow, pc, x);
      mix<MH, PPT>(M.mlT, M.mlb, x, ml);
#pragma unroll
      for (int g = 0; g < MH; ++g) {
        float tmax = kNegInf;
#pragma unroll
        for (int jj = 0; jj < PPT; ++jj) {
          if (key0 + jj < S) tmax = fmaxf(tmax, ml[jj][g]);
        }
        const float mn = fmaxf(m[g], tmax);
        float sum = 0.0f;
#pragma unroll
        for (int jj = 0; jj < PPT; ++jj) {
          if (key0 + jj < S) sum += softmax_e(ml[jj][g], mn);
        }
        l[g] = fmaf(l[g], softmax_e(m[g], mn), sum);
        m[g] = mn;
      }
      if (stages == 1) __syncthreads();
    }
#pragma unroll
    for (int g = 0; g < MH; ++g) {
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mn = fmaxf(m[g], mo);
        l[g] = l[g] * softmax_e(m[g], mn) + lo * softmax_e(mo, mn);
        m[g] = mn;
      }
      if (tid % LPR == 0) {  // seen by all after the next step's barrier
        mstat[g * rows16 + prow] = m[g];
        mstat[(MH + g) * rows16 + prow] = 1.0f / l[g];
      }
    }
  }

  // sweep 2: p and pw per position (B), o_g += pw_g·v_g per head (C)
  float o[G][HC / 8][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) o[gi][j][0] = o[gi][j][1] = o[gi][j][2] = o[gi][j][3] = 0.0f;
  }
  for (int it = per_sweep; it < items; ++it) {
    if (!step(it)) continue;
    {
      int kt, c;
      tile_chunk(it - per_sweep, nc, kt, c);
      const int key0 = kt * KT + pc;
      float x[PPT][MH], ml[PPT][MH];
      gather<MH, PPT>(X, xplane, prow, pc, x);
      mix<MH, PPT>(M.mlT, M.mlb, x, ml);
      // p in place of mixl, then pw to the planes in place of raw
#pragma unroll
      for (int h = 0; h < MH; ++h) {
        const float mm = mstat[h * rows16 + prow], il = mstat[(MH + h) * rows16 + prow];
#pragma unroll
        for (int jj = 0; jj < PPT; ++jj) {
          ml[jj][h] = key0 + jj < S ? softmax_e(ml[jj][h], mm) * il : 0.0f;
        }
      }
      mix<MH, PPT>(M.mwT, M.mwb, ml, x);
      scatter<MH, PPT>(X, xplane, prow, pc, x);
    }
    __syncthreads();
    if (active) {
      const bf16* vs = reinterpret_cast<const bf16*>(stage(it) + L.kpart);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int g = w * G + gi;
        if (g >= H) continue;
        float pt[2][4];
        get_tile(X + g * xplane, r * 16, pt);
        tile_product<MID, IN, HC>(o[gi], pt, smem_addr(vs) + 2 * g * HC + lanes.a, 2 * kplane,
                                  zw);
      }
    }
    if (stages == 1) __syncthreads();  // the one stage is refilled next
  }
  if (!active) return;

  const int row0 = q0 + r * 16 + lane_g();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int g = w * G + gi;
    if (g >= H) continue;
    T* dst = out + static_cast<size_t>(b) * Tq * D + g * hdp + zc;
#pragma unroll
    for (int jj = 0; jj < HC / 8; ++jj) {
      if (jj * 8 >= zw) break;
      store_acc<T>(dst, D, row0, Tq, jj * 8 + 2 * lane_t(), zw, o[gi][jj]);
    }
  }
}

template <typename T, int MH, int HC>
Geometry fwd_geometry(int B, int T_, int H, int hdp) {
  const int nc = (hdp + HC - 1) / HC;
  constexpr int W = FwdShape<MH>::W;
  return pick_geometry(B, T_, W, block_warps(FWD_WARPS, W), sm_blocks(FWD_BLOCKS, W),
                       [&](int R, int st) {
                         return FwdLayout(H, HC, MH, kInPlanes<T>, R, st, nc).total;
                       });
}

template <typename T, int MH, int HC>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mix, void* out, int B,
                   int T_, int S, int H, int hdp, float scale, cudaStream_t st) {
  const Geometry g = fwd_geometry<T, MH, HC>(B, T_, H, hdp);
  if (g.R == 0) return cudaErrorInvalidValue;
  const int nc = (hdp + HC - 1) / HC;
  auto kernel = th_fwd_kernel<T, MH, HC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * g.blocks, nc);
  kernel<<<grid, g.R * FwdShape<MH>::W * 32, g.smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mix,
      static_cast<T*>(out), T_, S, H, hdp, nc, g.R, g.blocks, g.stages, scale);
  return cudaGetLastError();
}

template <typename T, int HC>
cudaError_t launch_heads(const void* q, const void* k, const void* v, const float* mix, void* out,
                         int B, int T_, int S, int H, int hdp, float scale, cudaStream_t st) {
  if (H <= 4) return launch<T, 4, HC>(q, k, v, mix, out, B, T_, S, H, hdp, scale, st);
  if (H <= 8) return launch<T, 8, HC>(q, k, v, mix, out, B, T_, S, H, hdp, scale, st);
  return launch<T, 16, HC>(q, k, v, mix, out, B, T_, S, H, hdp, scale, st);
}

template <typename T, int HC>
Geometry geometry_heads(int B, int T_, int H, int hdp) {
  if (H <= 4) return fwd_geometry<T, 4, HC>(B, T_, H, hdp);
  if (H <= 8) return fwd_geometry<T, 8, HC>(B, T_, H, hdp);
  return fwd_geometry<T, 16, HC>(B, T_, H, hdp);
}

}  // namespace

// The forward's launch for B images: out = {R (16-row tiles a block),
// blocks an image, ring stages, shared-memory bytes, head chunks
// (blockIdx.y), threads}.
extern "C" int vtt_talking_head_fwd_geometry(int B, int T, int H, int hd, int is_bf16,
                                             long long* out) {
  if (!admits(B, T, 1, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const int HC = chunk_width(hd, is_bf16 != 0);
  const Geometry g = !is_bf16 ? geometry_heads<float, 16>(B, T, H, hd)
                     : HC == 48 ? geometry_heads<bf16, 48>(B, T, H, hd)
                                : geometry_heads<bf16, 64>(B, T, H, hd);
  const int W = H <= 4 ? FwdShape<4>::W : H <= 8 ? FwdShape<8>::W : FwdShape<16>::W;
  const long long vals[6] = {g.R, g.blocks, g.stages, static_cast<long long>(g.smem),
                             (hd + HC - 1) / HC, g.R * W * 32};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return g.R == 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// mix: ml (H²), mlb (H), mw (H²), mwb (H), f32, contiguous.
extern "C" int vtt_talking_head_fwd(const void* q, const void* k, const void* v, int in_bf16,
                                    const float* mix, void* out, int B, int T, int S, int H,
                                    int hd, float scale, void* stream) {
  if (!admits(B, T, S, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_bf16) return static_cast<int>(launch_heads<float, 16>(q, k, v, mix, out, B, T, S, H, hd,
                                                                scale, st));
  const cudaError_t err =
      chunk_width(hd, true) == 48
          ? launch_heads<bf16, 48>(q, k, v, mix, out, B, T, S, H, hd, scale, st)
          : launch_heads<bf16, 64>(q, k, v, mix, out, B, T, S, H, hd, scale, st);
  return static_cast<int>(err);
}
