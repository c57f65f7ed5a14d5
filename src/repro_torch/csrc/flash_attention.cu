// Flash attention for Hopper (sm_90a): full-sequence attention over
// contiguous K/V with an online softmax.
//
// Replaces the Pallas TPU kernel in repro/kernels/flash_attention/kernel.py:
// flash_attention_tpu (body _flash_kernel) together with the block padding
// of its wrapper (ops.py), which this kernel does not need: it bounds the
// ragged Sq and Sk edges itself.  Query row i of head h sits at position
// qpos = kv_offset + i and sees key position kpos < Sk when
//
//     (not causal or kpos <= qpos)  and  (window == 0 or kpos > qpos - window).
//
// Query head h reads KV head h / (H / Kh) (GQA).  Scores are f32 whatever
// the input type, scaled by 1/sqrt(D) after the dot product as the TPU
// kernel does, masked with its finite NEG_INF, and reduced by an online
// softmax in f32 that divides by max(l, 1e-30).  A masked key adds exactly
// 0 to the running sum, so a row that sees at least one key gets what
// _flash_kernel gives it, and a row that sees none comes out 0, as the
// JAX oracle (flash_attention_ref) gives it.
//
// Layouts: q [B, H, Sq, D], k [B, Kh, Sk, D], v [B, Kh, Sk, DV], out [B,
// H, Sq, DV], addressed through the (batch, head, sequence) strides in
// elements the caller passes, the last dimension contiguous; so a [B, S, H,
// D] projection viewed as [B, H, S, D] is read and written in place.
// (D, DV) = (64, 64), (112, 112), (128, 128), (160, 160), (256, 256):
// every head dim of the repo's configs; and (192, 128), DeepSeek-V2's MLA
// in training (queries and keys 128 + 64 wide, values 128), scaled by
// 1/sqrt(D).
//
// The TPU grid walks (b, h, q block, kv block) with the kv block innermost
// and the softmax state carried in VMEM scratch across grid steps.  CUDA
// blocks run in no order, so a block owns (b, h, a tile of query rows) and
// loops over tiles of 64 keys.  Three bodies, chosen by the input type
// and the wrapper's plan:
//
// - bf16 at (D, DV) = (112, 112), (160, 160), (192, 128) and (256, 256),
//   when the grid needs no split (training's full-sequence calls): the
//   wgmma body (fwd::flash_fwd_wgmma_kernel, below the backward): 128-row
//   blocks of two consumer warpgroups on wgmma, K and V tiles streamed by
//   TMA through an mbarrier ring from a producer warp, P kept in
//   registers as the A operand of P V.
// - bf16 otherwise (D = 64 and 128, decode rows, split grids): the
//   tensor-core tile of attn_mma.cuh (mma.sync, bf16 K/V staged
//   by cp.async in a ring, online softmax in registers), blocks of one
//   warp of 16 rows or four warps of 16 rows, as the wrapper's plan says.  Short query tiles (decode rows,
//   whisper's prefill chunks) would leave most SMs idle with one block per
//   (b, h), so the plan splits the keys into n_split ranges of whole tiles
//   (split-KV): each block then writes f32 partials (m, l, acc) of its
//   range to scratch, and the last of a (b, h, query tile)'s split blocks
//   to finish combines them by log-sum-exp (partials with l = 0, ranges
//   that saw no key, weigh nothing) into out, in the same launch
//   (attn_merge.cuh's arrive_last; a one-warp tile then runs merge_rows,
//   a four-warp tile folds every split, in split order, into a state in
//   its lanes' registers; either way the bits do not depend on which
//   block merged).  The plan keeps every block in one wave.  Blocks are
//   ordered with the split slowest.
// - f32: CUDA-core products in f32, by design, not as a fallback: the
//   port's f32 model checks hold the card to the CPU within 2e-4 and the
//   f32 kernel checks to 1e-4, which TF32 or bf16 tensor-core products
//   would break.  128 threads stage K^T and V of a tile in shared memory
//   as f32, and each thread computes a TM x 4 patch of the scores and a
//   TM x D/16 patch of the output (16 threads share a row group: row max
//   and sum are half-warp shuffles).  TM shrinks from 8 towards 1 while the
//   grid would not fill the card once.
//
// All skip tiles wholly after the tile's last causal key or before its
// first window key.  Bound: operations for long sequences (4 * Sq * Sk * D
// per head on the tensor cores, and Sq * Sk exponentials), bytes for short
// query tiles (each K/V row is read once per query tile).
//
// Training: every body (and the split path's merge) can also write each
// row's log-sum-exp, and flash_attention_bwd computes the gradient from it
// (see "Backward" below).  The JAX package has no Pallas backward: it
// differentiates its jnp attention (repro/models/layers.py,
// blockwise_attention) with jax.value_and_grad.
#include "attn_mma.cuh"
#include "attn_merge.cuh"
#include "attn_wgmma.cuh"
#include "hopper.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

using attn::bf16;
using attn::NEG_INF;
using attn::Strides;

// A row's log-sum-exp from its softmax state (max m in natural units, sum
// l of exp(score - m)): +inf for a row that saw no key, so that exp(s -
// lse) is 0 in the backward.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : attn::inf_f32();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core tile, optionally over one split of the keys
// ---------------------------------------------------------------------------
struct FlashProb {
  const bf16 *q_base, *k_base, *v_base;   // this (b, h) / (b, kv head)
  int64_t qs, ks, vs;                     // sequence strides
  int q0, rows_valid, kv_limit, causal, window, kv_offset;
  __device__ const bf16* q_row(int r) const { return q_base + (q0 + r) * qs; }
  __device__ int qpos(int r) const { return kv_offset + q0 + r; }
  template <int N, int STEP>
  __device__ void kv_rows(int j, int (&row)[N]) const {
#pragma unroll
    for (int m = 0; m < N; ++m) row[m] = j + m * STEP < kv_limit ? j + m * STEP : -1;
  }
  __device__ int kv_row(int j) const { return j < kv_limit ? j : -1; }
  __device__ const bf16* k_at(int j) const { return k_base + j * ks; }
  __device__ const bf16* v_at(int j) const { return v_base + j * vs; }
};

// grid (n_qt * n_split, H, B), read in launch order as (split, b, h, query
// tile), split slowest; block 32 * NW, 16 rows per warp.  part_m ==
// nullptr: one range, out written; else split s covers key tiles
// [s * split_tiles, (s + 1) * split_tiles) and writes partials [n_split, B,
// H, Sq] (m in natural units, l) and [n_split, B, H, Sq, DV], and the last
// split block of the (b, h, query tile) merges the
// tile's rows into out, with the tile's counter in `counters`.
// A block whose range holds no key runs no tile and writes l = 0: it
// still counts in.
template <int D, int NW, int DV = D>
__global__ void __launch_bounds__(32 * NW, D == 128 ? 2 : 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, Strides qst,
                 Strides kst, Strides vst, Strides ost, int H, int Kh, int Sq, int Sk,
                 int causal, int window, int kv_offset, float scale_log2, int n_qt,
                 int split_tiles, float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, unsigned* __restrict__ counters,
                 float* __restrict__ lse) {
  constexpr int BK = attn::Cfg<D, DV>::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int rows = 16 * NW;
  // causal: the last query tiles see the most keys, so they start first
  // block (x, y, z) in launch order: split slowest, then b, h, query tile
  const int64_t lin =
      blockIdx.x + (int64_t)gridDim.x * (blockIdx.y + (int64_t)gridDim.y * blockIdx.z);
  const int64_t per = (int64_t)n_qt * H * gridDim.z;
  const int split = (int)(lin / per), rem = (int)(lin % per);
  const int qt = causal ? n_qt - 1 - rem % n_qt : rem % n_qt;
  const int h = rem / n_qt % H, b = rem / (n_qt * H), kh = h / (H / Kh), q0 = qt * rows;

  FlashProb P;
  P.q_base = q + b * qst.b + h * qst.h;
  P.k_base = k + b * kst.b + kh * kst.h;
  P.v_base = v + b * vst.b + kh * vst.h;
  P.qs = qst.s;
  P.ks = kst.s;
  P.vs = vst.s;
  P.q0 = q0;
  P.rows_valid = min(rows, Sq - q0);
  P.kv_limit = Sk;
  P.causal = causal;
  P.window = window;
  P.kv_offset = kv_offset;

  // key tiles any row of the tile can see, cut to this block's split
  const int q_lo = kv_offset + q0, q_hi = kv_offset + q0 + P.rows_valid - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  int kt_begin = k_begin / BK, kt_end = k_end > k_begin ? (k_end + BK - 1) / BK : kt_begin;
  if (part_m != nullptr) {
    kt_begin = max(kt_begin, split * split_tiles);
    kt_end = min(kt_end, (split + 1) * split_tiles);
  }

  attn::RowState<DV> st;
  attn::attend<D, NW, DV>(P, kt_begin, kt_end, scale_log2, st,
                          reinterpret_cast<bf16*>(smem_raw));

  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * 16;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + r0 + g + 8 * half;
    if (i >= Sq) continue;
    if (part_m == nullptr) {
      const float inv = 1.f / fmaxf(st.l[half], 1e-30f);
      if (lse != nullptr && tig == 0)
        lse[((int64_t)b * H + h) * Sq + i] = row_lse(st.m[half] * attn::LN2, st.l[half]);
      bf16* o = out + b * ost.b + h * ost.h + i * ost.s + 2 * tig;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) = __floats2bfloat162_rn(
            st.acc[n][2 * half] * inv, st.acc[n][2 * half + 1] * inv);
    } else {
      const int64_t row = (((int64_t)split * gridDim.z + b) * H + h) * Sq + i;
      if (tig == 0) {
        part_m[row] = st.l[half] > 0.f ? st.m[half] * attn::LN2 : NEG_INF;
        part_l[row] = st.l[half];
      }
      float* a = part_acc + row * DV + 2 * tig;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<float2*>(a + 8 * n) =
            make_float2(st.acc[n][2 * half], st.acc[n][2 * half + 1]);
    }
  }
  const int n_split = gridDim.x / n_qt;
  if (part_m == nullptr ||
      !attn::arrive_last(counters + ((int64_t)b * H + h) * n_qt + qt, n_split))
    return;
  const int64_t n_rows = (int64_t)gridDim.z * H * Sq, row0 = ((int64_t)b * H + h) * Sq + q0;
  if constexpr (NW == 1) {
    // a warp's tile (decode rows: few valid rows): one 4-column chunk a
    // thread, 4 splits' loads at a time
    attn::merge_rows<bf16, DV>(
        part_m, part_l, part_acc, n_rows, row0, P.rows_valid, n_split,
        [&](int r) { return out + b * ost.b + h * ost.h + (q0 + r) * ost.s; }, lse);
  } else {
    // 64 rows: one block pulling every chunk of them through merge_rows
    // pays a chain of round trips to L2 per thread.  Instead each lane
    // folds the splits' partials of the two rows and DV / 4 columns that
    // it holds in registers into a softmax state there, all of a split's
    // loads for both rows in flight at once, and writes out as an unsplit
    // block does.  Every split is folded from memory in split order, its
    // own too (it is in L2 already), from an empty state: the bits do not
    // depend on which split block arrived last.
    float M[2], L[2];
    int64_t row[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = min(q0 + r0 + g + 8 * half, Sq - 1);    // rows past Sq: not written
      row[half] = ((int64_t)b * H + h) * Sq + i;
      M[half] = NEG_INF;
      L[half] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.f;
    // both rows' loads at once up to DV = 128; above, one row's at a time
    // (DV / 4 more registers beside the DV / 2 of acc would spill)
    constexpr int AT_ONCE = DV <= 128 ? 2 : 1;
#pragma unroll 2
    for (int s = 0; s < n_split; ++s) {
#pragma unroll
      for (int h0 = 0; h0 < 2; h0 += AT_ONCE) {
        float ls[AT_ONCE], ms[AT_ONCE];
        float2 x[AT_ONCE][DV / 8];
#pragma unroll
        for (int j = 0; j < AT_ONCE; ++j) {
          const int64_t pr = s * n_rows + row[h0 + j];
          ls[j] = __ldcg(part_l + pr);
          ms[j] = __ldcg(part_m + pr);
          const float* a = part_acc + pr * DV + 2 * tig;
#pragma unroll
          for (int n = 0; n < DV / 8; ++n)
            x[j][n] = __ldcg(reinterpret_cast<const float2*>(a + 8 * n));
        }
#pragma unroll
        for (int j = 0; j < AT_ONCE; ++j) {
          const int half = h0 + j;
          const bool seen = ls[j] > 0.f;  // a split that saw no key weighs nothing
          const float Mn = seen ? fmaxf(M[half], ms[j]) : M[half];
          const float sc = expf(M[half] - Mn), w = seen ? expf(ms[j] - Mn) : 0.f;
          L[half] = fmaf(w, ls[j], L[half] * sc);
#pragma unroll
          for (int n = 0; n < DV / 8; ++n) {
            st.acc[n][2 * half] = fmaf(w, x[j][n].x, st.acc[n][2 * half] * sc);
            st.acc[n][2 * half + 1] = fmaf(w, x[j][n].y, st.acc[n][2 * half + 1] * sc);
          }
          M[half] = Mn;
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = q0 + r0 + g + 8 * half;
      if (i >= Sq) continue;
      const float inv = 1.f / fmaxf(L[half], 1e-30f);
      if (lse != nullptr && tig == 0) lse[row[half]] = row_lse(M[half], L[half]);
      bf16* o = out + b * ost.b + h * ost.h + i * ost.s + 2 * tig;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) = __floats2bfloat162_rn(
            st.acc[n][2 * half] * inv, st.acc[n][2 * half + 1] * inv);
    }
  }
}

// The shared-memory limit of the bf16 kernel raised to what its tile
// needs, once per process and instantiation.
template <int D, int NW, int DV>
cudaError_t tile_ready() {
  static const cudaError_t attr = attn::allow_smem(flash_mma_kernel<D, NW, DV>,
                                                   attn::Cfg<D, DV>::smem_bytes(16 * NW));
  return attr;
}

template <int D, int NW, int DV>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* out,
                        const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                        int causal, int window, int kv_offset, int n_split, float* pm,
                        float* pl, float* pacc, unsigned* counters, float* lse,
                        cudaStream_t stream) {
  using C = attn::Cfg<D, DV>;
  constexpr int rows = 16 * NW;
  if (const cudaError_t attr = tile_ready<D, NW, DV>()) return attr;
  const int n_qt = (Sq + rows - 1) / rows;
  const int tiles = (Sk + C::BK - 1) / C::BK;
  const int split_tiles = n_split > 1 ? (tiles + n_split - 1) / n_split : tiles;
  const dim3 grid(n_qt * n_split, H, B);
  flash_mma_kernel<D, NW, DV><<<grid, 32 * NW, C::smem_bytes(rows), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), st[0], st[1], st[2], st[3],
      H, Kh, Sq, Sk, causal, window, kv_offset, attn::LOG2E / sqrtf((float)D), n_qt,
      split_tiles, n_split > 1 ? pm : nullptr, pl, pacc, counters, lse);
  return cudaGetLastError();
}

// rows: 16 (one warp) or 64 (four warps)
template <int D, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                       int causal, int window, int kv_offset, int rows, int n_split,
                       float* pm, float* pl, float* pacc, unsigned* counters, float* lse,
                       cudaStream_t stream) {
  if (n_split < 1 ||
      (n_split > 1 && (pm == nullptr || pl == nullptr || pacc == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (rows == 16)
    return launch_tile<D, 1, DV>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
                                 kv_offset, n_split, pm, pl, pacc, counters, lse, stream);
  if (rows == 64)
    return launch_tile<D, 4, DV>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
                                 kv_offset, n_split, pm, pl, pacc, counters, lse, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core products
// ---------------------------------------------------------------------------
constexpr int THREADS = 128;   // 8 row groups x 16 column groups
constexpr int BK = 64;         // keys per K/V tile
constexpr int PAD = 4;         // keeps transposed rows 16-byte aligned

// N consecutive floats of shared memory into registers (N = 1, 2, 4, 8),
// as the widest aligned vector loads
template <int N>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + i);
      dst[i] = x.x; dst[i + 1] = x.y; dst[i + 2] = x.z; dst[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk, int causal,
                                        int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

template <int D, int DV, int TM>
constexpr size_t smem_bytes() {
  return (size_t)(D * (8 * TM + PAD) + D * (BK + PAD) + BK * DV +
                  8 * TM * (BK + PAD)) * sizeof(float);
}

template <int D, int DV, int TM>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, Strides qst,
             Strides kst, Strides vst, Strides ost, int H, int Kh, int Sq, int Sk,
             int causal, int window, int kv_offset, float scale,
             float* __restrict__ lse) {
  constexpr int BQ = 8 * TM;
  constexpr int BQP = BQ + PAD;
  constexpr int BKP = BK + PAD;
  constexpr int DC = DV / 16;         // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [D][BQP]  Q^T
  float* Ks = Qs + D * BQP;                      // [D][BKP]  K^T
  float* Vs = Ks + D * BKP;                      // [BK][DV]
  float* Ps = Vs + BK * DV;                      // [BQ][BKP] probabilities

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kh = h / (H / Kh);
  const float* qb = q + b * qst.b + h * qst.h;
  const float* kb = k + b * kst.b + kh * kst.h;
  const float* vb = v + b * vst.b + kh * vst.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[d * BQP + r] = q0 + r < Sq ? qb[(q0 + r) * qst.s + d] : 0.f;
  }

  float acc[TM][DC], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // keys any row of the tile can see
  const int q_lo = kv_offset + q0;
  const int q_hi = kv_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) / BK * BK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();           // Q staged / the previous tile's readers done
    if constexpr (DV == D) {
      for (int i = tid; i < BK * D; i += THREADS) {
        const int j = i / D, d = i % D;
        float kx = 0.f, vx = 0.f;  // keys past Sk: zero, so p * v stays finite
        if (k0 + j < Sk) {
          kx = kb[(k0 + j) * kst.s + d];
          vx = vb[(k0 + j) * vst.s + d];
        }
        Ks[d * BKP + j] = kx;
        Vs[j * D + d] = vx;
      }
    } else {
      for (int i = tid; i < BK * D; i += THREADS) {
        const int j = i / D, d = i % D;
        Ks[d * BKP + j] = k0 + j < Sk ? kb[(k0 + j) * kst.s + d] : 0.f;
      }
      for (int i = tid; i < BK * DV; i += THREADS) {
        const int j = i / DV, d = i % DV;
        Vs[j * DV + d] = k0 + j < Sk ? vb[(k0 + j) * vst.s + d] : 0.f;
      }
    }
    __syncthreads();

    float s[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 kk = *reinterpret_cast<const float4*>(Ks + d * BKP + tx * 4);
      float qq[TM];
      load_vec<TM>(Qs + d * BQP + ty * TM, qq);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        s[i][0] += qq[i] * kk.x;
        s[i][1] += qq[i] * kk.y;
        s[i][2] += qq[i] * kk.z;
        s[i][3] += qq[i] * kk.w;
      }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q_lo + ty * TM + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = visible(qpos, k0 + tx * 4 + c, Sk, causal, window)
                      ? s[i][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = visible(qpos, k0 + tx * 4 + c, Sk, causal, window)
                            ? expf(s[i][c] - m_new) : 0.f;
        s[i][c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(Ps + (ty * TM + i) * BKP + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float p[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) load_vec<4>(Ps + (ty * TM + i) * BKP + j, p[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
        load_vec<DC>(Vs + (j + jj) * DV + tx * DC, vv);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] += p[i][jj] * vv[c];
      }
    }
  }

  float* ob = out + b * ost.b + h * ost.h;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    if (r < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
      if (lse != nullptr && tx == 0) lse[((int64_t)b * H + h) * Sq + r] = row_lse(m[i], l[i]);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        ob[r * ost.s + tx * DC + c] = acc[i][c] / denom;
    }
  }
}

template <int D, int DV, int TM>
cudaError_t launch_tm(const void* q, const void* k, const void* v, void* out,
                      const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                      int causal, int window, int kv_offset, float* lse,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, DV, TM>();
  static const cudaError_t attr = attn::allow_smem(flash_kernel<D, DV, TM>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + 8 * TM - 1) / (8 * TM), H, B);
  flash_kernel<D, DV, TM><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), st[0], st[1], st[2], st[3],
      H, Kh, Sq, Sk, causal, window, kv_offset, 1.0f / sqrtf((float)D), lse);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                       int causal, int window, int kv_offset, float* lse,
                       cudaStream_t stream) {
  // the largest row tile whose grid still covers every SM once
  const int sms = attn::sm_count();
  int tm = 8;
  while (tm > 1 && (int64_t)B * H * ((Sq + 8 * tm - 1) / (8 * tm)) < sms) tm /= 2;
  switch (tm) {
    case 8: return launch_tm<D, DV, 8>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse, stream);
    case 4: return launch_tm<D, DV, 4>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse, stream);
    case 2: return launch_tm<D, DV, 2>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse, stream);
    default: return launch_tm<D, DV, 1>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse, stream);
  }
}

// ---------------------------------------------------------------------------
// Backward: dQ, dK, dV from q, k, v, out, dout and the forward's lse
// ---------------------------------------------------------------------------
//
// Replaces the gradient of flash_attention_tpu: the JAX package has no
// Pallas backward and differentiates its jnp attention with
// jax.value_and_grad.  P is recomputed from Q, K and each row's
// log-sum-exp (P = exp(S * scale - lse), exactly 0 where the mask hides the
// key or the row saw none), so nothing of size Sq x Sk is kept from the
// forward.  Bound: operations, the five products (S, dP, dV, dK, dQ; 10 *
// pairs * D FLOP) on the tensor cores at bf16.  Three launches on the
// caller's stream:
//   1. delta = rowsum(dO * O) in f32, one warp a row;
//   2. dK and dV: one block owns (b, KV head, 128 keys) and walks the G
//      query heads of that KV head and, for each, the tiles of 64 query
//      rows the mask lets see its keys, accumulating dV += P^T dO and dK +=
//      dS^T Q (dS = P * (dP - delta), dP = dO V^T) in registers; GQA's sum
//      over the G heads happens in the block;
//   3. dQ: one block owns (b, head, 128 query rows) and walks the key tiles
//      they see, accumulating dQ += dS K.
// S and dP are computed in both 2 and 3: seven products where dQ's adds
// from the dK/dV blocks would do five.  That keeps every block
// independent: each gradient element is one block's sum in a fixed order,
// with no atomic add and no wait on another block, so every call gives the
// same bits.
//
// bf16, sm_90a, D = 64, 112 or 128 (the narrow body; D = 112 runs the D =
// 128 body on tiles whose columns 112-127 TMA fills with zeros, its
// 7,168-byte rows at zamba2's [B, S, 32, 112] being whole multiples of 16
// bytes as TMA needs; only the first 112 columns are stored): each block is
// two consumer warpgroups of 64 own rows (keys or query rows) and a
// producer warpgroup.  The own rows
// (K and V; Q and dO) are loaded once; tiles of 64 rows of the other side
// (Q, dO and their lse and delta; K and V) stream through a ring of
// STAGES = 3 shared-memory stages filled by TMA from 4-D tensor maps over
// the tensors' own strides (rows past Sq / Sk read as zeros), completion
// counted on the stage's mbarrier, released by the 8 consumer warps.  One
// producer warp issues the copies; setmaxnreg gives the producer
// warpgroup's registers to the consumers (256 x 240 + 128 x 24 = 64,512).
// Each consumer computes S^T = K Q^T and dP^T = V dO^T (dK/dV; S and dP in
// dQ) on wgmma m64n64k16 with both operands K-major in shared memory (the
// 128-byte swizzle the maps write), forms P and dS in f32 (log2 units) and
// rounds them to bf16 A-fragments in registers, as the forward rounds P,
// then dV += P^T dO, dK += dS^T Q (dQ += dS K) on wgmma m64n{64,128}k16
// with A in registers and B the dO / Q (K) tile already in shared memory,
// read MN-major: no transposed copy.  dK/dV at D = 128 holds 64 + 64
// accumulator registers a thread beside S^T and dP^T (32 each).  A tile
// computes a mask only where it crosses the causal diagonal, the window's
// edge or the ragged end (tile_kind); a tile no pair of which is visible is
// skipped by the warpgroup it is empty for.  Causal grids launch their
// longest blocks first: dK/dV's key blocks from key 0, dQ's query blocks
// from the last row.  The mma.sync tiles this replaces (4 warps,
// cp.async, a mask on every score) took 2.660 ms at LLaVA-1.5-7B's
// training shape on an H100 80GB HBM3 at 700 W (dK/dV 1.395, dQ 1.180,
// delta 0.035); this design 0.91-0.94 ms (PERF.md, tools/kernel_ab.py
// --flash-bwd).  Above D = 128 the wide body (below) runs instead.
// f32: CUDA-core products in f32, as the forward's f32 body (the f32
// training checks hold the card to the CPU within 1e-4), at every (D, DV).

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

// delta [B, H, Sq] (contiguous) = rowsum(dout * out) in f32: 8 rows a block
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, Strides ost, Strides dost, int H, int Sq,
                       int D, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = (int)(row % Sq), h = (int)(row / Sq % H), b = (int)(row / ((int64_t)Sq * H));
  const T* o = out + b * ost.b + h * ost.h + i * ost.s;
  const T* d = dout + b * dost.b + h * dost.h + i * dost.s;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum = fmaf(to_f32(o[c]), to_f32(d[c]), sum);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) delta[row] = sum;
}

using wgattn::key_tiles;
using wgattn::sees;

// The query rows [lo, hi) that can see a key of [k0, k0 + n): none when
// hi <= lo.
__device__ __forceinline__ void query_range(int k0, int n, int Sq, int causal, int window,
                                            int kv_offset, int& lo, int& hi) {
  lo = causal ? max(0, k0 - kv_offset) : 0;
  hi = window > 0 ? min(Sq, k0 + n - 1 + window - kv_offset) : Sq;
}

namespace bwd {

using namespace hopper;
// a block's own rows (BLOCK = 2 BM): keys (dK/dV) or query rows (dQ); the
// rest as the forward body's (attn_wgmma.cuh)
using wgattn::BLOCK;
using wgattn::BM;
using wgattn::BN;
using wgattn::BOX;
using wgattn::CONSUMER_REGS;
using wgattn::CONSUMERS;
using wgattn::EDGE;
using wgattn::EMPTY;
using wgattn::FULL;
using wgattn::opaque;
using wgattn::PRODUCER_REGS;
using wgattn::SMEM_MAX;
using wgattn::smem;
using wgattn::THREADS;
using wgattn::tile_kind;
constexpr int STAGES = 3;

struct Params {
  const float* lse;                    // [B, H, Sq] f32, natural units
  const float* delta;                  // [B, H, Sq] f32
  bf16 *dq, *dk, *dv;
  Strides dqst, dkst, dvst;
  int B, H, Kh, Sq, Sk, causal, window, kv_offset;
  float scale, scale_log2;
  int chunk;                           // the wide body's heads a chunk of its grid (wide_block)
};

// The narrow body's padded width: D rounded up to whole 64-column chunks
// (D = 112 runs the D = 128 body, TMA filling columns 112-127 with zeros)
template <int D>
constexpr int PADDED = (D + 63) / 64 * 64;

template <int D>
struct alignas(1024) DkdvSmem {
  static constexpr int DC = PADDED<D> / 64;
  bf16 k[DC][BLOCK * 64];              // chunk c: [128 keys][64 columns], swizzled
  bf16 v[DC][BLOCK * 64];
  bf16 q[STAGES][DC][BN * 64];         // chunk c of a stage: [64 query rows][64]
  bf16 dout[STAGES][DC][BN * 64];
  float lse[STAGES][BN], delta[STAGES][BN];   // lse in log2 units
  uint64_t full[STAGES], empty[STAGES], kv_full;
};

template <int D>
struct alignas(1024) DqSmem {
  static constexpr int DC = PADDED<D> / 64;
  bf16 q[DC][BLOCK * 64];              // chunk c: [128 query rows][64 columns], swizzled
  bf16 dout[DC][BLOCK * 64];
  bf16 k[STAGES][DC][BN * 64];         // chunk c of a stage: [64 keys][64]
  bf16 v[STAGES][DC][BN * 64];
  uint64_t full[STAGES], empty[STAGES], qd_full;
};

// acc[64 x 64] = A B^T over D (a multiple of 16; columns past D may be
// padding): A's 64 rows at a (chunks a_chunk bytes apart), B's 64 rows at
// bm (chunks BOX apart), both K-major, swizzled; issued, not waited for
template <int D>
__device__ __forceinline__ void issue_abt(float* acc, uint32_t a, uint32_t a_chunk, uint32_t bm) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss<64, 0>(acc, desc(a + (kk / 4) * a_chunk + (kk % 4) * 32, 16, 1024),
                  desc(bm + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024), kk);
}

// acc[64 x D] += A B: A [64 x 64] as bf16 pairs in the accumulator layout
// (f[n][i]: row g + 8 i, columns 8 n + 2 t4 and + 1), B's 64 rows of D at bm
// (chunks BOX apart), read MN-major; issued, not waited for.  D = 64 or
// 128.
template <int D>
__device__ __forceinline__ void issue_ab(float* acc, const uint32_t (&f)[8][2], uint32_t bm) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {f[2 * kk][0], f[2 * kk][1], f[2 * kk + 1][0], f[2 * kk + 1][1]};
    const uint64_t db = desc(bm + kk * 16 * 128, BOX, 1024);
    if constexpr (D == 64)
      mma_rs_n64(acc, a, db);
    else
      mma_rs_n128(acc, a, db);
  }
}

// P of a lane's 2 x 2 NG entries of a tile of 8 NG columns, in place of
// the raw scores s (wgmma's accumulator layout: s[4 n + e] is row g + 8 (e
// >> 1) of the lane's warp, column 8 n + 2 t4 + (e & 1)): P = 2^(s
// scale_log2 - lse2), exactly 0 where vis says the pair is hidden (MASKED
// only); pf gets P as bf16 pairs in that layout, the A fragments of a
// product.  lse2(i, n, c): the log2-unit lse of entry (row g + 8 i, column
// 8 n + 2 t4 + c).  probs_to leaves s as it is and writes P to pr.
template <bool MASKED, int NG = 8, class Lse, class Vis>
__device__ __forceinline__ void probs_to(const float* s, float* pr, float scale_log2,
                                         const Lse& lse2, const Vis& vis, uint32_t (&pf)[NG][2]) {
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * n + 2 * i + c;
        pr[e] = !MASKED || vis(i, n, c) ? attn::ex2(fmaf(s[e], scale_log2, -lse2(i, n, c))) : 0.f;
      }
      pf[n][i] = attn::pack_bf16(pr[4 * n + 2 * i], pr[4 * n + 2 * i + 1]);
    }
}
template <bool MASKED, int NG = 8, class Lse, class Vis>
__device__ __forceinline__ void probs(float* s, float scale_log2, const Lse& lse2,
                                      const Vis& vis, uint32_t (&pf)[NG][2]) {
  probs_to<MASKED>(s, s, scale_log2, lse2, vis, pf);
}

// dS = P (dP - delta) of the same entries as bf16 pairs in that layout,
// from probs' P and the raw dP; dl(i, n, c): the entry's delta
template <int NG = 8, class Dl>
__device__ __forceinline__ void dscores(const float* pr, const float* dp, const Dl& dl,
                                        uint32_t (&df)[NG][2]) {
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = 4 * n + 2 * i;
      df[n][i] = attn::pack_bf16(pr[e] * (dp[e] - dl(i, n, 0)),
                                 pr[e + 1] * (dp[e + 1] - dl(i, n, 1)));
    }
}

// A lane's rows r0 and r0 + 8 of a [64 x N] f32 accumulator (N >= D),
// its first D columns times scale, as bf16 at row(i) (skipped when
// nullptr)
template <int D, class Row>
__device__ __forceinline__ void store_rows(const float* acc, float scale, Row row) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* o = row(i);
    if (o == nullptr) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
  }
}

// grid: ceil(Sk / 128) key blocks x Kh x B, the key block slowest (blocks
// start in launch order: a causal grid's first keys see the most rows).
// Warpgroup w owns keys k0 + 64 w ..; step it is query head kh * G + it /
// nq, query tile qt_begin + it % nq.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map, const Params p) {
  constexpr int DP = PADDED<D>, DC = DP / 64;
  auto& sm = smem<DkdvSmem<D>>();
  const int G = p.H / p.Kh, per = p.Kh * p.B;
  const int k0 = (int)(blockIdx.x / per) * BLOCK;
  const int kh = (int)(blockIdx.x % per) % p.Kh, b = (int)(blockIdx.x % per) / p.Kh;
  int q_lo, q_hi;
  query_range(k0, BLOCK, p.Sq, p.causal, p.window, p.kv_offset, q_lo, q_hi);
  const int qt_begin = q_lo / BN;
  const int nq = q_hi > q_lo ? (q_hi + BN - 1) / BN - qt_begin : 0;
  const int n_iter = G * nq;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);                // the producer warp's lanes
      mbar_init(&sm.empty[s], CONSUMERS / 32);   // each consumer warp releases
    }
    mbar_init(&sm.kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= CONSUMERS) {        // the producer warpgroup; its first warp loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= CONSUMERS + 32 || n_iter == 0) return;
    if (lane == 0) {
      mbar_expect(&sm.kv_full, 2 * DC * 2 * BOX);
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tma_load4(reinterpret_cast<unsigned char*>(sm.k[c]) + r * BOX, &k_map, c * 64,
                    k0 + r * BN, kh, b, &sm.kv_full);
          tma_load4(reinterpret_cast<unsigned char*>(sm.v[c]) + r * BOX, &v_map, c * 64,
                    k0 + r * BN, kh, b, &sm.kv_full);
        }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
      const int h = kh * G + it / nq, q0 = (qt_begin + it % nq) * BN;
      const int64_t row0 = ((int64_t)b * p.H + h) * p.Sq;
#pragma unroll
      for (int r = lane; r < BN; r += 32) {
        const bool in = q0 + r < p.Sq;
        sm.lse[s][r] = in ? p.lse[row0 + q0 + r] * attn::LOG2E : attn::inf_f32();
        sm.delta[s][r] = in ? p.delta[row0 + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect(&sm.full[s], 2 * DC * BOX);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          tma_load4(sm.q[s][c], &q_map, c * 64, q0, h, b, &sm.full[s]);
          tma_load4(sm.dout[s][c], &do_map, c * 64, q0, h, b, &sm.full[s]);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw = k0 + wg * BM;           // this warpgroup's keys [kw, kw + 64)
  const int key0 = kw + warp * 16 + g;   // this lane's keys: key0 and key0 + 8
  const uint32_t k_addr = smem_u32(sm.k) + wg * BM * 128;
  const uint32_t v_addr = smem_u32(sm.v) + wg * BM * 128;
  float dK[DP / 2], dV[DP / 2];          // [64 keys x DP] f32 in wgmma's layout
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dK[i] = dV[i] = 0.f;
  if (n_iter > 0) mbar_wait(&sm.kv_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const int q0 = (qt_begin + it % nq) * BN;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    const int kind =
        tile_kind(q0, BN, kw, BM, p.Sq, p.Sk, p.causal, p.window, p.kv_offset);
    if (kind != EMPTY) {
      const uint32_t q_addr = smem_u32(sm.q[s]), do_addr = smem_u32(sm.dout[s]);
      float st[32], dpt[32];             // S^T = K Q^T, dP^T = V dO^T: keys x query rows
      wg_fence();
      issue_abt<D>(st, k_addr, 2 * BOX, q_addr);
      wg_commit();
      issue_abt<D>(dpt, v_addr, 2 * BOX, do_addr);
      wg_commit();

      // P^T while dP^T is computed (row = key, column = query row, whose
      // lse and delta the stage holds); then dV += P^T dO while dS^T is
      // formed, and dK += dS^T Q: dO and Q read MN-major where they lie
      const float* L = sm.lse[s];
      const float* Dl = sm.delta[s];
      auto lse2 = [&](int, int n, int c) { return L[8 * n + 2 * t4 + c]; };
      auto dl = [&](int, int n, int c) { return Dl[8 * n + 2 * t4 + c]; };
      uint32_t pf[8][2], df[8][2];
      wg_wait<1>();
      fence_regs<32>(st);
      if (kind == FULL) {
        probs<false>(st, p.scale_log2, lse2, [](int, int, int) { return true; }, pf);
      } else {
        probs<true>(st, p.scale_log2, lse2,
                    [&](int i, int n, int c) {
                      const int key = key0 + 8 * i, qi = q0 + 8 * n + 2 * t4 + c;
                      return key < p.Sk && qi < p.Sq &&
                             sees(p.kv_offset + qi, key, p.causal, p.window);
                    },
                    pf);
      }
      fence_regs<DP / 2>(dV);
      wg_fence();
      issue_ab<DP>(dV, pf, do_addr);
      wg_commit();
      wg_wait<1>();
      fence_regs<32>(dpt);
      dscores(st, dpt, dl, df);
      fence_regs<DP / 2>(dK);
      wg_fence();
      issue_ab<DP>(dK, df, q_addr);
      wg_commit();
      wg_wait<0>();
      fence_regs<DP / 2>(dV);
      fence_regs<DP / 2>(dK);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  store_rows<D>(dK, p.scale, [&](int i) -> bf16* {
    const int key = key0 + 8 * i;
    return key < p.Sk ? p.dk + b * p.dkst.b + kh * p.dkst.h + key * p.dkst.s : nullptr;
  });
  store_rows<D>(dV, 1.f, [&](int i) -> bf16* {
    const int key = key0 + 8 * i;
    return key < p.Sk ? p.dv + b * p.dvst.b + kh * p.dvst.h + key * p.dvst.s : nullptr;
  });
}

// grid: ceil(Sq / 128) query blocks x H x B, the query block slowest; a
// causal grid starts with the last rows (the most keys).  Warpgroup w owns
// query rows q0 + 64 w ..; step it is key tile kt_begin + it.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map, const Params p) {
  constexpr int DP = PADDED<D>, DC = DP / 64;
  auto& sm = smem<DqSmem<D>>();
  const int per = p.H * p.B, n_qb = (int)gridDim.x / per, qb = (int)(blockIdx.x / per);
  const int q0 = (p.causal ? n_qb - 1 - qb : qb) * BLOCK;
  const int h = (int)(blockIdx.x % per) % p.H, b = (int)(blockIdx.x % per) / p.H;
  const int kh = h / (p.H / p.Kh);
  int kt_begin, kt_end;
  key_tiles(q0, min(BLOCK, p.Sq - q0), p.Sk, BN, p.causal, p.window, p.kv_offset, kt_begin,
            kt_end);
  const int n_iter = kt_end - kt_begin;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);
    }
    mbar_init(&sm.qd_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= CONSUMERS) {        // the producer warpgroup; one thread loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS || n_iter == 0) return;
    mbar_expect(&sm.qd_full, 2 * DC * 2 * BOX);
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tma_load4(reinterpret_cast<unsigned char*>(sm.q[c]) + r * BOX, &q_map, c * 64,
                  q0 + r * BN, h, b, &sm.qd_full);
        tma_load4(reinterpret_cast<unsigned char*>(sm.dout[c]) + r * BOX, &do_map, c * 64,
                  q0 + r * BN, h, b, &sm.qd_full);
      }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES, key = (kt_begin + it) * BN;
      if (it >= STAGES) mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
      mbar_expect(&sm.full[s], 2 * DC * BOX);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        tma_load4(sm.k[s][c], &k_map, c * 64, key, kh, b, &sm.full[s]);
        tma_load4(sm.v[s][c], &v_map, c * 64, key, kh, b, &sm.full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qw = q0 + wg * BM;           // this warpgroup's rows [qw, qw + 64)
  int row[2];                            // this lane's rows, their lse (log2 units), delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = qw + warp * 16 + g + 8 * i;
    const int64_t idx = ((int64_t)b * p.H + h) * p.Sq + row[i];
    lse2[i] = row[i] < p.Sq ? p.lse[idx] * attn::LOG2E : attn::inf_f32();
    dl[i] = row[i] < p.Sq ? p.delta[idx] : 0.f;
  }
  const uint32_t q_addr = smem_u32(sm.q) + wg * BM * 128;
  const uint32_t do_addr = smem_u32(sm.dout) + wg * BM * 128;
  float dQ[DP / 2];                      // [64 rows x DP] f32 in wgmma's layout
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dQ[i] = 0.f;
  if (n_iter > 0) mbar_wait(&sm.qd_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES, kt = kt_begin + it;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    const int kind =
        tile_kind(qw, BM, kt * BN, BN, p.Sq, p.Sk, p.causal, p.window, p.kv_offset);
    if (kind != EMPTY) {
      const uint32_t k_addr = smem_u32(sm.k[s]), v_addr = smem_u32(sm.v[s]);
      float sc[32], dp[32];              // S = Q K^T, dP = dO V^T: query rows x keys
      wg_fence();
      issue_abt<D>(sc, q_addr, 2 * BOX, k_addr);
      wg_commit();
      issue_abt<D>(dp, do_addr, 2 * BOX, v_addr);
      wg_commit();

      // P while dP is computed, then dS, then dQ += dS K: K read MN-major
      // where it lies
      auto l2 = [&](int i, int, int) { return lse2[i]; };
      auto d2 = [&](int i, int, int) { return dl[i]; };
      uint32_t pf[8][2], df[8][2];       // pf unused: dQ needs dS only
      wg_wait<1>();
      fence_regs<32>(sc);
      if (kind == FULL) {
        probs<false>(sc, p.scale_log2, l2, [](int, int, int) { return true; }, pf);
      } else {
        probs<true>(sc, p.scale_log2, l2,
                    [&](int i, int n, int c) {
                      const int key = kt * BN + 8 * n + 2 * t4 + c;
                      return key < p.Sk && row[i] < p.Sq &&
                             sees(p.kv_offset + row[i], key, p.causal, p.window);
                    },
                    pf);
      }
      wg_wait<0>();
      fence_regs<32>(dp);
      dscores(sc, dp, d2, df);
      fence_regs<DP / 2>(dQ);
      wg_fence();
      issue_ab<DP>(dQ, df, k_addr);
      wg_commit();
      wg_wait<0>();
      fence_regs<DP / 2>(dQ);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  store_rows<D>(dQ, p.scale, [&](int i) -> bf16* {
    return row[i] < p.Sq ? p.dq + b * p.dqst.b + h * p.dqst.h + row[i] * p.dqst.s : nullptr;
  });
}

// ---------------------------------------------------------------------------
// The wide body: D = 160 (stablelm-12b), 256 (gemma) and MLA's (192, 128)
// ---------------------------------------------------------------------------
// The narrow body does not fit above D = 128: a consumer warpgroup holding
// dK and dV of its 64 keys at every column beside S^T and dP^T of a whole
// 64-row tile needs over the 240 registers setmaxnreg gives, and K and V
// of 128 keys plus three 64-row Q/dO stages are 320 KB at D = 256.  The
// wide body has two designs, each kernel taking the first that fits its
// widths (DKDV_ROWS, DQ_ROWS; the grid in L2-sized chunks of heads,
// wide_block):
// - Row-split (dQ at D <= 192, dK/dV at MLA's (192, 128)): 128-row blocks
//   whose consumer warpgroups each own 64 of the rows (keys) and all of
//   the gradient's columns, as in the narrow body, taking S^T / dP^T in
//   32-row halves of each tile where needed; each streamed tile then
//   serves 128 rows, half the L2 traffic of 64-row blocks (which bounded
//   DeepSeek-V2's shape), and no P / dS crosses warpgroups
//   (flash_bwd_dkdv_rows_wgmma_kernel, flash_bwd_dq_rows_wgmma_kernel).
// - Halves (dK/dV at D = 160 and 256, dQ at D = 256): a block owns 64 keys
//   (dK/dV) or 64 query rows (dQ), and its two consumer warpgroups split
//   each tile by halves, both issuing the same wgmma stream on their own
//   addresses (no wgmma in warpgroup-divergent code, which ptxas would
//   serialize):
//   1. warpgroup w computes S^T = K Q^T and dP^T = V dO^T for the tile's
//      query rows [32 w, 32 w + 32) (dQ: S = Q K^T and dP = dO V^T for the
//      tile's keys [32 w, 32 w + 32)) on m64n32k16, forms P and dS = P (dP
//      - delta) in f32 from its own registers, and writes them as bf16
//      into shared memory: P^T and dS^T as [64 keys][64 query rows] (dQ:
//      dS as [64 rows][64 keys]) in the 128-byte swizzle wgmma reads
//      K-major;
//   2. each warpgroup tells the other on a named barrier that its half is
//      written, and waits for the other's;
//   3. each warpgroup owns half of the gradient's columns: dV += P^T dO and
//      dK += dS^T Q (dQ += dS K), A = P^T / dS^T over all 64 query rows
//      (keys) from shared memory, B the dO / Q (K) tile read MN-major
//      where it lies.  A half of W columns (Half<W>) is 64 M whole chunks
//      at chunk M w (M = W / 128), then N2 = W / 2 - 64 M columns of chunk
//      2 M at its column N2 w: 160 = 2 (64 + 16), 256 = 2 x 128, so no
//      column of TMA's zero fill past D is multiplied.
//   The streamed tiles (Q and dO; K and V) take three stages where shared
//   memory holds them (D = 160), two at D = 256, and the tiles pipeline as
//   wide_walk says; each consumer thread reads its query rows' lse and
//   delta from global memory while its scores run (a producer warp that
//   stored them held every tile's copy back by a load's latency).  P^T /
//   dS^T alternate between two buffers, so one warpgroup writes tile it +
//   1's while the other may still read tile it's.  Registers a consumer
//   thread: dK and dV W / 4 each (64 + 64 at D = 256), S^T and dP^T 16
//   each, P 16 in f32, P and dS 8 bf16 pairs each, and in dK/dV the lse
//   and delta of 8 query rows.  A tile no pair of which is visible is
//   computed with the mask (P = dS = 0) instead of skipped, so every
//   thread runs the same wgmma stream; the walk's ranges (query_range,
//   key_tiles) give no such tile.
// In both, each product keeps the k order of the first wide body (S^T / S
// over D in 16-column steps, the gradients over each tile's 64 query rows
// or keys in order), P and dS round once to bf16 from the same f32 values,
// and each gradient element is one block's sum over the tiles in a fixed
// order: the first body's bits.
constexpr int BAR_HALF = 1;  // named barriers 1-4: a warpgroup's half of P / dS is written

template <int W>
struct Half {                          // a consumer warpgroup's columns of a W-wide gradient
  static constexpr int M = W / 128;    // whole 64-column chunks, from chunk M w
  static constexpr int N1 = 64 * M;
  static constexpr int N2 = W / 2 - N1;   // then columns N2 w .. of chunk 2 M
  static_assert(W % 32 == 0 && N2 % 16 == 0 && 2 * N2 <= 64, "Half: W");
};

template <int D, int DV, int ST>
struct alignas(1024) WideDkdvSmem {
  static constexpr int CK = (D + 63) / 64, CV = (DV + 63) / 64;   // 64-column chunks
  bf16 k[CK][BN * 64];                 // chunk c: [64 keys][64 columns], swizzled
  bf16 v[CV][BN * 64];
  bf16 q[ST][CK][BN * 64];             // chunk c of a stage: [64 query rows][64]
  bf16 dout[ST][CV][BN * 64];
  bf16 pt[2][BN * 64];                 // P^T, dS^T of alternate tiles: [64 keys][64 rows]
  bf16 dst[2][BN * 64];
  uint64_t full[ST], empty[ST], kv_full;
};

template <int D, int DV, int ST>
struct alignas(1024) WideDqSmem {
  static constexpr int CK = (D + 63) / 64, CV = (DV + 63) / 64;
  bf16 q[CK][BN * 64];                 // chunk c: [64 query rows][64 columns], swizzled
  bf16 dout[CV][BN * 64];
  bf16 k[ST][CK][BN * 64];             // chunk c of a stage: [64 keys][64]
  bf16 v[ST][CV][BN * 64];
  bf16 ds[2][BN * 64];                 // dS of alternate tiles: [64 rows][64 keys]
  uint64_t full[ST], empty[ST], qd_full;
};

// three stages where they fit the block's shared memory (+ the base's alignment)
template <template <int, int, int> class Smem, int D, int DV>
constexpr int WIDE_STAGES = sizeof(Smem<D, DV, 3>) + 1024 <= SMEM_MAX ? 3 : 2;

// A lane's 2 x 8 entries of a tile's 32-column half as bf16 pairs f
// (wgmma's accumulator layout, the half's columns from col0) into a
// [64 rows][64 columns] buffer in the 128-byte swizzle (16-byte group j
// of row r at j ^ (r % 8)); conflict-free
__device__ __forceinline__ void put_half(bf16* buf, const uint32_t (&f)[4][2], int col0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  uint32_t* w = reinterpret_cast<uint32_t*>(buf);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int r = warp * 16 + g + 8 * i;   // r % 8 == g
      w[r * 32 + (((col0 / 8 + n) ^ g) << 2) + t4] = f[n][i];
    }
}

// acc[64 x 32] = A B^T over KD columns: A's 64 rows at a (chunks of 64
// columns a_chunk bytes apart), B's 32 rows at b (chunks BOX apart), both
// K-major, swizzled; issued, not waited for
template <int KD>
__device__ __forceinline__ void issue_half_scores(float* acc, uint32_t a, uint32_t a_chunk,
                                                  uint32_t b) {
  a = opaque(a);
  b = opaque(b);
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk)
    mma_ss<32, 0>(acc, desc(a + (kk / 4) * a_chunk + (kk % 4) * 32, 16, 1024),
                  desc(b + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024), kk);
}

// Warpgroup wg's half of a W-wide gradient += A B over 64 rows of k: A
// [64 x 64] at a (K-major, swizzled), B the tile at b ([64 rows][W] in
// chunks BOX apart) read MN-major; issued, not waited for
template <int W>
__device__ __forceinline__ void issue_half_grad(float* acc1, float* acc2, uint32_t a, uint32_t b,
                                                int wg) {
  using H = Half<W>;
  a = opaque(a);
  b = opaque(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = desc(a + kk * 32, 16, 1024);
    mma_ss<H::N1, 1>(acc1, da, desc(b + H::M * wg * BOX + kk * 16 * 128, BOX, 1024), 1);
    if constexpr (H::N2 > 0)
      mma_ss<H::N2, 1>(acc2, da,
                       desc(b + 2 * H::M * BOX + H::N2 * wg * 2 + kk * 16 * 128, BOX, 1024), 1);
  }
}

// Warpgroup wg's half of a W-wide gradient of a lane's rows, times scale,
// as bf16 at row(i) (skipped when nullptr)
template <int W, class Row>
__device__ __forceinline__ void store_half(const float* acc1, const float* acc2, int wg,
                                           float scale, Row row) {
  using H = Half<W>;
  store_rows<H::N1>(acc1, scale, [&](int i) -> bf16* {
    bf16* o = row(i);
    return o == nullptr ? nullptr : o + H::N1 * wg;
  });
  if constexpr (H::N2 > 0)
    store_rows<H::N2>(acc2, scale, [&](int i) -> bf16* {
      bf16* o = row(i);
      return o == nullptr ? nullptr : o + 2 * H::N1 + H::N2 * wg;
    });
}

// The wide body's grid: n_groups groups (a KV head's query heads for dK /
// dV, a query head for dQ; each batch entry its own) of n_blk blocks,
// walked in chunks of `chunk` groups whose streamed tiles fit in L2
// together (wide_chunk), each chunk block-major: every group's first block
// (the longest under a causal mask), then every group's second.  Group
// and block of this block.
__device__ __forceinline__ void wide_block(int n_groups, int chunk, int& group, int& blk) {
  const int n_blk = (int)gridDim.x / n_groups, id = (int)blockIdx.x;
  const int c = id / (chunk * n_blk), r = id % (chunk * n_blk);
  const int in_c = min(chunk, n_groups - c * chunk);
  blk = r / in_c;
  group = c * chunk + r % in_c;
}

// The consumers' walk over n_iter tiles streamed through ST stages
// (full / empty: the stages' mbarriers).  s_scores(it) and dp_scores(it)
// issue tile it's S^T and dP^T (S and dP) products, form_p(it) and
// form_ds(it) turn them into this half's P and dS in registers, put(it)
// writes those to shared memory, grads(it) issues the gradient products.
// Step it issues tile it's scores and tile it - 1's gradients and waits
// for all of them before it ends, so no product is in flight across the
// loop's back edge (ptxas would serialize them).  With three stages the
// scores go first: P is formed while the tensor cores do dP^T and the
// gradients, and tile it + 1's stage loads meanwhile (its slot was tile it
// - 2's, free since step it - 1).  With two (D = 256) tile it + 1's slot
// is tile it - 1's, free only once those gradients are done, so they go
// first.  Each warpgroup tells the other that its half of a tile's P / dS
// is written on its own named barrier, one of two by the tile's parity (a
// warpgroup may run a tile ahead), and waits on the other's before the
// gradients read both halves.
template <int ST, class SScores, class DpScores, class FormP, class FormDs, class Put,
          class Grads>
__device__ __forceinline__ void wide_walk(int n_iter, uint64_t* full, uint64_t* empty,
                                          const SScores& s_scores, const DpScores& dp_scores,
                                          const FormP& form_p, const FormDs& form_ds,
                                          const Put& put, const Grads& grads) {
  const int lane = threadIdx.x % 32, wg = threadIdx.x / 128;
  auto release = [&](int it) {         // each consumer warp is done with tile it's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % ST]);
  };
  auto share = [&](int it) {           // this half of tile it's P / dS, for both warpgroups
    put(it);
    fence_async_smem();
    bar_arrive(BAR_HALF + 2 * (it & 1) + wg, CONSUMERS);
  };
  auto other_half = [&](int it) { bar_sync(BAR_HALF + 2 * (it & 1) + 1 - wg, CONSUMERS); };
  if (n_iter == 0) return;
  mbar_wait(&full[0], 0);
  wg_fence();
  s_scores(0);
  wg_commit();
  dp_scores(0);
  wg_commit();
  wg_wait<1>();
  form_p(0);
  wg_wait<0>();
  form_ds(0);
  share(0);
  for (int it = 1; it < n_iter; ++it) {
    mbar_wait(&full[it % ST], (it / ST) & 1);
    wg_fence();
    if constexpr (ST >= 3) {
      s_scores(it);
      wg_commit();
      dp_scores(it);
      wg_commit();
      other_half(it - 1);
      grads(it - 1);
      wg_commit();
      wg_wait<2>();                      // S^T: P while dP^T and the gradients run
      form_p(it);
      wg_wait<1>();
      form_ds(it);
      wg_wait<0>();
      release(it - 1);
    } else {
      other_half(it - 1);
      grads(it - 1);
      wg_commit();
      s_scores(it);
      wg_commit();
      dp_scores(it);
      wg_commit();
      wg_wait<1>();                      // the gradients and S^T: P while dP^T runs
      release(it - 1);
      form_p(it);
      wg_wait<0>();
      form_ds(it);
    }
    share(it);
  }
  other_half(n_iter - 1);
  wg_fence();
  grads(n_iter - 1);
  wg_commit();
  wg_wait<0>();
}

// grid: ceil(Sk / 64) key blocks x Kh x B in wide_block's order.  Step it
// is query head kh * G + it / nq, query tile qt_begin + it % nq.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wide_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap do_map, const Params p) {
  constexpr int ST = WIDE_STAGES<WideDkdvSmem, D, DV>;
  using Sm = WideDkdvSmem<D, DV, ST>;
  constexpr int CK = Sm::CK, CV = Sm::CV;
  auto& sm = smem<Sm>();
  const int G = p.H / p.Kh;
  int group, kb;
  wide_block(p.Kh * p.B, p.chunk, group, kb);
  const int k0 = kb * BN, kh = group % p.Kh, b = group / p.Kh;
  int q_lo, q_hi;
  query_range(k0, BN, p.Sq, p.causal, p.window, p.kv_offset, q_lo, q_hi);
  const int qt_begin = q_lo / BN;
  const int nq = q_hi > q_lo ? (q_hi + BN - 1) / BN - qt_begin : 0;
  const int n_iter = G * nq;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);   // each consumer warp releases
    }
    mbar_init(&sm.kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= CONSUMERS) {        // the producer warpgroup; one thread loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS || n_iter == 0) return;
    mbar_expect(&sm.kv_full, (CK + CV) * BOX);
#pragma unroll
    for (int c = 0; c < CK; ++c) tma_load4(sm.k[c], &k_map, c * 64, k0, kh, b, &sm.kv_full);
#pragma unroll
    for (int c = 0; c < CV; ++c) tma_load4(sm.v[c], &v_map, c * 64, k0, kh, b, &sm.kv_full);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % ST, h = kh * G + it / nq, q0 = (qt_begin + it % nq) * BN;
      if (it >= ST) mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      mbar_expect(&sm.full[s], (CK + CV) * BOX);
#pragma unroll
      for (int c = 0; c < CK; ++c) tma_load4(sm.q[s][c], &q_map, c * 64, q0, h, b, &sm.full[s]);
#pragma unroll
      for (int c = 0; c < CV; ++c) tma_load4(sm.dout[s][c], &do_map, c * 64, q0, h, b, &sm.full[s]);
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  using HK = Half<D>;
  using HV = Half<DV>;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int key0 = k0 + warp * 16 + g;   // this lane's keys: key0 and key0 + 8
  const uint32_t k_addr = smem_u32(sm.k), v_addr = smem_u32(sm.v);
  float dK1[HK::N1 / 2], dK2[HK::N2 ? HK::N2 / 2 : 1];   // this warpgroup's half of dK
  float dV1[HV::N1 / 2], dV2[HV::N2 ? HV::N2 / 2 : 1];   // ... and of dV
  float st[16], dpt[16];                 // S^T, dP^T: 64 keys x this half's 32 query rows
#pragma unroll
  for (int i = 0; i < HK::N1 / 2; ++i) dK1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HV::N1 / 2; ++i) dV1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (HK::N2 ? HK::N2 / 2 : 1); ++i) dK2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (HV::N2 ? HV::N2 / 2 : 1); ++i) dV2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
  float pr[16];                          // P^T in f32 (S^T stays as the products left it)
  uint32_t pf[4][2], df[4][2];           // P^T, dS^T of this half as bf16 pairs
  float lse2[8], dl[8];                  // the lane's query rows' lse (log2 units) and delta
  auto s_scores = [&](int it) {
    // this tile's lse and delta, read while the products run
    const int h = kh * G + it / nq, q0 = (qt_begin + it % nq) * BN + 32 * wg + 2 * t4;
    const int64_t row0 = ((int64_t)b * p.H + h) * p.Sq;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int qi = q0 + 8 * (e / 2) + e % 2;
      lse2[e] = qi < p.Sq ? p.lse[row0 + qi] * attn::LOG2E : attn::inf_f32();
      dl[e] = qi < p.Sq ? p.delta[row0 + qi] : 0.f;
    }
    issue_half_scores<D>(st, k_addr, BOX, smem_u32(sm.q[it % ST]) + wg * 32 * 128);
  };
  auto dp_scores = [&](int it) {
    issue_half_scores<DV>(dpt, v_addr, BOX, smem_u32(sm.dout[it % ST]) + wg * 32 * 128);
  };
  // P^T and dS^T (row = key, column = query row)
  auto form_p = [&](int it) {
    const int q0 = (qt_begin + it % nq) * BN;
    const int kind = tile_kind(q0, BN, k0, BN, p.Sq, p.Sk, p.causal, p.window, p.kv_offset);
    auto l2 = [&](int, int n, int c) { return lse2[2 * n + c]; };
    fence_regs<16>(st);
    if (kind == FULL) {
      probs_to<false>(st, pr, p.scale_log2, l2, [](int, int, int) { return true; }, pf);
    } else {
      probs_to<true>(st, pr, p.scale_log2, l2,
                  [&](int i, int n, int c) {
                    const int key = key0 + 8 * i, qi = q0 + 32 * wg + 8 * n + 2 * t4 + c;
                    return key < p.Sk && qi < p.Sq &&
                           sees(p.kv_offset + qi, key, p.causal, p.window);
                  },
                  pf);
    }
  };
  auto form_ds = [&](int) {
    fence_regs<16>(dpt);
    dscores(pr, dpt, [&](int, int n, int c) { return dl[2 * n + c]; }, df);
  };
  auto put = [&](int it) {               // after the wait on tile it - 1's gradients
    fence_regs<HK::N1 / 2>(dK1);
    fence_regs<HK::N2 ? HK::N2 / 2 : 1>(dK2);
    fence_regs<HV::N1 / 2>(dV1);
    fence_regs<HV::N2 ? HV::N2 / 2 : 1>(dV2);
    put_half(sm.pt[it & 1], pf, 32 * wg);
    put_half(sm.dst[it & 1], df, 32 * wg);
  };
  // dV += P^T dO and dK += dS^T Q on this warpgroup's columns
  auto grads = [&](int it) {
    const int s = it % ST;
    issue_half_grad<DV>(dV1, dV2, smem_u32(sm.pt[it & 1]), smem_u32(sm.dout[s]), wg);
    issue_half_grad<D>(dK1, dK2, smem_u32(sm.dst[it & 1]), smem_u32(sm.q[s]), wg);
  };
  if (n_iter > 0) mbar_wait(&sm.kv_full, 0);
  wide_walk<ST>(n_iter, sm.full, sm.empty, s_scores, dp_scores, form_p, form_ds, put, grads);
  fence_regs<HK::N1 / 2>(dK1);
  fence_regs<HK::N2 ? HK::N2 / 2 : 1>(dK2);
  fence_regs<HV::N1 / 2>(dV1);
  fence_regs<HV::N2 ? HV::N2 / 2 : 1>(dV2);

  store_half<D>(dK1, dK2, wg, p.scale, [&](int i) -> bf16* {
    const int key = key0 + 8 * i;
    return key < p.Sk ? p.dk + b * p.dkst.b + kh * p.dkst.h + key * p.dkst.s : nullptr;
  });
  store_half<DV>(dV1, dV2, wg, 1.f, [&](int i) -> bf16* {
    const int key = key0 + 8 * i;
    return key < p.Sk ? p.dv + b * p.dvst.b + kh * p.dvst.h + key * p.dvst.s : nullptr;
  });
}

// grid: ceil(Sq / 64) query blocks x H x B in wide_block's order; a causal
// head starts with its last rows.  Step it is key tile kt_begin + it.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wide_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map, const Params p) {
  constexpr int ST = WIDE_STAGES<WideDqSmem, D, DV>;
  using Sm = WideDqSmem<D, DV, ST>;
  constexpr int CK = Sm::CK, CV = Sm::CV;
  auto& sm = smem<Sm>();
  int group, qb;
  wide_block(p.H * p.B, p.chunk, group, qb);
  const int n_qb = (int)gridDim.x / (p.H * p.B);
  const int q0 = (p.causal ? n_qb - 1 - qb : qb) * BN;
  const int h = group % p.H, b = group / p.H;
  const int kh = h / (p.H / p.Kh);
  int kt_begin, kt_end;
  key_tiles(q0, min(BN, p.Sq - q0), p.Sk, BN, p.causal, p.window, p.kv_offset, kt_begin,
            kt_end);
  const int n_iter = kt_end - kt_begin;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);
    }
    mbar_init(&sm.qd_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= CONSUMERS) {        // the producer warpgroup; one thread loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS || n_iter == 0) return;
    mbar_expect(&sm.qd_full, (CK + CV) * BOX);
#pragma unroll
    for (int c = 0; c < CK; ++c) tma_load4(sm.q[c], &q_map, c * 64, q0, h, b, &sm.qd_full);
#pragma unroll
    for (int c = 0; c < CV; ++c) tma_load4(sm.dout[c], &do_map, c * 64, q0, h, b, &sm.qd_full);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % ST, key = (kt_begin + it) * BN;
      if (it >= ST) mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      mbar_expect(&sm.full[s], (CK + CV) * BOX);
#pragma unroll
      for (int c = 0; c < CK; ++c) tma_load4(sm.k[s][c], &k_map, c * 64, key, kh, b, &sm.full[s]);
#pragma unroll
      for (int c = 0; c < CV; ++c) tma_load4(sm.v[s][c], &v_map, c * 64, key, kh, b, &sm.full[s]);
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  using HK = Half<D>;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  int row[2];                            // this lane's rows, their lse (log2 units), delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    const int64_t idx = ((int64_t)b * p.H + h) * p.Sq + row[i];
    lse2[i] = row[i] < p.Sq ? p.lse[idx] * attn::LOG2E : attn::inf_f32();
    dl[i] = row[i] < p.Sq ? p.delta[idx] : 0.f;
  }
  const uint32_t q_addr = smem_u32(sm.q), do_addr = smem_u32(sm.dout);
  float dQ1[HK::N1 / 2], dQ2[HK::N2 ? HK::N2 / 2 : 1];   // this warpgroup's half of dQ
  float sc[16], dp[16];                  // S, dP: 64 rows x this half's 32 keys
#pragma unroll
  for (int i = 0; i < HK::N1 / 2; ++i) dQ1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (HK::N2 ? HK::N2 / 2 : 1); ++i) dQ2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
  float pr[16];                          // P in f32 (S stays as the products left it)
  uint32_t pf[4][2], df[4][2];           // P, dS of this half as bf16 pairs (pf unused)
  auto s_scores = [&](int it) {
    issue_half_scores<D>(sc, q_addr, BOX, smem_u32(sm.k[it % ST]) + wg * 32 * 128);
  };
  auto dp_scores = [&](int it) {
    issue_half_scores<DV>(dp, do_addr, BOX, smem_u32(sm.v[it % ST]) + wg * 32 * 128);
  };
  auto form_p = [&](int it) {
    const int kt = kt_begin + it;
    const int kind = tile_kind(q0, BN, kt * BN, BN, p.Sq, p.Sk, p.causal, p.window, p.kv_offset);
    auto l2 = [&](int i, int, int) { return lse2[i]; };
    fence_regs<16>(sc);
    if (kind == FULL) {
      probs_to<false>(sc, pr, p.scale_log2, l2, [](int, int, int) { return true; }, pf);
    } else {
      probs_to<true>(sc, pr, p.scale_log2, l2,
                  [&](int i, int n, int c) {
                    const int key = kt * BN + 32 * wg + 8 * n + 2 * t4 + c;
                    return key < p.Sk && row[i] < p.Sq &&
                           sees(p.kv_offset + row[i], key, p.causal, p.window);
                  },
                  pf);
    }
  };
  auto form_ds = [&](int) {
    fence_regs<16>(dp);
    dscores(pr, dp, [&](int i, int, int) { return dl[i]; }, df);
  };
  auto put = [&](int it) {               // after the wait on tile it - 1's product
    fence_regs<HK::N1 / 2>(dQ1);
    fence_regs<HK::N2 ? HK::N2 / 2 : 1>(dQ2);
    put_half(sm.ds[it & 1], df, 32 * wg);
  };
  // dQ += dS K on this warpgroup's columns
  auto grads = [&](int it) {
    issue_half_grad<D>(dQ1, dQ2, smem_u32(sm.ds[it & 1]), smem_u32(sm.k[it % ST]), wg);
  };
  if (n_iter > 0) mbar_wait(&sm.qd_full, 0);
  wide_walk<ST>(n_iter, sm.full, sm.empty, s_scores, dp_scores, form_p, form_ds, put, grads);
  fence_regs<HK::N1 / 2>(dQ1);
  fence_regs<HK::N2 ? HK::N2 / 2 : 1>(dQ2);

  store_half<D>(dQ1, dQ2, wg, p.scale, [&](int i) -> bf16* {
    return row[i] < p.Sq ? p.dq + b * p.dqst.b + h * p.dqst.h + row[i] * p.dqst.s : nullptr;
  });
}

// acc[64 x W] += A B over one k-step: A register fragments a, B rows of
// W columns at b (chunks BOX apart) read MN-major: W = 128, 160 or 192
template <int W>
__device__ __forceinline__ void issue_rows_grad(float* acc, const uint32_t (&a)[4], uint32_t b) {
  if constexpr (W == 128)
    mma_rs_n128(acc, a, desc(b, BOX, 1024));
  else
    mma_rs<W>(acc, a, desc(b, BOX, 1024));
}

// The row-split dK / dV (MLA): 128-key blocks, warpgroup w owning keys
// [64 w, 64 w + 64) and all of dK's and dV's columns.  It takes each 64-row
// tile in two halves of 32 query rows: S^T and dP^T of its keys and the
// half (m64n32k16, A its K / V rows, B the half's Q / dO rows, K-major),
// P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q with them
// as register A fragments and dO / Q read MN-major (m64n{DV,D}k16).
// Registers a consumer thread: dK D / 2, dV DV / 2, S^T and dP^T 16 each.
// The tile's lse and delta come with it from the producer warp.  grid:
// ceil(Sk / 128) key blocks x Kh x B in wide_block's order.  Step it is
// query head kh * G + it / nq, query tile qt_begin + it % nq.
template <int D, int DV, int ST>
struct alignas(1024) RowsDkdvSmem {
  static constexpr int CK = (D + 63) / 64, CV = (DV + 63) / 64;
  bf16 k[CK][BLOCK * 64];              // chunk c: [128 keys][64 columns], swizzled
  bf16 v[CV][BLOCK * 64];
  bf16 q[ST][CK][BN * 64];             // chunk c of a stage: [64 query rows][64]
  bf16 dout[ST][CV][BN * 64];
  float lse[ST][BN], delta[ST][BN];    // lse in log2 units
  uint64_t full[ST], empty[ST], kv_full;
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_rows_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap do_map, const Params p) {
  constexpr int ST = WIDE_STAGES<RowsDkdvSmem, D, DV>;
  using Sm = RowsDkdvSmem<D, DV, ST>;
  constexpr int CK = Sm::CK, CV = Sm::CV;
  static_assert(D > 128 && D <= 192 && DV >= 128 && DV <= 192, "the row-split dK/dV's D");
  auto& sm = smem<Sm>();
  const int G = p.H / p.Kh;
  int group, kb;
  wide_block(p.Kh * p.B, p.chunk, group, kb);
  const int k0 = kb * BLOCK, kh = group % p.Kh, b = group / p.Kh;
  int q_lo, q_hi;
  query_range(k0, BLOCK, p.Sq, p.causal, p.window, p.kv_offset, q_lo, q_hi);
  const int qt_begin = q_lo / BN;
  const int nq = q_hi > q_lo ? (q_hi + BN - 1) / BN - qt_begin : 0;
  const int n_iter = G * nq;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 32);                // the producer warp's lanes
      mbar_init(&sm.empty[s], CONSUMERS / 32);   // each consumer warp releases
    }
    mbar_init(&sm.kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= CONSUMERS) {        // the producer warpgroup; its first warp loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= CONSUMERS + 32 || n_iter == 0) return;
    if (lane == 0) {
      mbar_expect(&sm.kv_full, (CK + CV) * 2 * BOX);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < CK; ++c)
          tma_load4(reinterpret_cast<unsigned char*>(sm.k[c]) + r * BOX, &k_map, c * 64,
                    k0 + r * BN, kh, b, &sm.kv_full);
#pragma unroll
        for (int c = 0; c < CV; ++c)
          tma_load4(reinterpret_cast<unsigned char*>(sm.v[c]) + r * BOX, &v_map, c * 64,
                    k0 + r * BN, kh, b, &sm.kv_full);
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % ST;
      if (it >= ST) mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      const int h = kh * G + it / nq, q0 = (qt_begin + it % nq) * BN;
      const int64_t row0 = ((int64_t)b * p.H + h) * p.Sq;
#pragma unroll
      for (int r = lane; r < BN; r += 32) {
        const bool in = q0 + r < p.Sq;
        sm.lse[s][r] = in ? p.lse[row0 + q0 + r] * attn::LOG2E : attn::inf_f32();
        sm.delta[s][r] = in ? p.delta[row0 + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect(&sm.full[s], (CK + CV) * BOX);
#pragma unroll
        for (int c = 0; c < CK; ++c) tma_load4(sm.q[s][c], &q_map, c * 64, q0, h, b, &sm.full[s]);
#pragma unroll
        for (int c = 0; c < CV; ++c)
          tma_load4(sm.dout[s][c], &do_map, c * 64, q0, h, b, &sm.full[s]);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw = k0 + wg * BM;           // this warpgroup's keys [kw, kw + 64)
  const int key0 = kw + warp * 16 + g;   // this lane's keys: key0 and key0 + 8
  const uint32_t k_addr = smem_u32(sm.k) + wg * BM * 128;
  const uint32_t v_addr = smem_u32(sm.v) + wg * BM * 128;
  float dK[D / 2], dV[DV / 2];           // [64 keys x D], [64 x DV] f32 in wgmma's layout
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dK[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dV[i] = 0.f;
  if (n_iter > 0) mbar_wait(&sm.kv_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % ST;
    const int q0 = (qt_begin + it % nq) * BN;
    mbar_wait(&sm.full[s], (it / ST) & 1);
    const int kind = tile_kind(q0, BN, kw, BM, p.Sq, p.Sk, p.causal, p.window, p.kv_offset);
    if (kind != EMPTY) {
      const uint32_t q_addr = smem_u32(sm.q[s]), do_addr = smem_u32(sm.dout[s]);
      // kept a loop: unrolled, the two halves' registers overlap and spill
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float st[16], dpt[16];           // S^T, dP^T: this warpgroup's keys x the half's rows
        wg_fence();
        issue_half_scores<D>(st, k_addr, 2 * BOX, q_addr + half * 32 * 128);
        wg_commit();
        issue_half_scores<DV>(dpt, v_addr, 2 * BOX, do_addr + half * 32 * 128);
        wg_commit();
        // P^T while dP^T is computed, then dV += P^T dO while dS^T is
        // formed, then dK += dS^T Q
        const float* L = sm.lse[s] + 32 * half;
        const float* Dl = sm.delta[s] + 32 * half;
        auto lse2 = [&](int, int n, int c) { return L[8 * n + 2 * t4 + c]; };
        auto dl = [&](int, int n, int c) { return Dl[8 * n + 2 * t4 + c]; };
        uint32_t pf[4][2], df[4][2];
        wg_wait<1>();
        fence_regs<16>(st);
        if (kind == FULL) {
          probs<false>(st, p.scale_log2, lse2, [](int, int, int) { return true; }, pf);
        } else {
          probs<true>(st, p.scale_log2, lse2,
                      [&](int i, int n, int c) {
                        const int key = key0 + 8 * i, qi = q0 + 32 * half + 8 * n + 2 * t4 + c;
                        return key < p.Sk && qi < p.Sq &&
                               sees(p.kv_offset + qi, key, p.causal, p.window);
                      },
                      pf);
        }
        fence_regs<DV / 2>(dV);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                                 pf[2 * kk + 1][1]};
          issue_rows_grad<DV>(dV, a, do_addr + (2 * half + kk) * 16 * 128);
        }
        wg_commit();
        wg_wait<1>();
        fence_regs<16>(dpt);
        dscores(st, dpt, dl, df);
        fence_regs<D / 2>(dK);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t a[4] = {df[2 * kk][0], df[2 * kk][1], df[2 * kk + 1][0],
                                 df[2 * kk + 1][1]};
          issue_rows_grad<D>(dK, a, q_addr + (2 * half + kk) * 16 * 128);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs<DV / 2>(dV);
        fence_regs<D / 2>(dK);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  store_rows<D>(dK, p.scale, [&](int i) -> bf16* {
    const int key = key0 + 8 * i;
    return key < p.Sk ? p.dk + b * p.dkst.b + kh * p.dkst.h + key * p.dkst.s : nullptr;
  });
  store_rows<DV>(dV, 1.f, [&](int i) -> bf16* {
    const int key = key0 + 8 * i;
    return key < p.Sk ? p.dv + b * p.dvst.b + kh * p.dvst.h + key * p.dvst.s : nullptr;
  });
}

// The row-split dQ (MLA, D = 160): 128-row blocks, warpgroup w owning rows
// [64 w, 64 w + 64): S = Q K^T and dP = dO V^T for its rows and the tile's
// 64 keys (m64n64k16, A its Q / dO rows, B the K / V tile, both K-major in
// shared memory), dS = P (dP - delta) in registers, and dQ += dS K with dS
// as register A fragments and K read MN-major (m64n{D}k16).  Registers a
// consumer thread: dQ D / 2, S and dP 32 each.  Shared memory: the block's
// Q / dO and ST stages of K / V (three at MLA, two at D = 160).  grid:
// ceil(Sq / 128) query blocks x H x B in wide_block's order; a causal head
// starts with its last rows.
template <int D, int DV, int ST>
struct alignas(1024) RowsDqSmem {
  static constexpr int CK = (D + 63) / 64, CV = (DV + 63) / 64;
  bf16 q[CK][BLOCK * 64];              // chunk c: [128 query rows][64 columns], swizzled
  bf16 dout[CV][BLOCK * 64];
  bf16 k[ST][CK][BN * 64];             // chunk c of a stage: [64 keys][64]
  bf16 v[ST][CV][BN * 64];
  uint64_t full[ST], empty[ST], qd_full;
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_rows_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map, const Params p) {
  constexpr int ST = WIDE_STAGES<RowsDqSmem, D, DV>;
  using Sm = RowsDqSmem<D, DV, ST>;
  constexpr int CK = Sm::CK, CV = Sm::CV;
  static_assert(D > 128 && D <= 192, "the row-split dQ kernel's D");
  auto& sm = smem<Sm>();
  int group, qb;
  wide_block(p.H * p.B, p.chunk, group, qb);
  const int n_qb = (int)gridDim.x / (p.H * p.B);
  const int q0 = (p.causal ? n_qb - 1 - qb : qb) * BLOCK;
  const int h = group % p.H, b = group / p.H;
  const int kh = h / (p.H / p.Kh);
  int kt_begin, kt_end;
  key_tiles(q0, min(BLOCK, p.Sq - q0), p.Sk, BN, p.causal, p.window, p.kv_offset, kt_begin,
            kt_end);
  const int n_iter = kt_end - kt_begin;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);
    }
    mbar_init(&sm.qd_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= CONSUMERS) {        // the producer warpgroup; one thread loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS || n_iter == 0) return;
    mbar_expect(&sm.qd_full, (CK + CV) * 2 * BOX);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < CK; ++c)
        tma_load4(reinterpret_cast<unsigned char*>(sm.q[c]) + r * BOX, &q_map, c * 64,
                  q0 + r * BN, h, b, &sm.qd_full);
#pragma unroll
      for (int c = 0; c < CV; ++c)
        tma_load4(reinterpret_cast<unsigned char*>(sm.dout[c]) + r * BOX, &do_map, c * 64,
                  q0 + r * BN, h, b, &sm.qd_full);
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % ST, key = (kt_begin + it) * BN;
      if (it >= ST) mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      mbar_expect(&sm.full[s], (CK + CV) * BOX);
#pragma unroll
      for (int c = 0; c < CK; ++c) tma_load4(sm.k[s][c], &k_map, c * 64, key, kh, b, &sm.full[s]);
#pragma unroll
      for (int c = 0; c < CV; ++c) tma_load4(sm.v[s][c], &v_map, c * 64, key, kh, b, &sm.full[s]);
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qw = q0 + wg * BM;           // this warpgroup's rows [qw, qw + 64)
  int row[2];                            // this lane's rows, their lse (log2 units), delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = qw + warp * 16 + g + 8 * i;
    const int64_t idx = ((int64_t)b * p.H + h) * p.Sq + row[i];
    lse2[i] = row[i] < p.Sq ? p.lse[idx] * attn::LOG2E : attn::inf_f32();
    dl[i] = row[i] < p.Sq ? p.delta[idx] : 0.f;
  }
  const uint32_t q_addr = smem_u32(sm.q) + wg * BM * 128;
  const uint32_t do_addr = smem_u32(sm.dout) + wg * BM * 128;
  float dQ[D / 2];                       // [64 rows x D] f32 in wgmma's layout
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dQ[i] = 0.f;
  if (n_iter > 0) mbar_wait(&sm.qd_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % ST, kt = kt_begin + it;
    mbar_wait(&sm.full[s], (it / ST) & 1);
    const int kind = tile_kind(qw, BM, kt * BN, BN, p.Sq, p.Sk, p.causal, p.window, p.kv_offset);
    if (kind != EMPTY) {
      const uint32_t k_addr = smem_u32(sm.k[s]), v_addr = smem_u32(sm.v[s]);
      float sc[32], dp[32];              // S = Q K^T, dP = dO V^T: query rows x keys
      wg_fence();
      issue_abt<D>(sc, q_addr, 2 * BOX, k_addr);
      wg_commit();
      issue_abt<DV>(dp, do_addr, 2 * BOX, v_addr);
      wg_commit();
      // P while dP is computed, then dS, then dQ += dS K: K read MN-major
      // where it lies
      auto l2 = [&](int i, int, int) { return lse2[i]; };
      auto d2 = [&](int i, int, int) { return dl[i]; };
      uint32_t pf[8][2], df[8][2];       // pf unused: dQ needs dS only
      wg_wait<1>();
      fence_regs<32>(sc);
      if (kind == FULL) {
        probs<false>(sc, p.scale_log2, l2, [](int, int, int) { return true; }, pf);
      } else {
        probs<true>(sc, p.scale_log2, l2,
                    [&](int i, int n, int c) {
                      const int key = kt * BN + 8 * n + 2 * t4 + c;
                      return key < p.Sk && row[i] < p.Sq &&
                             sees(p.kv_offset + row[i], key, p.causal, p.window);
                    },
                    pf);
      }
      wg_wait<0>();
      fence_regs<32>(dp);
      dscores(sc, dp, d2, df);
      fence_regs<D / 2>(dQ);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {df[2 * kk][0], df[2 * kk][1], df[2 * kk + 1][0],
                               df[2 * kk + 1][1]};
        issue_rows_grad<D>(dQ, a, k_addr + kk * 16 * 128);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs<D / 2>(dQ);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  store_rows<D>(dQ, p.scale, [&](int i) -> bf16* {
    return row[i] < p.Sq ? p.dq + b * p.dqst.b + h * p.dqst.h + row[i] * p.dqst.s : nullptr;
  });
}

template <int D>
constexpr size_t dkdv_smem() { return sizeof(DkdvSmem<D>) + 1024; }   // + the base's alignment
template <int D>
constexpr size_t dq_smem() { return sizeof(DqSmem<D>) + 1024; }

template <int D, int DV>
constexpr size_t wide_dkdv_smem() {
  return sizeof(WideDkdvSmem<D, DV, WIDE_STAGES<WideDkdvSmem, D, DV>>) + 1024;
}
template <int D, int DV>
constexpr size_t wide_dq_smem() {
  return sizeof(WideDqSmem<D, DV, WIDE_STAGES<WideDqSmem, D, DV>>) + 1024;
}
template <int D, int DV>
constexpr size_t rows_dq_smem() {
  return sizeof(RowsDqSmem<D, DV, WIDE_STAGES<RowsDqSmem, D, DV>>) + 1024;
}
template <int D, int DV>
constexpr size_t rows_dkdv_smem() {
  return sizeof(RowsDkdvSmem<D, DV, WIDE_STAGES<RowsDkdvSmem, D, DV>>) + 1024;
}
// The row-split kernels where the gradient's registers a thread leave room:
// dQ's D / 2 up to D = 192; dK and dV's (D + DV) / 2 at MLA's (192, 128)
// (at (160, 160), the same 160 registers, ptxas spills 52 bytes)
template <int D>
constexpr bool DQ_ROWS = D <= 192;
template <int D, int DV>
constexpr bool DKDV_ROWS = D <= 192 && DV <= 128;

// The shared-memory limits of the two kernels raised, once per process and
// instantiation
template <int D, int DV>
cudaError_t kernels_ready() {
  if constexpr (D <= 128) {
    static const cudaError_t a1 = attn::allow_smem(flash_bwd_dkdv_wgmma_kernel<D>, dkdv_smem<D>());
    static const cudaError_t a2 = attn::allow_smem(flash_bwd_dq_wgmma_kernel<D>, dq_smem<D>());
    return a1 != cudaSuccess ? a1 : a2;
  } else {
    cudaError_t a1, a2;
    if constexpr (DKDV_ROWS<D, DV>) {
      static_assert(rows_dkdv_smem<D, DV>() <= SMEM_MAX, "the row-split dK/dV's shared memory");
      static const cudaError_t a =
          attn::allow_smem(flash_bwd_dkdv_rows_wgmma_kernel<D, DV>, rows_dkdv_smem<D, DV>());
      a1 = a;
    } else {
      static_assert(wide_dkdv_smem<D, DV>() <= SMEM_MAX, "the wide body's shared memory");
      static const cudaError_t a =
          attn::allow_smem(flash_bwd_dkdv_wide_wgmma_kernel<D, DV>, wide_dkdv_smem<D, DV>());
      a1 = a;
    }
    if constexpr (DQ_ROWS<D>) {
      static_assert(rows_dq_smem<D, DV>() <= SMEM_MAX, "the row-split dQ's shared memory");
      static const cudaError_t a =
          attn::allow_smem(flash_bwd_dq_rows_wgmma_kernel<D, DV>, rows_dq_smem<D, DV>());
      a2 = a;
    } else {
      static_assert(wide_dq_smem<D, DV>() <= SMEM_MAX, "the wide body's shared memory");
      static const cudaError_t a =
          attn::allow_smem(flash_bwd_dq_wide_wgmma_kernel<D, DV>, wide_dq_smem<D, DV>());
      a2 = a;
    }
    return a1 != cudaSuccess ? a1 : a2;
  }
}

// The wide body's chunk (wide_block): as many of the n_groups groups as
// fit their streamed tiles (`bytes` each: Q and dO of a KV head's query
// heads, or K and V of a head) in 40 MB of the H100's 50 MB L2; all of
// them where they fit, so the grid is then one longest-first walk.
inline int wide_chunk(int64_t bytes, int n_groups) {
  return (int)std::max<int64_t>(1, std::min<int64_t>(n_groups, (int64_t(40) << 20) / bytes));
}

// The two kernels on q/k/v/dout (strides st[0], st[1], st[2], st[4]),
// writing dq/dk/dv (st[5], st[6], st[7]); delta already computed.  D <=
// 128 (DV = D) runs the narrow body, wider ones the wide body.
template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv,
                   const Strides* st, int B, int H, int Kh, int Sq, int Sk, int causal,
                   int window, int kv_offset, cudaStream_t s) {
  constexpr bool narrow = D <= 128;
  static_assert(!narrow || DV == D, "the narrow body takes DV = D");
  if (const cudaError_t e = kernels_ready<D, DV>()) return e;
  CUtensorMap qm, km, vm, dom;
  if (!heads_map(&qm, q, B, H, Sq, D, st[0].b, st[0].h, st[0].s, BN) ||
      !heads_map(&km, k, B, Kh, Sk, D, st[1].b, st[1].h, st[1].s, BN) ||
      !heads_map(&vm, v, B, Kh, Sk, DV, st[2].b, st[2].h, st[2].s, BN) ||
      !heads_map(&dom, dout, B, H, Sq, DV, st[4].b, st[4].h, st[4].s, BN))
    return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  Params p{lse, delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
           static_cast<bf16*>(dv), st[5], st[6], st[7], B, H, Kh, Sq, Sk, causal, window,
           kv_offset, scale, attn::LOG2E * scale, 0};
  if constexpr (narrow) {
    flash_bwd_dkdv_wgmma_kernel<D>
        <<<(unsigned)((Sk + BLOCK - 1) / BLOCK * Kh * B), THREADS, dkdv_smem<D>(), s>>>(
            qm, km, vm, dom, p);
    if (const cudaError_t e = cudaGetLastError()) return e;
    flash_bwd_dq_wgmma_kernel<D>
        <<<(unsigned)((Sq + BLOCK - 1) / BLOCK * H * B), THREADS, dq_smem<D>(), s>>>(
            qm, km, vm, dom, p);
  } else {
    p.chunk = wide_chunk((int64_t)(H / Kh) * Sq * (D + DV) * 2, Kh * B);
    if constexpr (DKDV_ROWS<D, DV>)
      flash_bwd_dkdv_rows_wgmma_kernel<D, DV>
          <<<(unsigned)((Sk + BLOCK - 1) / BLOCK * Kh * B), THREADS, rows_dkdv_smem<D, DV>(),
             s>>>(qm, km, vm, dom, p);
    else
      flash_bwd_dkdv_wide_wgmma_kernel<D, DV>
          <<<(unsigned)((Sk + BN - 1) / BN * Kh * B), THREADS, wide_dkdv_smem<D, DV>(), s>>>(
              qm, km, vm, dom, p);
    if (const cudaError_t e = cudaGetLastError()) return e;
    p.chunk = wide_chunk((int64_t)Sk * (D + DV) * 2, H * B);
    if constexpr (DQ_ROWS<D>)
      flash_bwd_dq_rows_wgmma_kernel<D, DV>
          <<<(unsigned)((Sq + BLOCK - 1) / BLOCK * H * B), THREADS, rows_dq_smem<D, DV>(), s>>>(
              qm, km, vm, dom, p);
    else
      flash_bwd_dq_wide_wgmma_kernel<D, DV>
          <<<(unsigned)((Sq + BN - 1) / BN * H * B), THREADS, wide_dq_smem<D, DV>(), s>>>(
              qm, km, vm, dom, p);
  }
  return cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// bf16 forward at the wide pairs: 128-row blocks on wgmma fed by a TMA ring
// ---------------------------------------------------------------------------
// flash_fwd_wgmma_kernel<D, DV> takes the bf16 calls at (D, DV) = (112,
// 112), (160, 160), MLA's (192, 128) and (256, 256) whose 128-row blocks
// need no split (ops.py's plan; its full-sequence calls: training's
// blockwise_attention and mla_full), and computes what the mma.sync tile
// computes there (the contract at the top of this file): the same walk
// of key tiles, the same mask, online softmax and P rounded to bf16 with
// l summing the rounded P.  The tile's bits are not kept (the products sum
// in another order).
//
// A block owns (b, h, 128 query rows) and runs attn_wgmma.cuh's body: two
// consumer warpgroups of 64 rows (wgattn::consume: S = Q K^T on wgmma
// m64n64k16 over the D real columns, the online softmax with a mask only
// on EDGE tiles and EMPTY tiles skipped, O += P V with P in registers and
// V read MN-major) and a producer warpgroup, one thread of which issues
// every copy: Q once, then K and V tiles of BN = 64 keys through the
// ring, from 4-D tensor maps over the tensors' own strides (heads_map:
// rows past Sq / Sk and columns past D read as zeros).  setmaxnreg gives
// the producer warpgroup's registers to the consumers (256 x 240 + 128 x
// 24).  Registers a consumer thread: O DV / 2 f32 (56, 80, 64, 128), S
// 32, P 16 bf16 pairs, the two rows' m and l.  Shared memory (1 block an
// SM): Q 128 x D bf16 in 64-column chunks (32, 48, 48, 64 KB) + ST stages
// of 64 x (D + DV) (32, 48, 40, 64 KB): ST = 4, 3, 4, 2 (160, 192, 208,
// 192 KB of the 227).  The grid runs in bwd::wide_block's order over (b,
// KV head) groups: chunks of groups whose K and V fit 40 MB of L2
// together, each chunk block-major, a causal head's last (longest) query
// blocks first.  Bound: operations, the two products (2 (D + DV) FLOP a
// visible pair) at the bf16 tensor-core peak, and one exponential a pair.
namespace fwd {

using namespace hopper;
using wgattn::BLOCK;
using wgattn::BM;
using wgattn::BN;
using wgattn::BOX;
using wgattn::CONSUMERS;
using wgattn::FwdSmem;

constexpr int THREADS = wgattn::THREADS;

// the pairs this body is built for; the rest run the mma.sync tile (attn_mma.cuh)
template <int D, int DV>
constexpr bool WIDE = (D == 112 && DV == 112) || (D == 160 && DV == 160) ||
                      (D == 192 && DV == 128) || (D == 256 && DV == 256);

struct Params {
  bf16* out;
  Strides ost;
  float* lse;                          // nullptr, or [B, H, Sq] f32
  int B, H, Kh, Sq, Sk, causal, window, kv_offset;
  float scale_log2;
  int chunk;                           // (b, KV head) groups a chunk of the grid (wide_block)
};

// grid: ceil(Sq / 128) query blocks x H x B in wide_block's order over
// the Kh x B (b, KV head) groups; a group's blocks are (query block,
// query head of the group), the query block slowest.  Step it is key
// tile kt_begin + it.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const Params p) {
  constexpr int ST = wgattn::FWD_STAGES<D, DV>;
  using Sm = FwdSmem<D, DV, ST>;
  constexpr int CK = Sm::CK, CV = Sm::CV;
  static_assert(WIDE<D, DV>, "the wgmma forward's widths");
  auto& sm = wgattn::smem<Sm>();
  const int G = p.H / p.Kh;
  int group, blk;
  bwd::wide_block(p.Kh * p.B, p.chunk, group, blk);
  const int n_qb = (p.Sq + BLOCK - 1) / BLOCK, qi = blk / G;
  const int q0 = (p.causal ? n_qb - 1 - qi : qi) * BLOCK;
  const int kh = group % p.Kh, b = group / p.Kh, h = kh * G + blk % G;
  int kt_begin, kt_end;
  key_tiles(q0, min(BLOCK, p.Sq - q0), p.Sk, BN, p.causal, p.window, p.kv_offset, kt_begin,
            kt_end);
  const int n_iter = kt_end - kt_begin;
  wgattn::ring_init<Sm, ST>(sm);

  if (threadIdx.x >= CONSUMERS) {        // the producer warpgroup; one thread loads
    setmaxnreg_dec<wgattn::PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS || n_iter == 0) return;
    mbar_expect(&sm.q_full, CK * 2 * BOX);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c)
        tma_load4(reinterpret_cast<unsigned char*>(sm.q[c]) + r * BOX, &q_map, c * 64,
                  q0 + r * BM, h, b, &sm.q_full);
    for (int it = 0; it < n_iter; ++it) {
      const int s = wgattn::stage_acquire<ST>(sm, it, (CK + CV) * BOX);
      const int key = (kt_begin + it) * BN;
#pragma unroll
      for (int c = 0; c < CK; ++c) tma_load4(sm.k[s][c], &k_map, c * 64, key, kh, b, &sm.full[s]);
#pragma unroll
      for (int c = 0; c < CV; ++c) tma_load4(sm.v[s][c], &v_map, c * 64, key, kh, b, &sm.full[s]);
    }
    return;
  }
  setmaxnreg_inc<wgattn::CONSUMER_REGS>();

  const int lane = threadIdx.x % 32, wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int t4 = lane % 4;
  const int qw = q0 + wg * BM;           // this warpgroup's rows [qw, qw + 64)
  const int row0 = qw + warp * 16 + lane / 4;   // this lane's rows: row0 and row0 + 8
  attn::RowState<DV> st;
  wgattn::consume<D, DV, ST>(sm, st, kt_begin, n_iter, qw, p.Sq, p.Sk, p.causal, p.window,
                             p.kv_offset, p.scale_log2);
  const float* const o = &st.acc[0][0];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
    if (p.lse != nullptr && t4 == 0)
      p.lse[((int64_t)b * p.H + h) * p.Sq + row] = row_lse(st.m[i] * attn::LN2, st.l[i]);
    bf16* out = p.out + b * p.ost.b + h * p.ost.h + row * p.ost.s + 2 * t4;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
  }
}

// The kernel on q/k/v (strides st[0], st[1], st[2]) writing out (st[3])
// and, when lse is not nullptr, each row's log-sum-exp; a pair it is not
// built for (WIDE) returns cudaErrorInvalidValue
template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const Strides* st,
                   int B, int H, int Kh, int Sq, int Sk, int causal, int window, int kv_offset,
                   float* lse, cudaStream_t s) {
  if constexpr (!WIDE<D, DV>) {
    return cudaErrorInvalidValue;
  } else {
    constexpr size_t smem = wgattn::fwd_smem_bytes<D, DV>();
    static_assert(smem <= wgattn::SMEM_MAX, "the wgmma forward's shared memory");
    static const cudaError_t attr = attn::allow_smem(flash_fwd_wgmma_kernel<D, DV>, smem);
    if (attr != cudaSuccess) return attr;
    // no key (Sk = 0): no tile is walked, so the maps' one row is never read
    const int rows_k = std::max(Sk, 1);
    CUtensorMap qm, km, vm;
    if (!heads_map(&qm, q, B, H, Sq, D, st[0].b, st[0].h, st[0].s, BN) ||
        !heads_map(&km, k, B, Kh, rows_k, D, st[1].b, st[1].h, st[1].s, BN) ||
        !heads_map(&vm, v, B, Kh, rows_k, DV, st[2].b, st[2].h, st[2].s, BN))
      return cudaErrorInvalidValue;
    const Params p{static_cast<bf16*>(out), st[3], lse, B, H, Kh, Sq, Sk, causal, window,
                   kv_offset, attn::LOG2E / sqrtf((float)D),
                   bwd::wide_chunk((int64_t)rows_k * (D + DV) * 2, Kh * B)};
    flash_fwd_wgmma_kernel<D, DV>
        <<<(unsigned)((Sq + BLOCK - 1) / BLOCK * H * B), THREADS, smem, s>>>(qm, km, vm, p);
    return cudaGetLastError();
  }
}

}  // namespace fwd

// f32: CUDA-core products.  128 threads; a block owns 32 keys (dK/dV) or
// 32 query rows (dQ) and steps over 32 rows of the other side, staged in
// shared memory as f32 rows padded by one (conflict-free column reads).
// Thread t computes 8 entries (row t / 4, columns t % 4 + 4c) of S and dP,
// then D / 4 (DV / 4 for dV) columns (t % 4 + 4c) of its row of the
// gradients.
constexpr int BT = 32;

template <int D, int DV>
constexpr size_t bwd_f32_smem() {
  return (size_t)(2 * BT * (D + 1) + 2 * BT * (DV + 1) + 2 * BT * (BT + 1) + 2 * BT) *
         sizeof(float);
}

// n rows of D floats from `src` (rows at or past `limit`: zeros) into
// shared rows of D + 1
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int64_t stride, int r0,
                                          int n, int limit) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < limit ? src[(r0 + r) * stride + c] : 0.f;
  }
}

// Each body is a device function under two kernels: __launch_bounds__(128)
// up to D = 128, and (128, 1) above, where the compiler's own register
// choice for the wider accumulators spilled (D = 160's dK/dV)
#define DKDV_F32_PARAMS                                                                      \
  const float *__restrict__ q, const float *__restrict__ k, const float *__restrict__ v,     \
      const float *__restrict__ dout, const float *__restrict__ lse,                         \
      const float *__restrict__ delta, float *__restrict__ dk, float *__restrict__ dv,       \
      Strides qst, Strides kst, Strides vst, Strides dost, Strides dkst, Strides dvst, int H, \
      int Kh, int Sq, int Sk, int causal, int window, int kv_offset, float scale
#define DKDV_F32_ARGS                                                                         \
  q, k, v, dout, lse, delta, dk, dv, qst, kst, vst, dost, dkst, dvst, H, Kh, Sq, Sk, causal, \
      window, kv_offset, scale
#define DQ_F32_PARAMS                                                                        \
  const float *__restrict__ q, const float *__restrict__ k, const float *__restrict__ v,     \
      const float *__restrict__ dout, const float *__restrict__ lse,                         \
      const float *__restrict__ delta, float *__restrict__ dq, Strides qst, Strides kst,     \
      Strides vst, Strides dost, Strides dqst, int H, int Kh, int Sq, int Sk, int causal,    \
      int window, int kv_offset, float scale
#define DQ_F32_ARGS                                                                          \
  q, k, v, dout, lse, delta, dq, qst, kst, vst, dost, dqst, H, Kh, Sq, Sk, causal, window, \
      kv_offset, scale

template <int D, int DV>
__device__ __forceinline__ void dkdv_f32(DKDV_F32_PARAMS) {
  constexpr int LF = D + 1, LV = DV + 1, LP = BT + 1;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BT * LF;
  float* Qs = Vs + BT * LV;
  float* dOs = Qs + BT * LF;
  float* Ps = dOs + BT * LV;     // [key][query] P^T
  float* dSs = Ps + BT * LP;     // [key][query] dS^T
  float* Ls = dSs + BT * LP;
  float* Dls = Ls + BT;

  const int tid = threadIdx.x, jr = tid / 4, cc = tid % 4;
  const int k0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z, G = H / Kh;
  stage_f32<D>(Ks, k + b * kst.b + kh * kst.h, kst.s, k0, BT, Sk);
  stage_f32<DV>(Vs, v + b * vst.b + kh * vst.h, vst.s, k0, BT, Sk);
  int q_lo, q_hi;
  query_range(k0, BT, Sq, causal, window, kv_offset, q_lo, q_hi);
  const int key = k0 + jr;

  float aK[D / 4], aV[DV / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) aK[c] = 0.f;
#pragma unroll
  for (int c = 0; c < DV / 4; ++c) aV[c] = 0.f;
  for (int gh = 0; gh < G; ++gh) {
    const int h = kh * G + gh;
    for (int q0 = q_lo / BT * BT; q0 < q_hi; q0 += BT) {
      __syncthreads();   // the previous step's readers are done
      stage_f32<D>(Qs, q + b * qst.b + h * qst.h, qst.s, q0, BT, Sq);
      stage_f32<DV>(dOs, dout + b * dost.b + h * dost.h, dost.s, q0, BT, Sq);
      if (tid < BT) {
        const int i = q0 + tid;
        const int64_t row = ((int64_t)b * H + h) * Sq + i;
        Ls[tid] = i < Sq ? lse[row] : attn::inf_f32();
        Dls[tid] = i < Sq ? delta[row] : 0.f;
      }
      __syncthreads();
      float s[8], dp[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) s[c] = dp[c] = 0.f;
      if constexpr (DV == D) {
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float kx = Ks[jr * LF + d], vx = Vs[jr * LF + d];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            s[c] = fmaf(kx, Qs[(cc + 4 * c) * LF + d], s[c]);
            dp[c] = fmaf(vx, dOs[(cc + 4 * c) * LF + d], dp[c]);
          }
        }
      } else {
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float kx = Ks[jr * LF + d];
#pragma unroll
          for (int c = 0; c < 8; ++c) s[c] = fmaf(kx, Qs[(cc + 4 * c) * LF + d], s[c]);
        }
#pragma unroll 4
        for (int d = 0; d < DV; ++d) {
          const float vx = Vs[jr * LV + d];
#pragma unroll
          for (int c = 0; c < 8; ++c) dp[c] = fmaf(vx, dOs[(cc + 4 * c) * LV + d], dp[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = cc + 4 * c, qi = q0 + i;
        const bool vis = key < Sk && qi < Sq && sees(kv_offset + qi, key, causal, window);
        const float p = vis ? expf(s[c] * scale - Ls[i]) : 0.f;
        Ps[jr * LP + i] = p;
        dSs[jr * LP + i] = p * (dp[c] - Dls[i]);
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        const float p = Ps[jr * LP + i], d = dSs[jr * LP + i];
        if constexpr (DV == D) {
#pragma unroll
          for (int c = 0; c < D / 4; ++c) {
            aV[c] = fmaf(p, dOs[i * LF + cc + 4 * c], aV[c]);
            aK[c] = fmaf(d, Qs[i * LF + cc + 4 * c], aK[c]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < DV / 4; ++c) aV[c] = fmaf(p, dOs[i * LV + cc + 4 * c], aV[c]);
#pragma unroll
          for (int c = 0; c < D / 4; ++c) aK[c] = fmaf(d, Qs[i * LF + cc + 4 * c], aK[c]);
        }
      }
    }
  }
  if (key < Sk) {
    float* ok = dk + b * dkst.b + kh * dkst.h + key * dkst.s;
    float* ov = dv + b * dvst.b + kh * dvst.h + key * dvst.s;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) ok[cc + 4 * c] = aK[c] * scale;
#pragma unroll
    for (int c = 0; c < DV / 4; ++c) ov[cc + 4 * c] = aV[c];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_f32_kernel(DKDV_F32_PARAMS) {
  dkdv_f32<D, DV>(DKDV_F32_ARGS);
}
template <int D, int DV>
__global__ void __launch_bounds__(128, 1) flash_bwd_dkdv_f32_wide_kernel(DKDV_F32_PARAMS) {
  dkdv_f32<D, DV>(DKDV_F32_ARGS);
}

template <int D, int DV>
__device__ __forceinline__ void dq_f32(DQ_F32_PARAMS) {
  constexpr int LF = D + 1, LV = DV + 1, LP = BT + 1;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BT * LF;
  float* Ks = dOs + BT * LV;
  float* Vs = Ks + BT * LF;
  float* dSs = Vs + BT * LV;     // [query][key] dS

  const int tid = threadIdx.x, ir = tid / 4, cc = tid % 4;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, kh = h / (H / Kh);
  stage_f32<D>(Qs, q + b * qst.b + h * qst.h, qst.s, q0, BT, Sq);
  stage_f32<DV>(dOs, dout + b * dost.b + h * dost.h, dost.s, q0, BT, Sq);
  const int qi = q0 + ir;
  const int64_t row = ((int64_t)b * H + h) * Sq + qi;
  const float L = qi < Sq ? lse[row] : attn::inf_f32(), Dl = qi < Sq ? delta[row] : 0.f;
  int kt_begin, kt_end;
  key_tiles(q0, min(BT, Sq - q0), Sk, BT, causal, window, kv_offset, kt_begin, kt_end);

  float aQ[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) aQ[c] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // Q and dO staged / the previous tile's readers done
    stage_f32<D>(Ks, k + b * kst.b + kh * kst.h, kst.s, k0, BT, Sk);
    stage_f32<DV>(Vs, v + b * vst.b + kh * vst.h, vst.s, k0, BT, Sk);
    __syncthreads();
    float s[8], dp[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] = dp[c] = 0.f;
    if constexpr (DV == D) {
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qx = Qs[ir * LF + d], ox = dOs[ir * LF + d];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[c] = fmaf(qx, Ks[(cc + 4 * c) * LF + d], s[c]);
          dp[c] = fmaf(ox, Vs[(cc + 4 * c) * LF + d], dp[c]);
        }
      }
    } else {
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qx = Qs[ir * LF + d];
#pragma unroll
        for (int c = 0; c < 8; ++c) s[c] = fmaf(qx, Ks[(cc + 4 * c) * LF + d], s[c]);
      }
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        const float ox = dOs[ir * LV + d];
#pragma unroll
        for (int c = 0; c < 8; ++c) dp[c] = fmaf(ox, Vs[(cc + 4 * c) * LV + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = cc + 4 * c, key = k0 + j;
      const bool vis = key < Sk && qi < Sq && sees(kv_offset + qi, key, causal, window);
      const float p = vis ? expf(s[c] * scale - L) : 0.f;
      dSs[ir * LP + j] = p * (dp[c] - Dl);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float d = dSs[ir * LP + j];
#pragma unroll
      for (int c = 0; c < D / 4; ++c) aQ[c] = fmaf(d, Ks[j * LF + cc + 4 * c], aQ[c]);
    }
  }
  if (qi < Sq) {
    float* o = dq + b * dqst.b + h * dqst.h + qi * dqst.s;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) o[cc + 4 * c] = aQ[c] * scale;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32_kernel(DQ_F32_PARAMS) {
  dq_f32<D, DV>(DQ_F32_ARGS);
}
template <int D, int DV>
__global__ void __launch_bounds__(128, 1) flash_bwd_dq_f32_wide_kernel(DQ_F32_PARAMS) {
  dq_f32<D, DV>(DQ_F32_ARGS);
}
#undef DKDV_F32_PARAMS
#undef DKDV_F32_ARGS
#undef DQ_F32_PARAMS
#undef DQ_F32_ARGS

// The f32 pair of kernels up to D = 128, or above
template <int D, int DV>
cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                           const float* lse, const float* delta, float* dq, float* dk,
                           float* dv, const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                           int causal, int window, int kv_offset, cudaStream_t s) {
  const float scale = 1.0f / sqrtf((float)D);
  constexpr size_t smem = bwd_f32_smem<D, DV>();
  const auto run = [&](auto dkdv_kernel, auto dq_kernel) {
    static const cudaError_t a1 = attn::allow_smem(dkdv_kernel, smem);
    static const cudaError_t a2 = attn::allow_smem(dq_kernel, smem);
    if (a1 != cudaSuccess) return a1;
    if (a2 != cudaSuccess) return a2;
    dkdv_kernel<<<dim3((Sk + BT - 1) / BT, Kh, B), 128, smem, s>>>(
        q, k, v, dout, lse, delta, dk, dv, st[0], st[1], st[2], st[4], st[6], st[7], H, Kh,
        Sq, Sk, causal, window, kv_offset, scale);
    if (const cudaError_t e = cudaGetLastError()) return e;
    dq_kernel<<<dim3((Sq + BT - 1) / BT, H, B), 128, smem, s>>>(
        q, k, v, dout, lse, delta, dq, st[0], st[1], st[2], st[4], st[5], H, Kh, Sq, Sk,
        causal, window, kv_offset, scale);
    return cudaGetLastError();
  };
  if constexpr (D <= 128)
    return run(flash_bwd_dkdv_f32_kernel<D, DV>, flash_bwd_dq_f32_kernel<D, DV>);
  else
    return run(flash_bwd_dkdv_f32_wide_kernel<D, DV>, flash_bwd_dq_f32_wide_kernel<D, DV>);
}

// Strides, in order: q, k, v, out, dout, dq, dk, dv
template <typename T, int D, int DV>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                       int causal, int window, int kv_offset, cudaStream_t s) {
  const int64_t rows = (int64_t)B * H * Sq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, st[3], st[4], H, Sq, DV,
      rows);
  if (const cudaError_t e = cudaGetLastError()) return e;
  if constexpr (std::is_same<T, bf16>::value) {
    return bwd::launch<D, DV>(q, k, v, dout, lse, delta, dq, dk, dv, st, B, H, Kh, Sq, Sk, causal,
                          window, kv_offset, s);
  } else {
    return launch_bwd_f32<D, DV>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), st, B, H, Kh, Sq, Sk, causal, window, kv_offset, s);
  }
}

void unpack(const int64_t* strides, Strides* st, int n) {
  for (int i = 0; i < n; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// The split kernel's scratch: one f32 buffer of n_split * B * H * Sq *
// (DV + 2) values, m [n_split, B, H, Sq], then l (the same shape), then acc
// [n_split, B, H, Sq, DV].
struct Parts {
  float *m, *l, *acc;
  Parts(void* buf, int n_split, int B, int H, int Sq) {
    const int64_t n = (int64_t)n_split * B * H * Sq;
    m = static_cast<float*>(buf);
    l = m != nullptr ? m + n : nullptr;
    acc = m != nullptr ? l + n : nullptr;
  }
};

// The (D, DV) pairs every body is built for; X(D, DV) for each
#define FLASH_HEAD_DIMS(X) X(64, 64) X(112, 112) X(128, 128) X(160, 160) X(192, 128) X(256, 256)

int run(const void* q, const void* k, const void* v, void* out, int dtype, int B, int H,
        int Kh, int Sq, int Sk, int D, int DV, int causal, int window, int kv_offset,
        const int64_t* strides, int rows, int n_split, void* parts, unsigned* counters,
        float* lse, cudaStream_t s) {
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  if (Kh <= 0 || H % Kh != 0) return (int)cudaErrorInvalidValue;
  Strides st[4];
  unpack(strides, st, 4);
  if (dtype == 1 && n_split > 1 && parts == nullptr) return (int)cudaErrorInvalidValue;
  const Parts P(parts, n_split, B, H, Sq);
#define FLASH_FWD(DD, DDV)                                                                   \
  if (D == DD && DV == DDV) {                                                                \
    if (dtype == 0)                                                                          \
      return (int)launch_f32<DD, DDV>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,    \
                                      kv_offset, lse, s);                                    \
    if (dtype == 1 && rows == fwd::BLOCK)                                                    \
      return n_split == 1 ? (int)fwd::launch<DD, DDV>(q, k, v, out, st, B, H, Kh, Sq, Sk,    \
                                                      causal, window, kv_offset, lse, s)     \
                          : (int)cudaErrorInvalidValue;                                      \
    if (dtype == 1)                                                                          \
      return (int)launch_mma<DD, DDV>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,    \
                                      kv_offset, rows, n_split, P.m, P.l, P.acc, counters,   \
                                      lse, s);                                               \
  }
  FLASH_HEAD_DIMS(FLASH_FWD)
#undef FLASH_FWD
  return (int)cudaErrorInvalidValue;
}

int run_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
            const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int B,
            int H, int Kh, int Sq, int Sk, int D, int DV, int causal, int window,
            int kv_offset, const int64_t* strides, cudaStream_t s) {
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  if (Kh <= 0 || H % Kh != 0) return (int)cudaErrorInvalidValue;
  Strides st[8];
  unpack(strides, st, 8);
#define FLASH_BWD(DD, DDV)                                                                  \
  if (D == DD && DV == DDV) {                                                               \
    if (dtype == 0)                                                                         \
      return (int)launch_bwd<float, DD, DDV>(q, k, v, out, dout, lse, delta, dq, dk, dv,    \
                                             st, B, H, Kh, Sq, Sk, causal, window,          \
                                             kv_offset, s);                                 \
    if (dtype == 1)                                                                         \
      return (int)launch_bwd<bf16, DD, DDV>(q, k, v, out, dout, lse, delta, dq, dk, dv, st, \
                                            B, H, Kh, Sq, Sk, causal, window, kv_offset,    \
                                            s);                                             \
  }
  FLASH_HEAD_DIMS(FLASH_BWD)
#undef FLASH_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  (D, DV): q/k's and v/out's
// head dims, a pair of FLASH_HEAD_DIMS.  strides: 12 int64 values, the
// (batch, head, sequence) strides in elements of q, k, v and out, in that
// order.  bf16 only: rows (16 or 64) is the mma.sync tile's query tile, and
// n_split > 1 splits the keys into that many ranges of ceil(tiles /
// n_split) whole 64-key tiles, whose f32 partials go to parts (see Parts)
// and are merged into out in the same launch, with one counter of
// counters (B * H * ceil(Sq / rows) of them, zero, left zero; see
// attn_merge.cuh) per output tile; rows = 128 (n_split 1) runs the wgmma
// body (fwd::flash_fwd_wgmma_kernel) at the pairs it is built for
// (fwd::WIDE; any other pair returns cudaErrorInvalidValue).  f32 ignores
// rows, n_split, parts and counters.  lse: nullptr, or contiguous f32 [B, H, Sq] that gets each
// row's log-sum-exp of its scaled, masked scores (+inf for a row that sees
// no key), which the backward reads.  Each returns a
// cudaError_t, checked after every launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int B, int H, int Kh, int Sq, int Sk, int D, int DV,
                               int causal, int window, int kv_offset,
                               const int64_t* strides, int rows, int n_split,
                               void* parts, void* counters, void* lse, void* stream) {
  return run(q, k, v, out, dtype, B, H, Kh, Sq, Sk, D, DV, causal, window, kv_offset, strides,
             rows, n_split, parts, static_cast<unsigned*>(counters), static_cast<float*>(lse),
             static_cast<cudaStream_t>(stream));
}

// Blocks of the bf16 kernel with query tile `rows` (16 or 64) at head dims
// (D, DV) (a pair of FLASH_HEAD_DIMS) that one SM holds at once (shared
// memory, registers and threads, from the occupancy calculator), into
// *blocks: the planner's wave.  Returns a cudaError_t.
extern "C" int flash_blocks_per_sm(int rows, int D, int DV, int* blocks) {
  const auto ask = [&](auto kernel, cudaError_t ready, int threads, size_t smem) {
    if (ready != cudaSuccess) return (int)ready;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  };
#define FLASH_OCC(DD, DDV)                                                              \
  if (D == DD && DV == DDV) {                                                           \
    if (rows == 16)                                                                     \
      return ask(flash_mma_kernel<DD, 1, DDV>, tile_ready<DD, 1, DDV>(), 32,            \
                 attn::Cfg<DD, DDV>::smem_bytes(16));                                   \
    if (rows == 64)                                                                     \
      return ask(flash_mma_kernel<DD, 4, DDV>, tile_ready<DD, 4, DDV>(), 128,           \
                 attn::Cfg<DD, DDV>::smem_bytes(64));                                   \
  }
  FLASH_HEAD_DIMS(FLASH_OCC)
#undef FLASH_OCC
  return (int)cudaErrorInvalidValue;
}

// The gradient of flash_attention (same mask, GQA and head dims): q/dq [B,
// H, Sq, D], out/dout [B, H, Sq, DV], k/dk [B, Kh, Sk, D], v/dv [B, Kh,
// Sk, DV] of type dtype, addressed through
// strides (24 int64 values: the (batch, head, sequence) strides in elements
// of q, k, v, out, dout, dq, dk and dv, in that order; head dim
// contiguous, bf16 rows 16-byte aligned); lse [B, H, Sq] f32 from the
// forward; delta: f32 scratch of B * H * Sq values.  dq, dk and dv are
// written whole (zero for rows and keys nothing reaches).  Launches three
// kernels on stream; returns a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int dtype, int B,
                                   int H, int Kh, int Sq, int Sk, int D, int DV, int causal,
                                   int window, int kv_offset, const int64_t* strides,
                                   void* stream) {
  return run_bwd(q, k, v, out, dout, static_cast<const float*>(lse),
                 static_cast<float*>(delta), dq, dk, dv, dtype, B, H, Kh, Sq, Sk, D, DV, causal,
                 window, kv_offset, strides, static_cast<cudaStream_t>(stream));
}
