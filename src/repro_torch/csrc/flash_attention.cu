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
// Layouts: q/out [B, H, Sq, D], k/v [B, Kh, Sk, D], addressed through the
// (batch, head, sequence) strides in elements the caller passes, the last
// dimension contiguous; so a [B, S, H, D] projection viewed as [B, H, S, D]
// is read and written in place.  D = 64 or 128.
//
// The TPU grid walks (b, h, q block, kv block) with the kv block innermost
// and the softmax state carried in VMEM scratch across grid steps.  CUDA
// blocks run in no order, so a block owns (b, h, a tile of query rows) and
// loops over tiles of 64 keys.  Two bodies, chosen by the input type:
//
// - bf16: the tensor-core tile of attn_mma.cuh (mma.sync, bf16 K/V staged
//   by cp.async in a ring, online softmax in registers), blocks of one
//   warp of 16 rows or four warps of 16 rows, as the wrapper's plan says.  Short query tiles (decode rows,
//   whisper's prefill chunks) would leave most SMs idle with one block per
//   (b, h), so the plan splits the keys into n_split ranges of whole tiles
//   (split-KV): each block then writes f32 partials (m, l, acc) of its
//   range to scratch, and the last of a (b, h, query tile)'s split blocks
//   to finish combines them by log-sum-exp (partials with l = 0, ranges
//   that saw no key, weigh nothing) into out, in the same launch
//   (attn_merge.cuh's arrive_last; a one-warp tile then runs merge_rows,
//   a four-warp tile folds the other splits into the state its lanes
//   hold).  The plan keeps every block in one wave.  Blocks are ordered
//   with the split slowest.
// - f32: CUDA-core products in f32, by design, not as a fallback: the
//   port's f32 model checks hold the card to the CPU within 2e-4 and the
//   f32 kernel checks to 1e-4, which TF32 or bf16 tensor-core products
//   would break.  128 threads stage K^T and V of a tile in shared memory
//   as f32, and each thread computes a TM x 4 patch of the scores and a
//   TM x D/16 patch of the output (16 threads share a row group: row max
//   and sum are half-warp shuffles).  TM shrinks from 8 towards 1 while the
//   grid would not fill the card once.
//
// Both skip tiles wholly after the tile's last causal key or before its
// first window key.  Bound: operations for long sequences (4 * Sq * Sk * D
// per head on the tensor cores, and Sq * Sk exponentials), bytes for short
// query tiles (each K/V row is read once per query tile).
//
// Training: both bodies (and the split path's merge) can also write each
// row's log-sum-exp, and flash_attention_bwd computes the gradient from it
// (see "Backward" below).  The JAX package has no Pallas backward: it
// differentiates its jnp attention (repro/models/layers.py,
// blockwise_attention) with jax.value_and_grad.
#include "attn_mma.cuh"
#include "attn_merge.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
  __device__ const bf16* k_at(int j) const { return k_base + j * ks; }
  __device__ const bf16* v_at(int j) const { return v_base + j * vs; }
};

// grid (n_qt * n_split, H, B), read in launch order as (split, b, h, query
// tile), split slowest; block 32 * NW, 16 rows per warp.  part_m ==
// nullptr: one range, out written; else split s covers key tiles
// [s * split_tiles, (s + 1) * split_tiles) and writes partials [n_split, B,
// H, Sq] (m in natural units, l) and [n_split, B, H, Sq, D], and the last
// split block of the (b, h, query tile) merges the
// tile's rows into out, with the tile's counter in `counters`.
// A block whose range holds no key runs no tile and writes l = 0: it
// still counts in.
template <int D, int NW>
__global__ void __launch_bounds__(32 * NW, D == 128 ? 2 : 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, Strides qst,
                 Strides kst, Strides vst, Strides ost, int H, int Kh, int Sq, int Sk,
                 int causal, int window, int kv_offset, float scale_log2, int n_qt,
                 int split_tiles, float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, unsigned* __restrict__ counters,
                 float* __restrict__ lse) {
  constexpr int BK = attn::Cfg<D>::BK;
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

  attn::RowState<D> st;
  attn::attend<D, NW>(P, kt_begin, kt_end, scale_log2, st,
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
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) = __floats2bfloat162_rn(
            st.acc[n][2 * half] * inv, st.acc[n][2 * half + 1] * inv);
    } else {
      const int64_t row = (((int64_t)split * gridDim.z + b) * H + h) * Sq + i;
      if (tig == 0) {
        part_m[row] = st.l[half] > 0.f ? st.m[half] * attn::LN2 : NEG_INF;
        part_l[row] = st.l[half];
      }
      float* a = part_acc + row * D + 2 * tig;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
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
    attn::merge_rows<bf16, D>(
        part_m, part_l, part_acc, n_rows, row0, P.rows_valid, n_split,
        [&](int r) { return out + b * ost.b + h * ost.h + (q0 + r) * ost.s; }, lse);
  } else {
    // 64 rows: one block pulling every chunk of them through merge_rows
    // pays a chain of round trips to L2 per thread.  Instead each lane
    // folds the other splits' partials of the two rows and D / 4 columns
    // that it already holds (its own split's, in registers) into its own
    // softmax state, all of a split's loads for both rows in flight at
    // once, and writes out as an unsplit block does.
    float M[2], L[2];
    int64_t row[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = min(q0 + r0 + g + 8 * half, Sq - 1);    // rows past Sq: not written
      row[half] = ((int64_t)b * H + h) * Sq + i;
      M[half] = st.l[half] > 0.f ? st.m[half] * attn::LN2 : NEG_INF;
      L[half] = st.l[half];
    }
#pragma unroll 2
    for (int s = 0; s < n_split; ++s) {
      if (s == split) continue;
      float ls[2], ms[2];
      float2 x[2][D / 8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t pr = s * n_rows + row[half];
        ls[half] = __ldcg(part_l + pr);
        ms[half] = __ldcg(part_m + pr);
        const float* a = part_acc + pr * D + 2 * tig;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          x[half][n] = __ldcg(reinterpret_cast<const float2*>(a + 8 * n));
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const bool seen = ls[half] > 0.f;  // a split that saw no key weighs nothing
        const float Mn = seen ? fmaxf(M[half], ms[half]) : M[half];
        const float sc = expf(M[half] - Mn), w = seen ? expf(ms[half] - Mn) : 0.f;
        L[half] = fmaf(w, ls[half], L[half] * sc);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          st.acc[n][2 * half] = fmaf(w, x[half][n].x, st.acc[n][2 * half] * sc);
          st.acc[n][2 * half + 1] = fmaf(w, x[half][n].y, st.acc[n][2 * half + 1] * sc);
        }
        M[half] = Mn;
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
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) = __floats2bfloat162_rn(
            st.acc[n][2 * half] * inv, st.acc[n][2 * half + 1] * inv);
    }
  }
}

// The shared-memory limit of the bf16 kernel raised to what its tile
// needs, once per process and instantiation.
template <int D, int NW>
cudaError_t tile_ready() {
  static const cudaError_t attr =
      attn::allow_smem(flash_mma_kernel<D, NW>, attn::Cfg<D>::smem_bytes(16 * NW));
  return attr;
}

template <int D, int NW>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* out,
                        const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                        int causal, int window, int kv_offset, int n_split, float* pm,
                        float* pl, float* pacc, unsigned* counters, float* lse,
                        cudaStream_t stream) {
  using C = attn::Cfg<D>;
  constexpr int rows = 16 * NW;
  if (const cudaError_t attr = tile_ready<D, NW>()) return attr;
  const int n_qt = (Sq + rows - 1) / rows;
  const int tiles = (Sk + C::BK - 1) / C::BK;
  const int split_tiles = n_split > 1 ? (tiles + n_split - 1) / n_split : tiles;
  const dim3 grid(n_qt * n_split, H, B);
  flash_mma_kernel<D, NW><<<grid, 32 * NW, C::smem_bytes(rows), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), st[0], st[1], st[2], st[3],
      H, Kh, Sq, Sk, causal, window, kv_offset, attn::LOG2E / sqrtf((float)D), n_qt,
      split_tiles, n_split > 1 ? pm : nullptr, pl, pacc, counters, lse);
  return cudaGetLastError();
}

// rows: 16 (one warp) or 64 (four warps)
template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                       int causal, int window, int kv_offset, int rows, int n_split,
                       float* pm, float* pl, float* pacc, unsigned* counters, float* lse,
                       cudaStream_t stream) {
  if (n_split < 1 ||
      (n_split > 1 && (pm == nullptr || pl == nullptr || pacc == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (rows == 16)
    return launch_tile<D, 1>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
                             kv_offset, n_split, pm, pl, pacc, counters, lse, stream);
  if (rows == 64)
    return launch_tile<D, 4>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
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

template <int D, int TM>
constexpr size_t smem_bytes() {
  return (size_t)(D * (8 * TM + PAD) + D * (BK + PAD) + BK * D +
                  8 * TM * (BK + PAD)) * sizeof(float);
}

template <int D, int TM>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, Strides qst,
             Strides kst, Strides vst, Strides ost, int H, int Kh, int Sq, int Sk,
             int causal, int window, int kv_offset, float scale,
             float* __restrict__ lse) {
  constexpr int BQ = 8 * TM;
  constexpr int BQP = BQ + PAD;
  constexpr int BKP = BK + PAD;
  constexpr int DC = D / 16;          // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [D][BQP]  Q^T
  float* Ks = Qs + D * BQP;                      // [D][BKP]  K^T
  float* Vs = Ks + D * BKP;                      // [BK][D]
  float* Ps = Vs + BK * D;                       // [BQ][BKP] probabilities

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
        load_vec<DC>(Vs + (j + jj) * D + tx * DC, vv);
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

template <int D, int TM>
cudaError_t launch_tm(const void* q, const void* k, const void* v, void* out,
                      const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                      int causal, int window, int kv_offset, float* lse,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, TM>();
  static const cudaError_t attr = attn::allow_smem(flash_kernel<D, TM>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + 8 * TM - 1) / (8 * TM), H, B);
  flash_kernel<D, TM><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), st[0], st[1], st[2], st[3],
      H, Kh, Sq, Sk, causal, window, kv_offset, 1.0f / sqrtf((float)D), lse);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                       int causal, int window, int kv_offset, float* lse,
                       cudaStream_t stream) {
  // the largest row tile whose grid still covers every SM once
  const int sms = attn::sm_count();
  int tm = 8;
  while (tm > 1 && (int64_t)B * H * ((Sq + 8 * tm - 1) / (8 * tm)) < sms) tm /= 2;
  switch (tm) {
    case 8: return launch_tm<D, 8>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse, stream);
    case 4: return launch_tm<D, 4>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse, stream);
    case 2: return launch_tm<D, 2>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse, stream);
    default: return launch_tm<D, 1>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse, stream);
  }
}

// ---------------------------------------------------------------------------
// Backward: dQ, dK, dV from q, k, v, out, dout and the forward's lse
// ---------------------------------------------------------------------------
//
// P is recomputed from Q, K and each row's log-sum-exp (P = exp(S * scale -
// lse), exactly 0 where the mask hides the key or the row saw none), so
// nothing of size Sq x Sk is kept from the forward.  Three launches on the
// caller's stream:
//   1. delta = rowsum(dO * O) in f32, one warp a row;
//   2. dK and dV: one block owns (b, KV head, a tile of keys) and walks the
//      G query heads of that KV head and, for each, the query tiles the mask
//      lets see the key tile, accumulating dV += P^T dO and dK += dS^T Q
//      (dS = P * (dP - delta), dP = dO V^T) in registers: no atomics, and
//      GQA's sum over the G heads happens in the block;
//   3. dQ: one block owns (b, head, a tile of query rows) and walks the key
//      tiles as the forward does, accumulating dQ += dS K.
// S and dP are computed in both 2 and 3: seven products where one kernel
// with atomic adds into dQ would do five, for gradients that are the same
// on every run.  bf16: mma.sync m16n8k16 (f32 accumulators) on tiles
// staged by cp.async, P and dS rounded to bf16 as the A operands of their
// products, as the forward rounds P.  f32: CUDA-core products in f32, as
// the forward's f32 body (the f32 training checks hold the card to the CPU
// within 1e-4).  Bound: operations (the five products, 10 * pairs * D, on
// the tensor cores at bf16).

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

__device__ __forceinline__ bool sees(int qpos, int key, int causal, int window) {
  return (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// The query rows [lo, hi) that can see a key of [k0, k0 + n): none when
// hi <= lo.
__device__ __forceinline__ void query_range(int k0, int n, int Sq, int causal, int window,
                                            int kv_offset, int& lo, int& hi) {
  lo = causal ? max(0, k0 - kv_offset) : 0;
  hi = window > 0 ? min(Sq, k0 + n - 1 + window - kv_offset) : Sq;
}

// The key tiles [kt_begin, kt_end) of `bk` keys that query rows [q0, q0 +
// rows) can see, as the forward walks them.
__device__ __forceinline__ void key_tiles(int q0, int rows, int Sk, int bk, int causal,
                                          int window, int kv_offset, int& kt_begin,
                                          int& kt_end) {
  const int q_lo = kv_offset + q0, q_hi = kv_offset + q0 + rows - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  kt_begin = k_begin / bk;
  kt_end = k_end > k_begin ? (k_end + bk - 1) / bk : kt_begin;
}

// bf16 tiles: 4 warps of 16 rows; dK/dV blocks own 64 keys and step over
// BQ query rows, dQ blocks own 64 query rows and step over 64 keys.
template <int D>
struct BwdCfg {
  static constexpr int ROWS = 64;                 // a block's own rows
  static constexpr int BQ = D <= 64 ? 64 : 32;    // dK/dV: query rows a step
  static constexpr int BK = 64;                   // dQ: keys a step
  static constexpr int LD = D + 8;                // padded row, as attn_mma.cuh's
  static constexpr size_t dkdv_smem() {
    return (size_t)(2 * ROWS + 4 * BQ) * LD * sizeof(bf16) + 4 * BQ * sizeof(float);
  }
  static constexpr size_t dq_smem() { return (size_t)(2 * ROWS + 4 * BK) * LD * sizeof(bf16); }
};

// n rows of D bf16 from `src` (row stride `stride`; rows at or past
// `limit` zero-filled) into shared rows of D + 8, 16 bytes a copy
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int64_t stride, int r0,
                                           int n, int limit) {
  constexpr int CH = D / 8, LD = D + 8;
  for (int i = threadIdx.x; i < n * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < limit;
    attn::cp_async16(dst + r * LD + c * 8, ok ? src + (r0 + r) * stride + c * 8 : src, ok);
  }
}

// acc[16 x N] += A B^T: A's 16 rows at `a` and B's N rows at `bm`, both
// [.][D] in shared memory
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const bf16* a, const bf16* bm,
                                        int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    attn::ldsm_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t bf[4];
      attn::ldsm_x4(bf, bm + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
      attn::mma16816(acc[2 * nn], af, bf[0], bf[1]);
      attn::mma16816(acc[2 * nn + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16 x D] += P B: P [16 x K] as bf16 pairs in its C-fragment layout
// (the A-fragments, in registers), B's K rows [K][D] in shared memory
template <int D, int K>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const uint32_t (&p)[K / 8][2],
                                       const bf16* bm, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t bf[4];
      attn::ldsm_x4_t(bf, bm + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dd * 16 +
                              (lane >> 4) * 8);
      attn::mma16816(acc[2 * dd], a, bf[0], bf[1]);
      attn::mma16816(acc[2 * dd + 1], a, bf[2], bf[3]);
    }
  }
}

// A lane's two rows (g and g + 8 of its warp's 16) of a [16 x D] f32
// accumulator, times `scale`, as bf16 at row(half) (skipped when nullptr)
template <int D, class Row>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float scale, int tig,
                                           Row row) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* o = row(half);
    if (o == nullptr) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n + 2 * tig) = __floats2bfloat162_rn(
          acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

// grid (key tiles, Kh, B), 128 threads; warp w owns keys k0 + 16w ..
// k0 + 16w + 15.  It works on S^T = K Q^T (keys as rows), so P^T and dS^T
// are the A-fragments of dV += P^T dO and dK += dS^T Q without a transpose.
// Q and dO of the next step are copied while this one is computed.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, Strides qst,
                          Strides kst, Strides vst, Strides dost, Strides dkst, Strides dvst,
                          int H, int Kh, int Sq, int Sk, int causal, int window, int kv_offset,
                          float scale, float scale_log2) {
  using C = BwdCfg<D>;
  constexpr int ROWS = C::ROWS, BQ = C::BQ, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + ROWS * LD;
  bf16* sQD = sV + ROWS * LD;           // stage s: Q at s * 2 * BQ * LD, dO after it
  float* sL = reinterpret_cast<float*>(sQD + 4 * BQ * LD);   // [2][BQ] lse
  float* sDl = sL + 2 * BQ;                                   // [2][BQ] delta

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4, r0 = warp * 16;
  const int k0 = blockIdx.x * ROWS, kh = blockIdx.y, b = blockIdx.z, G = H / Kh;
  int q_lo, q_hi;
  query_range(k0, ROWS, Sq, causal, window, kv_offset, q_lo, q_hi);
  const int qt_begin = q_lo / BQ;
  const int nq = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - qt_begin : 0;
  const int n_iter = G * nq;

  stage_rows<D>(sK, k + b * kst.b + kh * kst.h, kst.s, k0, ROWS, Sk);
  stage_rows<D>(sV, v + b * vst.b + kh * vst.h, vst.s, k0, ROWS, Sk);
  // step it: query head kh * G + it / nq, query tile qt_begin + it % nq
  auto load_step = [&](int it, int stage) {
    const int h = kh * G + it / nq, q0 = (qt_begin + it % nq) * BQ;
    bf16* dst = sQD + stage * 2 * BQ * LD;
    stage_rows<D>(dst, q + b * qst.b + h * qst.h, qst.s, q0, BQ, Sq);
    stage_rows<D>(dst + BQ * LD, dout + b * dost.b + h * dost.h, dost.s, q0, BQ, Sq);
    if (threadIdx.x < BQ) {
      const int i = q0 + threadIdx.x;
      const int64_t row = ((int64_t)b * H + h) * Sq + i;
      sL[stage * BQ + threadIdx.x] = i < Sq ? lse[row] * attn::LOG2E : attn::inf_f32();
      sDl[stage * BQ + threadIdx.x] = i < Sq ? delta[row] : 0.f;
    }
  };
  if (n_iter > 0) load_step(0, 0);
  attn::cp_async_commit();

  float dK[D / 8][4], dV[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.f;
  const int key0 = k0 + r0 + g;           // this lane's keys: key0 and key0 + 8

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    attn::cp_async_wait<0>();   // step it (and K, V) landed
    __syncthreads();            // ... for every thread; step it - 1 is done
    if (it + 1 < n_iter) load_step(it + 1, stage ^ 1);
    attn::cp_async_commit();

    const bf16* sQ = sQD + stage * 2 * BQ * LD;
    const bf16* sdO = sQ + BQ * LD;
    const float* L2 = sL + stage * BQ;     // lse in log2 units
    const float* Dl = sDl + stage * BQ;
    const int q0 = (qt_begin + it % nq) * BQ;
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, BQ>(s, sK + r0 * LD, sQ, lane);     // S^T = K Q^T
    mma_abt<D, BQ>(dp, sV + r0 * LD, sdO, lane);   // dP^T = V dO^T

    uint32_t pp[BQ / 8][2], ds[BQ / 8][2];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = key0 + 8 * half;
        float p[2], d[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n * 8 + 2 * tig + c, qi = q0 + col;
          const bool vis = key < Sk && qi < Sq && sees(kv_offset + qi, key, causal, window);
          p[c] = vis ? attn::ex2(fmaf(s[n][2 * half + c], scale_log2, -L2[col])) : 0.f;
          d[c] = p[c] * (dp[n][2 * half + c] - Dl[col]);
        }
        pp[n][half] = attn::pack_bf16(p[0], p[1]);
        ds[n][half] = attn::pack_bf16(d[0], d[1]);
      }
    mma_pb<D, BQ>(dV, pp, sdO, lane);    // dV += P^T dO
    mma_pb<D, BQ>(dK, ds, sQ, lane);     // dK += dS^T Q
  }
  attn::cp_async_wait<0>();   // no copy left in flight (K and V when n_iter = 0)

  store_rows<D>(dK, scale, tig, [&](int half) -> bf16* {
    const int key = key0 + 8 * half;
    return key < Sk ? dk + b * dkst.b + kh * dkst.h + key * dkst.s : nullptr;
  });
  store_rows<D>(dV, 1.f, tig, [&](int half) -> bf16* {
    const int key = key0 + 8 * half;
    return key < Sk ? dv + b * dvst.b + kh * dvst.h + key * dvst.s : nullptr;
  });
}

// grid (query tiles, H, B), 128 threads; warp w owns query rows q0 + 16w
// .. q0 + 16w + 15; causal grids start with the last tiles (the most
// keys).  K and V of the next key tile are copied while this one is
// computed.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, Strides qst, Strides kst, Strides vst,
                        Strides dost, Strides dqst, int H, int Kh, int Sq, int Sk, int causal,
                        int window, int kv_offset, float scale, float scale_log2) {
  using C = BwdCfg<D>;
  constexpr int ROWS = C::ROWS, BK = C::BK, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + ROWS * LD;
  bf16* sKV = sdO + ROWS * LD;          // stage s: K at s * 2 * BK * LD, V after it

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4, r0 = warp * 16;
  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / Kh), q0 = qt * ROWS;
  const int rows_valid = min(ROWS, Sq - q0);
  int kt_begin, kt_end;
  key_tiles(q0, rows_valid, Sk, BK, causal, window, kv_offset, kt_begin, kt_end);

  const bf16* kb = k + b * kst.b + kh * kst.h;
  const bf16* vb = v + b * vst.b + kh * vst.h;
  stage_rows<D>(sQ, q + b * qst.b + h * qst.h, qst.s, q0, ROWS, Sq);
  stage_rows<D>(sdO, dout + b * dost.b + h * dost.h, dost.s, q0, ROWS, Sq);
  auto load_tile = [&](int kt, int stage) {
    bf16* dst = sKV + stage * 2 * BK * LD;
    stage_rows<D>(dst, kb, kst.s, kt * BK, BK, Sk);
    stage_rows<D>(dst + BK * LD, vb, vst.s, kt * BK, BK, Sk);
  };
  if (kt_begin < kt_end) load_tile(kt_begin, 0);
  attn::cp_async_commit();

  // this lane's rows, their lse (in log2 units) and delta
  int row[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    row[half] = q0 + r0 + g + 8 * half;
    const int64_t idx = ((int64_t)b * H + h) * Sq + row[half];
    lse2[half] = row[half] < Sq ? lse[idx] * attn::LOG2E : attn::inf_f32();
    dl[half] = row[half] < Sq ? delta[idx] : 0.f;
  }
  float dQ[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQ[n][e] = 0.f;
  const bool active = r0 < rows_valid;   // this warp has a row

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int stage = it & 1;
    attn::cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt_end) load_tile(kt + 1, stage ^ 1);
    attn::cp_async_commit();
    if (!active) continue;

    const bf16* sK = sKV + stage * 2 * BK * LD;
    const bf16* sV = sK + BK * LD;
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, BK>(s, sQ + r0 * LD, sK, lane);     // S = Q K^T
    mma_abt<D, BK>(dp, sdO + r0 * LD, sV, lane);   // dP = dO V^T

    uint32_t ds[BK / 8][2];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float d[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = kt * BK + n * 8 + 2 * tig + c;
          const bool vis = key < Sk && row[half] < Sq &&
                           sees(kv_offset + row[half], key, causal, window);
          const float p =
              vis ? attn::ex2(fmaf(s[n][2 * half + c], scale_log2, -lse2[half])) : 0.f;
          d[c] = p * (dp[n][2 * half + c] - dl[half]);
        }
        ds[n][half] = attn::pack_bf16(d[0], d[1]);
      }
    mma_pb<D, BK>(dQ, ds, sK, lane);     // dQ += dS K
  }
  attn::cp_async_wait<0>();

  store_rows<D>(dQ, scale, tig, [&](int half) -> bf16* {
    return row[half] < Sq ? dq + b * dqst.b + h * dqst.h + row[half] * dqst.s : nullptr;
  });
}

// f32: CUDA-core products.  128 threads; a block owns 32 keys (dK/dV) or
// 32 query rows (dQ) and steps over 32 rows of the other side, staged in
// shared memory as f32 rows padded by one (conflict-free column reads).
// Thread t computes 8 entries (row t / 4, columns t % 4 + 4c) of S and dP,
// then D / 4 columns (t % 4 + 4c) of its row of the gradients.
constexpr int BT = 32;

template <int D>
constexpr size_t bwd_f32_smem() {
  return (size_t)(4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT) * sizeof(float);
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

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, Strides qst,
                          Strides kst, Strides vst, Strides dost, Strides dkst, Strides dvst,
                          int H, int Kh, int Sq, int Sk, int causal, int window, int kv_offset,
                          float scale) {
  constexpr int LF = D + 1, LP = BT + 1;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BT * LF;
  float* Qs = Vs + BT * LF;
  float* dOs = Qs + BT * LF;
  float* Ps = dOs + BT * LF;     // [key][query] P^T
  float* dSs = Ps + BT * LP;     // [key][query] dS^T
  float* Ls = dSs + BT * LP;
  float* Dls = Ls + BT;

  const int tid = threadIdx.x, jr = tid / 4, cc = tid % 4;
  const int k0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z, G = H / Kh;
  stage_f32<D>(Ks, k + b * kst.b + kh * kst.h, kst.s, k0, BT, Sk);
  stage_f32<D>(Vs, v + b * vst.b + kh * vst.h, vst.s, k0, BT, Sk);
  int q_lo, q_hi;
  query_range(k0, BT, Sq, causal, window, kv_offset, q_lo, q_hi);
  const int key = k0 + jr;

  float aK[D / 4], aV[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) aK[c] = aV[c] = 0.f;
  for (int gh = 0; gh < G; ++gh) {
    const int h = kh * G + gh;
    for (int q0 = q_lo / BT * BT; q0 < q_hi; q0 += BT) {
      __syncthreads();   // the previous step's readers are done
      stage_f32<D>(Qs, q + b * qst.b + h * qst.h, qst.s, q0, BT, Sq);
      stage_f32<D>(dOs, dout + b * dost.b + h * dost.h, dost.s, q0, BT, Sq);
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
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kx = Ks[jr * LF + d], vx = Vs[jr * LF + d];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[c] = fmaf(kx, Qs[(cc + 4 * c) * LF + d], s[c]);
          dp[c] = fmaf(vx, dOs[(cc + 4 * c) * LF + d], dp[c]);
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
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          aV[c] = fmaf(p, dOs[i * LF + cc + 4 * c], aV[c]);
          aK[c] = fmaf(d, Qs[i * LF + cc + 4 * c], aK[c]);
        }
      }
    }
  }
  if (key < Sk) {
    float* ok = dk + b * dkst.b + kh * dkst.h + key * dkst.s;
    float* ov = dv + b * dvst.b + kh * dvst.h + key * dvst.s;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      ok[cc + 4 * c] = aK[c] * scale;
      ov[cc + 4 * c] = aV[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, Strides qst, Strides kst, Strides vst,
                        Strides dost, Strides dqst, int H, int Kh, int Sq, int Sk, int causal,
                        int window, int kv_offset, float scale) {
  constexpr int LF = D + 1, LP = BT + 1;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BT * LF;
  float* Ks = dOs + BT * LF;
  float* Vs = Ks + BT * LF;
  float* dSs = Vs + BT * LF;     // [query][key] dS

  const int tid = threadIdx.x, ir = tid / 4, cc = tid % 4;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, kh = h / (H / Kh);
  stage_f32<D>(Qs, q + b * qst.b + h * qst.h, qst.s, q0, BT, Sq);
  stage_f32<D>(dOs, dout + b * dost.b + h * dost.h, dost.s, q0, BT, Sq);
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
    stage_f32<D>(Vs, v + b * vst.b + kh * vst.h, vst.s, k0, BT, Sk);
    __syncthreads();
    float s[8], dp[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qx = Qs[ir * LF + d], ox = dOs[ir * LF + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[c] = fmaf(qx, Ks[(cc + 4 * c) * LF + d], s[c]);
        dp[c] = fmaf(ox, Vs[(cc + 4 * c) * LF + d], dp[c]);
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

// Strides, in order: q, k, v, out, dout, dq, dk, dv
template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                       int causal, int window, int kv_offset, cudaStream_t s) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *tdo = static_cast<const T*>(dout);
  T *tdq = static_cast<T*>(dq), *tdk = static_cast<T*>(dk), *tdv = static_cast<T*>(dv);
  const int64_t rows = (int64_t)B * H * Sq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(out), tdo, delta, st[3], st[4], H, Sq, D, rows);
  if (const cudaError_t e = cudaGetLastError()) return e;
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value) {
    using C = BwdCfg<D>;
    static const cudaError_t a1 = attn::allow_smem(flash_bwd_dkdv_mma_kernel<D>, C::dkdv_smem());
    static const cudaError_t a2 = attn::allow_smem(flash_bwd_dq_mma_kernel<D>, C::dq_smem());
    if (a1 != cudaSuccess) return a1;
    if (a2 != cudaSuccess) return a2;
    const float scale_log2 = attn::LOG2E * scale;
    flash_bwd_dkdv_mma_kernel<D>
        <<<dim3((Sk + C::ROWS - 1) / C::ROWS, Kh, B), 128, C::dkdv_smem(), s>>>(
            tq, tk, tv, tdo, lse, delta, tdk, tdv, st[0], st[1], st[2], st[4], st[6], st[7], H,
            Kh, Sq, Sk, causal, window, kv_offset, scale, scale_log2);
    if (const cudaError_t e = cudaGetLastError()) return e;
    flash_bwd_dq_mma_kernel<D>
        <<<dim3((Sq + C::ROWS - 1) / C::ROWS, H, B), 128, C::dq_smem(), s>>>(
            tq, tk, tv, tdo, lse, delta, tdq, st[0], st[1], st[2], st[4], st[5], H, Kh, Sq,
            Sk, causal, window, kv_offset, scale, scale_log2);
  } else {
    constexpr size_t smem = bwd_f32_smem<D>();
    static const cudaError_t a1 = attn::allow_smem(flash_bwd_dkdv_f32_kernel<D>, smem);
    static const cudaError_t a2 = attn::allow_smem(flash_bwd_dq_f32_kernel<D>, smem);
    if (a1 != cudaSuccess) return a1;
    if (a2 != cudaSuccess) return a2;
    flash_bwd_dkdv_f32_kernel<D><<<dim3((Sk + BT - 1) / BT, Kh, B), 128, smem, s>>>(
        tq, tk, tv, tdo, lse, delta, tdk, tdv, st[0], st[1], st[2], st[4], st[6], st[7], H, Kh,
        Sq, Sk, causal, window, kv_offset, scale);
    if (const cudaError_t e = cudaGetLastError()) return e;
    flash_bwd_dq_f32_kernel<D><<<dim3((Sq + BT - 1) / BT, H, B), 128, smem, s>>>(
        tq, tk, tv, tdo, lse, delta, tdq, st[0], st[1], st[2], st[4], st[5], H, Kh, Sq, Sk,
        causal, window, kv_offset, scale);
  }
  return cudaGetLastError();
}

void unpack(const int64_t* strides, Strides* st, int n) {
  for (int i = 0; i < n; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// The split kernel's scratch: one f32 buffer of n_split * B * H * Sq *
// (D + 2) values, m [n_split, B, H, Sq], then l (the same shape), then acc
// [n_split, B, H, Sq, D].
struct Parts {
  float *m, *l, *acc;
  Parts(void* buf, int n_split, int B, int H, int Sq) {
    const int64_t n = (int64_t)n_split * B * H * Sq;
    m = static_cast<float*>(buf);
    l = m != nullptr ? m + n : nullptr;
    acc = m != nullptr ? l + n : nullptr;
  }
};

int run(const void* q, const void* k, const void* v, void* out, int dtype, int B, int H,
        int Kh, int Sq, int Sk, int D, int causal, int window, int kv_offset,
        const int64_t* strides, int rows, int n_split, void* parts, unsigned* counters,
        float* lse, cudaStream_t s) {
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  if (Kh <= 0 || H % Kh != 0) return (int)cudaErrorInvalidValue;
  Strides st[4];
  unpack(strides, st, 4);
  if (dtype == 0 && D == 64)
    return (int)launch_f32<64>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse, s);
  if (dtype == 0 && D == 128)
    return (int)launch_f32<128>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, lse,
                                s);
  if (dtype != 1 || (D != 64 && D != 128) || (n_split > 1 && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  const Parts P(parts, n_split, B, H, Sq);
  return (int)(D == 64 ? launch_mma<64>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
                                        kv_offset, rows, n_split, P.m, P.l, P.acc, counters, lse, s)
                       : launch_mma<128>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
                                         kv_offset, rows, n_split, P.m, P.l, P.acc, counters,
                                         lse, s));
}

int run_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
            const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int B,
            int H, int Kh, int Sq, int Sk, int D, int causal, int window, int kv_offset,
            const int64_t* strides, cudaStream_t s) {
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  if (Kh <= 0 || H % Kh != 0) return (int)cudaErrorInvalidValue;
  Strides st[8];
  unpack(strides, st, 8);
#define FLASH_BWD(T, DD)                                                                  \
  return (int)launch_bwd<T, DD>(q, k, v, out, dout, lse, delta, dq, dk, dv, st, B, H, Kh, \
                                Sq, Sk, causal, window, kv_offset, s)
  if (dtype == 0 && D == 64) FLASH_BWD(float, 64);
  if (dtype == 0 && D == 128) FLASH_BWD(float, 128);
  if (dtype == 1 && D == 64) FLASH_BWD(bf16, 64);
  if (dtype == 1 && D == 128) FLASH_BWD(bf16, 128);
#undef FLASH_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  strides: 12 int64 values, the
// (batch, head, sequence) strides in elements of q, k, v and out, in that
// order.  bf16 only: rows (16 or 64) is the query tile, and
// n_split > 1 splits the keys into that many ranges of ceil(tiles /
// n_split) whole 64-key tiles, whose f32 partials go to parts (see Parts)
// and are merged into out in the same launch, with one counter of
// counters (B * H * ceil(Sq / rows) of them, zero, left zero; see
// attn_merge.cuh) per output tile.  f32 ignores rows, n_split, parts and
// counters.  lse: nullptr, or contiguous f32 [B, H, Sq] that gets each
// row's log-sum-exp of its scaled, masked scores (+inf for a row that sees
// no key), which the backward reads.  Each returns a
// cudaError_t, checked after every launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int B, int H, int Kh, int Sq, int Sk, int D,
                               int causal, int window, int kv_offset,
                               const int64_t* strides, int rows, int n_split,
                               void* parts, void* counters, void* lse, void* stream) {
  return run(q, k, v, out, dtype, B, H, Kh, Sq, Sk, D, causal, window, kv_offset, strides,
             rows, n_split, parts, static_cast<unsigned*>(counters), static_cast<float*>(lse),
             static_cast<cudaStream_t>(stream));
}

// Blocks of the bf16 kernel with query tile `rows` (16 or 64) at head dim
// D (64 or 128) that one SM holds at once (shared memory, registers and
// threads, from the occupancy calculator), into *blocks: the planner's
// wave.  Returns a cudaError_t.
extern "C" int flash_blocks_per_sm(int rows, int D, int* blocks) {
  const auto ask = [&](auto kernel, cudaError_t ready, int threads, size_t smem) {
    if (ready != cudaSuccess) return (int)ready;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  };
  if (rows == 16 && D == 64)
    return ask(flash_mma_kernel<64, 1>, tile_ready<64, 1>(), 32, attn::Cfg<64>::smem_bytes(16));
  if (rows == 64 && D == 64)
    return ask(flash_mma_kernel<64, 4>, tile_ready<64, 4>(), 128, attn::Cfg<64>::smem_bytes(64));
  if (rows == 16 && D == 128)
    return ask(flash_mma_kernel<128, 1>, tile_ready<128, 1>(), 32,
               attn::Cfg<128>::smem_bytes(16));
  if (rows == 64 && D == 128)
    return ask(flash_mma_kernel<128, 4>, tile_ready<128, 4>(), 128,
               attn::Cfg<128>::smem_bytes(64));
  return (int)cudaErrorInvalidValue;
}

// The gradient of flash_attention (same mask, GQA and D): q/out/dout/dq
// [B, H, Sq, D], k/v/dk/dv [B, Kh, Sk, D] of type dtype, addressed through
// strides (24 int64 values: the (batch, head, sequence) strides in elements
// of q, k, v, out, dout, dq, dk and dv, in that order; head dim
// contiguous, bf16 rows 16-byte aligned); lse [B, H, Sq] f32 from the
// forward; delta: f32 scratch of B * H * Sq values.  dq, dk and dv are
// written whole (zero for rows and keys nothing reaches).  Launches three
// kernels on stream; returns a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int dtype, int B,
                                   int H, int Kh, int Sq, int Sk, int D, int causal,
                                   int window, int kv_offset, const int64_t* strides,
                                   void* stream) {
  return run_bwd(q, k, v, out, dout, static_cast<const float*>(lse),
                 static_cast<float*>(delta), dq, dk, dv, dtype, B, H, Kh, Sq, Sk, D, causal,
                 window, kv_offset, strides, static_cast<cudaStream_t>(stream));
}
