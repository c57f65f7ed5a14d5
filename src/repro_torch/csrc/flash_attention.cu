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
#include "attn_mma.cuh"
#include "attn_merge.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using attn::bf16;
using attn::NEG_INF;
using attn::Strides;

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
                 float* __restrict__ part_acc, unsigned* __restrict__ counters) {
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
        [&](int r) { return out + b * ost.b + h * ost.h + (q0 + r) * ost.s; });
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
                        float* pl, float* pacc, unsigned* counters, cudaStream_t stream) {
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
      split_tiles, n_split > 1 ? pm : nullptr, pl, pacc, counters);
  return cudaGetLastError();
}

// rows: 16 (one warp) or 64 (four warps)
template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                       int causal, int window, int kv_offset, int rows, int n_split,
                       float* pm, float* pl, float* pacc, unsigned* counters, cudaStream_t stream) {
  if (n_split < 1 ||
      (n_split > 1 && (pm == nullptr || pl == nullptr || pacc == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (rows == 16)
    return launch_tile<D, 1>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
                             kv_offset, n_split, pm, pl, pacc, counters, stream);
  if (rows == 64)
    return launch_tile<D, 4>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
                             kv_offset, n_split, pm, pl, pacc, counters, stream);
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
             int causal, int window, int kv_offset, float scale) {
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
#pragma unroll
      for (int c = 0; c < DC; ++c)
        ob[r * ost.s + tx * DC + c] = acc[i][c] / denom;
    }
  }
}

template <int D, int TM>
cudaError_t launch_tm(const void* q, const void* k, const void* v, void* out,
                      const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                      int causal, int window, int kv_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, TM>();
  static const cudaError_t attr = attn::allow_smem(flash_kernel<D, TM>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + 8 * TM - 1) / (8 * TM), H, B);
  flash_kernel<D, TM><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), st[0], st[1], st[2], st[3],
      H, Kh, Sq, Sk, causal, window, kv_offset, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                       int causal, int window, int kv_offset, cudaStream_t stream) {
  // the largest row tile whose grid still covers every SM once
  const int sms = attn::sm_count();
  int tm = 8;
  while (tm > 1 && (int64_t)B * H * ((Sq + 8 * tm - 1) / (8 * tm)) < sms) tm /= 2;
  switch (tm) {
    case 8: return launch_tm<D, 8>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
    case 4: return launch_tm<D, 4>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
    case 2: return launch_tm<D, 2>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
    default: return launch_tm<D, 1>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
  }
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
        cudaStream_t s) {
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  if (Kh <= 0 || H % Kh != 0) return (int)cudaErrorInvalidValue;
  Strides st[4];
  unpack(strides, st, 4);
  if (dtype == 0 && D == 64)
    return (int)launch_f32<64>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, s);
  if (dtype == 0 && D == 128)
    return (int)launch_f32<128>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, s);
  if (dtype != 1 || (D != 64 && D != 128) || (n_split > 1 && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  const Parts P(parts, n_split, B, H, Sq);
  return (int)(D == 64 ? launch_mma<64>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
                                        kv_offset, rows, n_split, P.m, P.l, P.acc, counters, s)
                       : launch_mma<128>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window,
                                         kv_offset, rows, n_split, P.m, P.l, P.acc, counters,
                                         s));
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
// counters.  Each returns a
// cudaError_t, checked after every launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int B, int H, int Kh, int Sq, int Sk, int D,
                               int causal, int window, int kv_offset,
                               const int64_t* strides, int rows, int n_split,
                               void* parts, void* counters, void* stream) {
  return run(q, k, v, out, dtype, B, H, Kh, Sq, Sk, D, causal, window, kv_offset, strides,
             rows, n_split, parts, static_cast<unsigned*>(counters),
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
