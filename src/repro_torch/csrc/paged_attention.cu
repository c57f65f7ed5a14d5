// Paged attention for Hopper (sm_90a): decode and chunked prefill.
//
// Replaces the Pallas TPU kernels in repro/kernels/paged_attention/
// kernel.py: paged_attention_tpu (body _paged_kernel, decode) and
// paged_prefill_attention_tpu (body _paged_prefill_kernel, chunked
// prefill).  Both reduce to one rule: query row c of request b sits at
// position qpos = ctx_b + c and sees key positions pos with
//
//     pos <= qpos   and, when window > 0,   pos > qpos - window.
//
// Decode is the C == 1 case with ctx_b = lengths[b] - 1 (the lengths count
// the token just written), which is exactly the TPU decode mask
// pos < lengths[b], pos >= lengths[b] - window.  Query head h reads KV head
// h / G.  Scores are scaled by 1/sqrt(D), masked with the finite NEG_INF
// the TPU kernels use, and reduced by an online softmax in f32 that divides
// by max(l, 1e-30), so rows whose mask is empty come out finite.
//
// Layouts (row-major): q/out [B, C, H, D]; k/v pages [n_pages, page, Kh, D];
// tables [B, max_pages] int32; lens [B] int32.  f32 or bf16 in and out, f32
// inside.
//
// The TPU grid walks (batch, page) with the page dimension sequential and
// the softmax state carried in scratch across grid steps.  CUDA blocks run
// in no order, so here one block owns (request, KV head, tile of query
// rows) and walks its pages in a loop, reading its own table row.  Pages
// wholly before the tile's window or after its last query are skipped.
// Two bodies:
//
// - bf16 chunked prefill, D = 64, 128 or 256: the tensor-core tile of
//   attn_mma.cuh.  The block's rows are (chunk row c, query head g) pairs
//   of its KV head, r = c * G + g, cut into tiles of 64 rows, 16 per warp
//   (GQA folds into the M dimension of the products); blocks of the last
//   rows, which see the most keys, start first.  A key tile is 64 keys
//   (32 at D = 256): each thread looks up its keys' pages in the table
//   (one division per tile) and copies the rows at ((blk * page + t) * Kh
//   + kh) * D (64-bit offsets) with cp.async.  Bound: the two products
//   (4 * C * ctx * D per head) on the tensor cores, and the exponentials.
// - decode (both types) and f32 prefill: CUDA-core f32 products from
//   shared memory, one page in flight.  f32 stays off the tensor cores by
//   design (the f32 model checks hold the card to the CPU within 2e-4);
//   decode, bound by the bytes of the cached K/V it reads once per step,
//   is the next kernel to redesign (split-KV for small batches).  The
//   block's tile_c x G query rows keep their running max, sum and
//   accumulator in shared memory.
#include "attn_mma.cuh"

#include <atomic>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using attn::bf16;
using attn::NEG_INF;
constexpr int THREADS = 128;
constexpr int ROWS_PER_BLOCK = 16;   // target tile_c * G for prefill

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ lens, T* __restrict__ out, int C,
                  int H, int Kh, int D, int page, int max_pages, int window,
                  int tile_c, int decode, float scale) {
  const int b = blockIdx.z, kh = blockIdx.y, c0 = blockIdx.x * tile_c;
  const int G = H / Kh;
  const int QR = tile_c * G;       // query rows of this block, r = (c - c0) * G + g
  const int DP = D + 1;            // padded stride: no bank conflicts across rows
  extern __shared__ float smem[];
  float* qs = smem;                // [QR, DP] scaled queries
  float* acc = qs + QR * DP;       // [QR, D]
  float* ks = acc + QR * D;        // [page, DP]
  float* vs = ks + page * DP;      // [page, D]
  float* s = vs + page * D;        // [QR, page] scores, then probabilities
  float* m = s + QR * page;        // [QR] running max
  float* l = m + QR;               // [QR] running sum
  float* alpha = l + QR;           // [QR] rescale of this page

  const int tid = threadIdx.x;
  const int ctx = decode ? lens[b] - 1 : lens[b];

  for (int i = tid; i < QR * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int c = c0 + r / G, g = r % G;
    float v = 0.f;
    if (c < C) v = to_f32(q[(((int64_t)b * C + c) * H + kh * G + g) * D + d]) * scale;
    qs[r * DP + d] = v;
    acc[i] = 0.f;
  }
  for (int r = tid; r < QR; r += THREADS) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  // pages any row of the tile can see
  const int q_lo = ctx + c0;
  const int q_hi = ctx + min(c0 + tile_c, C) - 1;
  const int j_end = q_hi < 0 ? 0 : min(max_pages, q_hi / page + 1);
  int j_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) j_begin = (q_lo - window + 1) / page;
  __syncthreads();

  // one thread per dot product when there are enough of them, else a warp
  const int gs = (QR * page >= THREADS) ? 1 : 32;
  const int ngroups = THREADS / gs, group = tid / gs, lane = tid % gs;

  for (int j = j_begin; j < j_end; ++j) {
    const int64_t blk = tables[(int64_t)b * max_pages + j];
    for (int i = tid; i < page * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const int64_t off = ((blk * page + t) * Kh + kh) * (int64_t)D + d;
      ks[t * DP + d] = to_f32(kp[off]);
      vs[i] = to_f32(vp[off]);
    }
    __syncthreads();

    for (int idx = group; idx < QR * page; idx += ngroups) {
      const int r = idx / page, t = idx % page;
      float part = 0.f;
      for (int d = lane; d < D; d += gs) part += qs[r * DP + d] * ks[t * DP + d];
      for (int o = gs / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) {
        const int qpos = ctx + c0 + r / G;
        const int pos = j * page + t;
        const bool valid = pos <= qpos && (window <= 0 || pos > qpos - window);
        s[idx] = valid ? part : NEG_INF;
      }
    }
    __syncthreads();

    for (int r = tid; r < QR; r += THREADS) {
      float* sr = s + r * page;
      float mx = m[r];
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(sr[t] - mx);
        sr[t] = p;
        sum += p;
      }
      const float a = expf(m[r] - mx);
      l[r] = a * l[r] + sum;
      m[r] = mx;
      alpha[r] = a;
    }
    __syncthreads();

    for (int i = tid; i < QR * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const float* sr = s + r * page;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < page; ++t) a += sr[t] * vs[t * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < QR * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int c = c0 + r / G, g = r % G;
    if (c < C)
      out[(((int64_t)b * C + c) * H + kh * G + g) * D + d] =
          from_f32<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tables,
                   const void* lens, void* out, int B, int C, int H, int Kh, int D,
                   int page, int max_pages, int window, int decode,
                   cudaStream_t stream) {
  if (B == 0 || C == 0) return cudaSuccess;
  const int G = H / Kh;
  const int tile_c = decode ? 1 : (G >= ROWS_PER_BLOCK ? 1 : ROWS_PER_BLOCK / G);
  const size_t QR = (size_t)tile_c * G;
  const size_t smem = (QR * (D + 1) + QR * D + (size_t)page * (D + 1) +
                       (size_t)page * D + QR * page + 3 * QR) * sizeof(float);
  // raise the kernel's shared-memory limit only when a launch needs more
  // than any launch before it (D, G and page vary between callers)
  static std::atomic<size_t> allowed{0};
  if (smem > allowed.load()) {
    const cudaError_t err = attn::allow_smem(paged_attn_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    allowed.store(smem);
  }
  const dim3 grid((C + tile_c - 1) / tile_c, Kh, B);
  paged_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lens),
      static_cast<T*>(out), C, H, Kh, D, page, max_pages, window, tile_c, decode,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 chunked prefill on the tensor-core tile
// ---------------------------------------------------------------------------
struct PagedProb {
  const bf16 *q_base, *k_base, *v_base;
  const int32_t* table;                   // this request's row
  int64_t q_b;                            // q offset of (b, c = 0, h = kh * G)
  int row0, rows_valid, G, H, Kh, D, page, ctx, kv_limit, causal, window;
  __device__ const bf16* q_row(int r) const {
    const int rg = row0 + r;
    return q_base + q_b + ((int64_t)(rg / G) * H + rg % G) * D;
  }
  __device__ int qpos(int r) const { return ctx + (row0 + r) / G; }
  // key j: row j % page of page table[j / page], as a row of the layer's
  // [n_pages * page, Kh, D] pool (kh's D elements of it).  One division
  // per tile: the keys j + m * STEP walk the pages by subtraction.
  template <int N, int STEP>
  __device__ void kv_rows(int j, int (&row)[N]) const {
    int pg = j / page, t = j % page;
#pragma unroll
    for (int m = 0; m < N; ++m) {
      row[m] = j + m * STEP < kv_limit ? table[pg] * page + t : -1;
      for (t += STEP; t >= page; t -= page) ++pg;
    }
  }
  __device__ const bf16* k_at(int i) const { return k_base + (int64_t)i * Kh * D; }
  __device__ const bf16* v_at(int i) const { return v_base + (int64_t)i * Kh * D; }
};

// grid (ceil(C * G / 64), Kh, B); block of 4 warps, 16 rows each (the
// warps whose rows lie past the chunk still copy K/V tiles)
template <int D>
__global__ void __launch_bounds__(32 * attn::MAX_WARPS, 2)
paged_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                         const bf16* __restrict__ vp, const int32_t* __restrict__ tables,
                         const int32_t* __restrict__ ctx_lens, bf16* __restrict__ out,
                         int C, int H, int Kh, int page, int max_pages, int window,
                         float scale_log2) {
  constexpr int BK = attn::Cfg<D>::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int rows = 16 * attn::MAX_WARPS;
  const int b = blockIdx.z, kh = blockIdx.y, G = H / Kh;
  // later rows see more keys (causal), so their blocks start first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * rows;

  PagedProb P;
  P.q_b = ((int64_t)b * C * H + (int64_t)kh * G) * D;
  P.q_base = q;
  P.k_base = kp + (int64_t)kh * D;
  P.v_base = vp + (int64_t)kh * D;
  P.table = tables + (int64_t)b * max_pages;
  P.row0 = row0;
  P.rows_valid = min(rows, C * G - row0);
  P.G = G;
  P.H = H;
  P.Kh = Kh;
  P.D = D;
  P.page = page;
  P.ctx = ctx_lens[b];
  P.kv_limit = max_pages * page;
  P.causal = 1;
  P.window = window;

  // key tiles any row of the tile can see
  const int q_lo = P.qpos(0), q_hi = P.qpos(P.rows_valid - 1);
  const int k_end = min(P.kv_limit, q_hi + 1);
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > k_begin ? (k_end + BK - 1) / BK : kt_begin;

  attn::RowState<D> st;
  attn::attend<D, attn::MAX_WARPS>(P, kt_begin, kt_end, scale_log2, st,
                                   reinterpret_cast<bf16*>(smem_raw));

  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * 16;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= P.rows_valid) continue;
    const float inv = 1.f / fmaxf(st.l[half], 1e-30f);
    bf16* o = out + P.q_b + ((int64_t)((row0 + r) / G) * H + (row0 + r) % G) * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) = __floats2bfloat162_rn(
          st.acc[n][2 * half] * inv, st.acc[n][2 * half + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* tables,
                       const void* ctx_lens, void* out, int B, int C, int H, int Kh,
                       int page, int max_pages, int window, cudaStream_t stream) {
  using Cf = attn::Cfg<D>;
  static const cudaError_t attr =
      attn::allow_smem(paged_prefill_mma_kernel<D>, Cf::smem_bytes(16 * attn::MAX_WARPS));
  if (attr != cudaSuccess) return attr;
  if (B == 0 || C == 0) return cudaSuccess;
  const int n_rows = C * (H / Kh), rows = 16 * attn::MAX_WARPS;
  const dim3 grid((n_rows + rows - 1) / rows, Kh, B);
  paged_prefill_mma_kernel<D><<<grid, 32 * attn::MAX_WARPS, Cf::smem_bytes(rows), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ctx_lens),
      static_cast<bf16*>(out), C, H, Kh, page, max_pages, window,
      attn::LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* tables,
             const void* lens, void* out, int dtype, int B, int C, int H, int Kh,
             int D, int page, int max_pages, int window, int decode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kh <= 0 || H % Kh != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, tables, lens, out, B, C, H, Kh, D, page,
                         max_pages, window, decode, s);
  if (dtype == 1 && decode)
    return launch<bf16>(q, k, v, tables, lens, out, B, C, H, Kh, D, page,
                        max_pages, window, decode, s);
  if (dtype == 1 && D == 64)
    return launch_mma<64>(q, k, v, tables, lens, out, B, C, H, Kh, page, max_pages, window, s);
  if (dtype == 1 && D == 128)
    return launch_mma<128>(q, k, v, tables, lens, out, B, C, H, Kh, page, max_pages, window, s);
  if (dtype == 1 && D == 256)
    return launch_mma<256>(q, k, v, tables, lens, out, B, C, H, Kh, page, max_pages, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Both return a cudaError_t.

// Decode: q/out [B, H, D]; lengths[b] tokens valid (the new one included).
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* tables, const void* lengths, void* out,
                               int dtype, int B, int H, int Kh, int D, int page,
                               int max_pages, int window, void* stream) {
  return dispatch(q, k, v, tables, lengths, out, dtype, B, 1, H, Kh, D, page,
                  max_pages, window, 1, stream);
}

// Chunked prefill: q/out [B, C, H, D]; ctx_lens[b] tokens cached before the
// chunk, whose own K/V rows are already in the pages (write-then-attend).
extern "C" int paged_prefill_attention(const void* q, const void* k, const void* v,
                                       const void* tables, const void* ctx_lens,
                                       void* out, int dtype, int B, int C, int H,
                                       int Kh, int D, int page, int max_pages,
                                       int window, void* stream) {
  return dispatch(q, k, v, tables, ctx_lens, out, dtype, B, C, H, Kh, D, page,
                  max_pages, window, 0, stream);
}
