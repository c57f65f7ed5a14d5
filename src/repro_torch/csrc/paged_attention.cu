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
// in no order, so here one block owns (request, KV head, tile of chunk
// rows) and walks its pages in a loop: it loads its own table row, stages
// one page of K and V for its KV head in shared memory, and updates the
// running max, sum and accumulator of its tile_c x G query rows.  Pages
// wholly before the tile's window or after its last query are skipped.
//
// Bound: bytes for decode (every cached K/V row is read once per step and
// the arithmetic per byte is ~1 FLOP); for prefill with long chunks the
// score and value products (2 * C * ctx * D per head, twice) on CUDA cores
// bound it.  This first version is deliberately simple: f32 CUDA-core dot
// products from shared memory, one page in flight.  Tensor cores (wgmma),
// TMA staging and split-KV for small decode batches are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int ROWS_PER_BLOCK = 16;   // target tile_c * G for prefill

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
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
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + tile_c - 1) / tile_c, Kh, B);
  paged_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lens),
      static_cast<T*>(out), C, H, Kh, D, page, max_pages, window, tile_c, decode,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* tables,
             const void* lens, void* out, int dtype, int B, int C, int H, int Kh,
             int D, int page, int max_pages, int window, int decode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, tables, lens, out, B, C, H, Kh, D, page,
                         max_pages, window, decode, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, tables, lens, out, B, C, H, Kh, D, page,
                                 max_pages, window, decode, s);
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
