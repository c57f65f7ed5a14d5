// The split-KV merge for Hopper (sm_90a), shared by flash attention
// (flash_attention.cu) and decode paged attention (paged_attention.cu).
//
// A split kernel cuts each query row's keys into n_split ranges and leaves,
// for each range, the f32 softmax state of the row over the keys of that
// range it sees: m (the largest scaled score, natural-log units), l (the
// sum of exp(score - m)) and acc (the sum of exp(score - m) * v).  This
// kernel combines them by log-sum-exp into the output row,
//
//     M = max over splits with l > 0 of m_s,
//     out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30),
//
// in f32, rounding once to the output type.  Splits with l = 0 saw no key
// and weigh nothing (their m and acc are not read); a row that no split
// saw comes out 0.  It replaces the cross-block reduction that the TPU
// kernels (flash_attention_tpu, paged_attention_tpu) did by carrying the
// softmax state in scratch across sequential grid steps.
//
// Layouts: m / l [n_split, B, H, Sq], acc [n_split, B, H, Sq, D] (f32,
// contiguous); out [B, H, Sq, D] addressed through its (batch, head,
// sequence) strides in elements, the head dim contiguous.  Each thread
// merges 4-column chunks of rows over batches of 4 splits whose loads go
// out together (merge_rows), so a tile costs about one round trip to L2
// per 4 splits, not a chain of them per row.  Bound: the bytes of the
// partials, read once.
//
// The split kernels merge in their own last block (arrive_last, then
// merge_rows): each block writes its partials for the rows of one output
// tile and counts itself in at the tile's counter (a release); the block
// that arrives last (all n_split partials are then in L2) merges the
// tile's rows and sets the counter back to 0.  No second launch.  The
// merging block works alone on its tile, so the merge is written for few
// round trips to L2 and few registers (the split kernels' main loops must
// not lose occupancy to it).  A tile of few rows (decode, a flash decode
// row) merges faster this way than in a second kernel; a tile of 64 rows
// is merged by flash's split kernel in the registers of its last block
// instead (see flash_attention.cu).  The
// counters are a buffer that the wrapper owns, one per (device, stream)
// and one per (CUDA-graph capture, stream): zero when made, zero again
// after every call, so no call fills them and no two calls that may run
// at once share one (see repro_torch.kernels.tile_counters).
// merge_kernel runs merge_rows as a kernel of its own, exported as
// attn_merge to check the merge alone.
#pragma once

#include "attn_mma.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace attn {

struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(bf16* p, float x) { *p = __float2bfloat16(x); }

constexpr int MERGE_ROWS = 8;          // rows of one merge_kernel block

constexpr int MERGE_SPLITS = 4;        // splits whose loads go out together

// Threads of a block merge partial rows row0 .. row0 + rows - 1 of n_rows
// (the stride between splits) into out_row(r), one 4-column chunk of a row
// a thread at a time; with lse, also each row's log-sum-exp M + log L
// (+inf for a row no split saw) into lse[row], rows numbered as the
// partials' (flash attention's training forward).  For MERGE_SPLITS splits at once a thread reads each
// split's m, l and its chunk of acc, all loads issued before any is used
// (one round trip to L2 per batch, not a chain of them), then folds the
// batch into its running (M, L, acc) by log-sum-exp.  Loads go through L2
// (ld.global.cg): in the fused path other blocks of the same launch wrote
// the partials.  Its registers stay below the split kernels' main loops
// (more chunks or splits in flight raised them and cost the loops
// occupancy).
template <typename T, int D, class OutRow>
__device__ __forceinline__ void merge_rows(const float* pm, const float* pl, const float* pa,
                                           int64_t n_rows, int64_t row0, int rows, int n_split,
                                           OutRow out_row, float* lse = nullptr) {
  constexpr int C4 = D / 4;              // 4-column chunks of a row
  for (int u = threadIdx.x; u < rows * C4; u += blockDim.x) {
    const int64_t row = row0 + u / C4;
    float M = NEG_INF, L = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += MERGE_SPLITS) {
      float l[MERGE_SPLITS], m[MERGE_SPLITS];
      float4 x[MERGE_SPLITS];
#pragma unroll
      for (int j = 0; j < MERGE_SPLITS; ++j) {
        l[j] = 0.f;                      // past the splits: weighs nothing
        if (s0 + j < n_split) {
          const int64_t pr = (s0 + j) * n_rows + row;
          l[j] = __ldcg(pl + pr);
          m[j] = __ldcg(pm + pr);
          x[j] = __ldcg(reinterpret_cast<const float4*>(pa + pr * D) + u % C4);
        }
      }
      float Mn = M;                      // a split with l = 0 saw no key: its m is not read
#pragma unroll
      for (int j = 0; j < MERGE_SPLITS; ++j)
        if (l[j] > 0.f) Mn = fmaxf(Mn, m[j]);
      const float sc = expf(M - Mn);
      L *= sc;
      a = make_float4(a.x * sc, a.y * sc, a.z * sc, a.w * sc);
#pragma unroll
      for (int j = 0; j < MERGE_SPLITS; ++j)
        if (l[j] > 0.f) {
          const float w = expf(m[j] - Mn);
          L = fmaf(w, l[j], L);
          a.x = fmaf(w, x[j].x, a.x);
          a.y = fmaf(w, x[j].y, a.y);
          a.z = fmaf(w, x[j].z, a.z);
          a.w = fmaf(w, x[j].w, a.w);
        }
      M = Mn;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    if (lse != nullptr && u % C4 == 0) lse[row] = L > 0.f ? M + logf(L) : inf_f32();
    T* o = out_row(u / C4) + 4 * (u % C4);
    store_f32(o, a.x * inv);
    store_f32(o + 1, a.y * inv);
    store_f32(o + 2, a.z * inv);
    store_f32(o + 3, a.w * inv);
  }
}

// Called by every thread of a split block once its partials are written:
// true in the block that counted in last at `counter` (of n_split), which
// has reset it.  The barrier orders the block's writes before thread 0's
// add, which releases them at GPU scope and acquires the other blocks'
// (a release is cumulative over what the barrier ordered before it).
__device__ __forceinline__ bool arrive_last(unsigned* counter, int n_split) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(counter) : "memory");
    last = old == (unsigned)n_split - 1;
    if (last) *counter = 0;      // every split has counted in: ready for the next call
  }
  __syncthreads();
  return last;
}

// The merge as a kernel of its own: MERGE_ROWS rows of [B, H, Sq] a block
// of 256 threads.
template <typename T, int D>
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
             const float* __restrict__ part_acc, T* __restrict__ out, Strides ost,
             int n_split, int B, int H, int Sq) {
  const int64_t n_rows = (int64_t)B * H * Sq;
  const int64_t row0 = (int64_t)blockIdx.x * MERGE_ROWS;
  const int rows = (int)min((int64_t)MERGE_ROWS, n_rows - row0);
  merge_rows<T, D>(part_m, part_l, part_acc, n_rows, row0, rows, n_split, [&](int r) {
    const int64_t row = row0 + r;
    const int i = (int)(row % Sq), h = (int)(row / Sq % H), b = (int)(row / ((int64_t)Sq * H));
    return out + b * ost.b + h * ost.h + i * ost.s;
  });
}

// D = 32, 64, 112, 128, 160 or 256; out of type T (float or bf16): the
// merge alone.
template <typename T>
cudaError_t launch_merge(const float* pm, const float* pl, const float* pa, void* out,
                         Strides ost, int n_split, int B, int H, int Sq, int D,
                         cudaStream_t s) {
  const int64_t n_rows = (int64_t)B * H * Sq;
  if (n_rows == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((n_rows + MERGE_ROWS - 1) / MERGE_ROWS);
  T* o = static_cast<T*>(out);
  const auto run = [&](auto d) {
    merge_kernel<T, decltype(d)::value>
        <<<grid, 256, 0, s>>>(pm, pl, pa, o, ost, n_split, B, H, Sq);
  };
  switch (D) {
    case 32: run(std::integral_constant<int, 32>()); break;
    case 64: run(std::integral_constant<int, 64>()); break;
    case 112: run(std::integral_constant<int, 112>()); break;
    case 128: run(std::integral_constant<int, 128>()); break;
    case 160: run(std::integral_constant<int, 160>()); break;
    case 256: run(std::integral_constant<int, 256>()); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace attn

// The merge alone, exported by every kernel library that includes this
// header (one translation unit each), for checking it against its plain
// version: partials as above into out [B, H, Sq, D] of type dtype (0 =
// float32, 1 = bfloat16), strides: out's 3 (batch, head, sequence) strides
// in elements.  Returns a cudaError_t.
extern "C" int attn_merge(const void* part_m, const void* part_l, const void* part_acc,
                          void* out, int dtype, int n_split, int B, int H, int Sq, int D,
                          const int64_t* strides, void* stream) {
  const attn::Strides st{strides[0], strides[1], strides[2]};
  const float *pm = static_cast<const float*>(part_m), *pl = static_cast<const float*>(part_l),
              *pa = static_cast<const float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)attn::launch_merge<float>(pm, pl, pa, out, st, n_split, B, H, Sq, D, s);
  if (dtype == 1)
    return (int)attn::launch_merge<attn::bf16>(pm, pl, pa, out, st, n_split, B, H, Sq, D, s);
  return (int)cudaErrorInvalidValue;
}

// Whether `stream` is capturing a CUDA graph (1, with the capture's id in
// *id, unique in the process) or not (0, *id = 0); -1 on an error.  The
// wrappers key the split kernels' tile counters by it.
extern "C" int stream_capture(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status;
  unsigned long long cid = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &cid) != cudaSuccess)
    return -1;
  *id = status == cudaStreamCaptureStatusActive ? cid : 0;
  return status == cudaStreamCaptureStatusActive ? 1 : 0;
}
