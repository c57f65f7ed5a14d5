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
// sequence) strides in elements, the head dim contiguous.  One warp per
// output row; its lanes read the splits' m and l side by side, so a row
// costs two rounds of loads, not one per split.  Bound: the bytes of the
// partials, read once.
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

template <typename T, int D>
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
             const float* __restrict__ part_acc, T* __restrict__ out, Strides ost,
             int n_split, int B, int H, int Sq) {
  const int64_t n_rows = (int64_t)B * H * Sq;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  float M = NEG_INF;
  for (int s = lane; s < n_split; s += 32)
    if (part_l[s * n_rows + row] > 0.f) M = fmaxf(M, part_m[s * n_rows + row]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float L = 0.f, acc[D / 32];
#pragma unroll
  for (int c = 0; c < D / 32; ++c) acc[c] = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += 32) {
    float w = 0.f, l = 0.f;      // split s0 + lane's weight
    if (s0 + lane < n_split) {
      l = part_l[(s0 + lane) * n_rows + row];
      if (l > 0.f) w = expf(part_m[(s0 + lane) * n_rows + row] - M);
    }
    L += w * l;
    const int n = min(32, n_split - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      if (wj == 0.f) continue;
      const float* a = part_acc + ((s0 + j) * n_rows + row) * D;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[c] += wj * a[lane + 32 * c];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
  const int i = (int)(row % Sq), h = (int)(row / Sq % H), b = (int)(row / ((int64_t)Sq * H));
  T* o = out + b * ost.b + h * ost.h + i * ost.s;
  const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
  for (int c = 0; c < D / 32; ++c) store_f32(o + lane + 32 * c, acc[c] * inv);
}

// D = 32, 64, 128 or 256; out of type T (float or bf16).  Split kernels
// call it right after themselves, from their own C entry point.
template <typename T>
cudaError_t launch_merge(const float* pm, const float* pl, const float* pa, void* out,
                         Strides ost, int n_split, int B, int H, int Sq, int D,
                         cudaStream_t s) {
  const int64_t n_rows = (int64_t)B * H * Sq;
  if (n_rows == 0) return cudaSuccess;
  constexpr int WARPS = 8;
  const unsigned grid = (unsigned)((n_rows + WARPS - 1) / WARPS);
  T* o = static_cast<T*>(out);
  const auto run = [&](auto d) {
    merge_kernel<T, decltype(d)::value>
        <<<grid, 32 * WARPS, 0, s>>>(pm, pl, pa, o, ost, n_split, B, H, Sq);
  };
  switch (D) {
    case 32: run(std::integral_constant<int, 32>()); break;
    case 64: run(std::integral_constant<int, 64>()); break;
    case 128: run(std::integral_constant<int, 128>()); break;
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
