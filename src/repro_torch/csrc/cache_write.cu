// Fused paged-cache row write for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/cache_write/kernel.py::
// cache_write_tpu (body _write_kernel): new[i] lands in row `dst` of the
// flattened page pool [rows, w], cast to the pool's type, in place.
//
//   dst = base_row + (i / n_slots) * tensor_stride + slots[i % n_slots]
//
// With n_slots = n_rows, tensor_stride = base_row = 0 this is the plain
// flat scatter of cache_write_tpu.  The paged wrappers use the general
// form so one launch covers the K and V planes of one layer of a
// [T, L, NB+1, bs, w] pool without building a slot vector per layer.
//
// Bound: bytes.  The kernel reads each new row once and writes it once;
// there is no arithmetic.  Design: one block per destination row, the
// threads stride over the width with 16-byte accesses when source and pool
// share a type and both rows are 16-byte aligned, else one element at a
// time with the cast.  All row offsets are 64-bit: a full-width LLaVA KV
// pool holds more than 2^31 elements.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

template <typename S, typename D>
__global__ void cache_write_kernel(D* __restrict__ pool, const S* __restrict__ rows,
                                   const int32_t* __restrict__ slots, int n_slots,
                                   int64_t tensor_stride, int64_t base_row, int w,
                                   int vec) {
  const int64_t i = blockIdx.x;
  const int64_t dst = base_row + (i / n_slots) * tensor_stride +
                      (int64_t)slots[i % n_slots];
  D* out = pool + dst * (int64_t)w;
  const S* in = rows + i * (int64_t)w;
  if (vec) {  // same type, 16-byte aligned rows: straight 16-byte copies
    const int n16 = (int)((int64_t)w * sizeof(S) / 16);
    const uint4* src = reinterpret_cast<const uint4*>(in);
    uint4* dstv = reinterpret_cast<uint4*>(out);
    for (int k = threadIdx.x; k < n16; k += blockDim.x) dstv[k] = src[k];
  } else {
    for (int k = threadIdx.x; k < w; k += blockDim.x)
      out[k] = from_f32<D>(to_f32<S>(in[k]));
  }
}

template <typename S, typename D>
cudaError_t launch(void* pool, const void* rows, const void* slots, int n_rows,
                   int n_slots, int64_t tensor_stride, int64_t base_row, int w,
                   int vec, cudaStream_t stream) {
  if (n_rows == 0) return cudaSuccess;
  cache_write_kernel<S, D><<<n_rows, 128, 0, stream>>>(
      static_cast<D*>(pool), static_cast<const S*>(rows),
      static_cast<const int32_t*>(slots), n_slots, tensor_stride, base_row, w, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int cache_write(void* pool, int pool_dtype, const void* rows,
                           int rows_dtype, const void* slots, int n_rows,
                           int n_slots, long long tensor_stride,
                           long long base_row, int w, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_dtype == 0 && pool_dtype == 0)
    return launch<float, float>(pool, rows, slots, n_rows, n_slots, tensor_stride,
                                base_row, w, vec, s);
  if (rows_dtype == 1 && pool_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(pool, rows, slots, n_rows, n_slots,
                                                tensor_stride, base_row, w, vec, s);
  if (rows_dtype == 0 && pool_dtype == 1)
    return launch<float, __nv_bfloat16>(pool, rows, slots, n_rows, n_slots,
                                        tensor_stride, base_row, w, 0, s);
  if (rows_dtype == 1 && pool_dtype == 0)
    return launch<__nv_bfloat16, float>(pool, rows, slots, n_rows, n_slots,
                                        tensor_stride, base_row, w, 0, s);
  return (int)cudaErrorInvalidValue;
}
