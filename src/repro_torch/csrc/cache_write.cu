// Fused paged-cache row write for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/cache_write/kernel.py::
// cache_write_tpu (body _write_kernel): a new row lands in a row of the
// flattened page pool [rows, w], cast to the pool's type, in place.  The
// n_rows source rows are T planes of n_slots rows each, read where they
// lie (no stacked copy of K and V first): row r of plane t starts at
//
//   src + t * plane_stride + r * row_stride              (elements)
//
// and lands in pool row
//
//   base_row + t * tensor_stride + slots[r].
//
// With one plane, n_slots = n_rows and tensor_stride = base_row = 0 this is
// the plain flat scatter of cache_write_tpu.  The paged wrappers use the
// general form so one launch covers the K and V planes of one layer of a
// [T, L, NB+1, bs, w] pool without building a slot vector per layer.  A
// row whose slot lies in [skip_lo, skip_lo + skip_n), the scratch block
// that padded batch lanes and padded chunk positions point at, is neither
// read nor written: nobody reads those rows (skip_n = 0 writes every row).
//
// Bound: bytes.  The kernel reads each row that matters once and writes it
// once; there is no arithmetic.  Design: the work is cut below the row,
// into pieces of 1 KB (64 16-byte vectors of a row, two per lane), one
// warp each, so the 16 rows of a decode write (K and V of 8 lanes at
// w = 4096) are 128 warps spread over the SMs rather than 16 blocks; each
// lane issues both of its loads before its stores.  Small writes take
// one-warp blocks (every block resident at once); large ones four-warp
// blocks.  Same type and 16-byte aligned rows: straight 16-byte copies,
// else one element at a time with the cast.  All row offsets are 64-bit:
// a full-width LLaVA KV pool holds more than 2^31 elements.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int LANE_VECS = 2;                 // 16-byte vectors a lane moves
constexpr int PIECE_VECS = 32 * LANE_VECS;   // one warp's piece: 1 KB
constexpr int PIECE_ELEMS = 256;             // a piece of the casting copy
constexpr int64_t SMALL_PIECES = 4096;       // fewer: one-warp blocks

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

struct Rows {
  int64_t plane_stride, row_stride;   // source, in elements
  int64_t tensor_stride, base_row;    // destination, in pool rows
  int n_slots, skip_lo, skip_n, w, pieces_per_row;
  int64_t n_pieces;
};

// One warp per piece: piece p is part p % pieces_per_row of source row
// p / pieces_per_row.
template <typename S, typename D, bool VEC>
__global__ void __launch_bounds__(128)
cache_write_kernel(D* __restrict__ pool, const S* __restrict__ src,
                   const int32_t* __restrict__ slots, Rows a) {
  const int64_t piece = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (piece >= a.n_pieces) return;
  const int lane = threadIdx.x % 32;
  const int64_t i = piece / a.pieces_per_row;
  const int part = (int)(piece - i * a.pieces_per_row);
  const int64_t t = i / a.n_slots;
  const int r = (int)(i - t * a.n_slots);
  const int slot = __ldg(slots + r);
  if ((unsigned)(slot - a.skip_lo) < (unsigned)a.skip_n) return;   // scratch
  D* out = pool + (a.base_row + t * a.tensor_stride + slot) * (int64_t)a.w;
  const S* in = src + t * a.plane_stride + r * a.row_stride;
  if constexpr (VEC) {
    const int n16 = (int)((int64_t)a.w * sizeof(S) / 16);
    const uint4* s4 = reinterpret_cast<const uint4*>(in);
    uint4* d4 = reinterpret_cast<uint4*>(out);
    const int k0 = part * PIECE_VECS + lane;
    uint4 v[LANE_VECS];
#pragma unroll
    for (int u = 0; u < LANE_VECS; ++u)
      if (k0 + 32 * u < n16) v[u] = __ldcs(s4 + k0 + 32 * u);   // read once
#pragma unroll
    for (int u = 0; u < LANE_VECS; ++u)
      if (k0 + 32 * u < n16) d4[k0 + 32 * u] = v[u];
  } else {
    const int e0 = part * PIECE_ELEMS + lane;
    float v[PIECE_ELEMS / 32];
#pragma unroll
    for (int u = 0; u < PIECE_ELEMS / 32; ++u)
      if (e0 + 32 * u < a.w) v[u] = to_f32<S>(in[e0 + 32 * u]);
#pragma unroll
    for (int u = 0; u < PIECE_ELEMS / 32; ++u)
      if (e0 + 32 * u < a.w) out[e0 + 32 * u] = from_f32<D>(v[u]);
  }
}

template <typename S, typename D>
cudaError_t launch(void* pool, const void* src, const void* slots, int64_t n_rows, Rows a,
                   int vec, cudaStream_t stream) {
  if (n_rows == 0) return cudaSuccess;
  const int64_t per = vec ? PIECE_VECS * (int64_t)(16 / sizeof(S)) : PIECE_ELEMS;
  a.pieces_per_row = (int)((a.w + per - 1) / per);
  a.n_pieces = n_rows * a.pieces_per_row;
  const int warps = a.n_pieces < SMALL_PIECES ? 1 : 4;
  const int64_t grid = (a.n_pieces + warps - 1) / warps;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  D* p = static_cast<D*>(pool);
  const S* s = static_cast<const S*>(src);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  if (vec)
    cache_write_kernel<S, D, true><<<(unsigned)grid, 32 * warps, 0, stream>>>(p, s, sl, a);
  else
    cache_write_kernel<S, D, false><<<(unsigned)grid, 32 * warps, 0, stream>>>(p, s, sl, a);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  n_rows = T * n_slots source
// rows (see the header for the addressing); skip_n = 0 skips nothing.  vec
// = 1 only when both types agree and every source row, every pool row and
// both bases are 16-byte aligned.  Returns a cudaError_t.
extern "C" int cache_write(void* pool, int pool_dtype, const void* src, int src_dtype,
                           long long plane_stride, long long row_stride, const void* slots,
                           long long n_rows, int n_slots, long long tensor_stride,
                           long long base_row, int skip_lo, int skip_n, int w, int vec,
                           void* stream) {
  if (n_slots <= 0 || w <= 0 || skip_n < 0 || n_rows % n_slots != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Rows a{plane_stride, row_stride, tensor_stride, base_row, n_slots, skip_lo, skip_n, w, 0, 0};
  if (src_dtype == 0 && pool_dtype == 0)
    return (int)launch<float, float>(pool, src, slots, n_rows, a, vec, s);
  if (src_dtype == 1 && pool_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(pool, src, slots, n_rows, a, vec, s);
  if (src_dtype == 0 && pool_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(pool, src, slots, n_rows, a, 0, s);
  if (src_dtype == 1 && pool_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(pool, src, slots, n_rows, a, 0, s);
  return (int)cudaErrorInvalidValue;
}
