// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/selective_scan/kernel.py::
// selective_scan_tpu (body _scan_kernel).  For each lane b and channel c:
//
//   h_t = exp(dt_t * A[c]) * h_{t-1} + (dt_t * x_t) * B_t     (N states)
//   y_t = sum_n h_t[n] * C_t[n]
//
// dt/x [B, S, d] and B/C [B, S, N] in f32 or bf16 (one type for all four),
// A [d, N] f32, h0 [B, d, N] f32 or null (zeros); y [B, S, d] and the final
// h [B, d, N] come out in f32.  The state never leaves registers.
//
// Bound: operations.  Each (t, c, n) needs one exponential, which runs on
// the special-function units (16 results per clock per SM on sm_90); the
// bytes are dt, x and y once each.  At falcon-mamba widths (d = 8192,
// N = 16) the exponentials take longer than the bytes.
//
// Design: the TPU kernel walks the sequence in a sequential grid axis and
// carries h in VMEM scratch.  Here the recurrence is a loop inside the
// thread: one thread per (b, c) holds its N states in registers and steps
// through t.  A block of BLOCK_D consecutive channels stages T_CHUNK steps
// of dt and x (coalesced across channels) and of B_t/C_t (shared by the
// whole block) in shared memory, then every thread runs those steps from
// there and writes y[b, t, c] coalesced.  Accurate expf (not __expf), so
// the result agrees with the plain PyTorch version.  All offsets are
// 64-bit.  The simple shape has limits that stay for now: at B = 1 and
// d = 8192 only 128 blocks of two warps run, half of each SM's four
// schedulers idle; decode (S = 1) is one short launch per layer.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_D = 64;   // channels per block, one thread each
constexpr int T_CHUNK = 32;   // time steps staged in shared memory per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int N>
__global__ void __launch_bounds__(BLOCK_D)
selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ hout, int S,
                      int d) {
  __shared__ float s_dt[T_CHUNK][BLOCK_D];
  __shared__ float s_x[T_CHUNK][BLOCK_D];
  __shared__ float s_B[T_CHUNK * N];
  __shared__ float s_C[T_CHUNK * N];

  const int tid = threadIdx.x;
  const int c = blockIdx.x * BLOCK_D + tid;
  const int64_t b = blockIdx.y;
  const bool live = c < d;
  const int64_t state0 = (b * d + c) * N;   // h0/hout offset of (b, c, 0)
  const int64_t row0 = b * S;               // row of (b, t = 0)

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(int64_t)c * N + n] : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[state0 + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += T_CHUNK) {
    const int nt = min(T_CHUNK, S - t0);
    __syncthreads();                        // the last pass is done reading
    for (int t = 0; t < nt; ++t) {
      const int64_t off = (row0 + t0 + t) * d + c;
      s_dt[t][tid] = live ? to_f32(dt[off]) : 0.f;
      s_x[t][tid] = live ? to_f32(x[off]) : 0.f;
    }
    const int64_t bc0 = (row0 + t0) * N;    // B/C rows of this pass: contiguous
    for (int i = tid; i < nt * N; i += BLOCK_D) {
      s_B[i] = to_f32(Bm[bc0 + i]);
      s_C[i] = to_f32(Cm[bc0 + i]);
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < nt; ++t) {
        const float dtv = s_dt[t][tid];
        const float dx = dtv * s_x[t][tid];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(dtv * a[n]) * h[n] + dx * s_B[t * N + n];
          acc += h[n] * s_C[t * N + n];
        }
        y[(row0 + t0 + t) * d + c] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) hout[state0 + n] = h[n];
  }
}

template <typename T, int N>
cudaError_t launch(const void* dt, const void* x, const void* A, const void* Bm,
                   const void* Cm, const void* h0, void* y, void* hout, int B,
                   int S, int d, cudaStream_t stream) {
  dim3 grid((d + BLOCK_D - 1) / BLOCK_D, B);
  selective_scan_kernel<T, N><<<grid, BLOCK_D, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), S, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* dt, const void* x, const void* A,
                       const void* Bm, const void* Cm, const void* h0, void* y,
                       void* hout, int B, int S, int d, int N,
                       cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(dt, x, A, Bm, Cm, h0, y, hout, B, S, d, stream);
    case 8: return launch<T, 8>(dt, x, A, Bm, Cm, h0, y, hout, B, S, d, stream);
    case 16: return launch<T, 16>(dt, x, A, Bm, Cm, h0, y, hout, B, S, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (dt, x, B and C).  h0 may be null (zeros).
// Returns the launch's cudaError_t; nothing synchronises.
extern "C" int selective_scan(const void* dt, const void* x, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* hout, int dtype, int B, int S,
                              int d, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_n<float>(dt, x, A, Bm, Cm, h0, y, hout, B, S, d, N, s);
  if (dtype == 1)
    return (int)dispatch_n<__nv_bfloat16>(dt, x, A, Bm, Cm, h0, y, hout, B, S,
                                          d, N, s);
  return (int)cudaErrorInvalidValue;
}
