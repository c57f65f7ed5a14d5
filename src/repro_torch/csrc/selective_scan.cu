// Mamba-1 selective scan for Hopper (sm_90a), and its per-head mode for
// Mamba-2 (below the Mamba-1 kernel).
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
// N = 16) the exponentials take longer than the bytes: 512 steps at B = 1
// are 67M of them, 0.016 ms at 4.18e12/s.
//
// Design: the TPU kernel walks the sequence in a sequential grid axis and
// carries h in VMEM scratch.  Here the recurrence is a loop inside the
// thread, and each channel's N states are spread over L = N / 4 adjacent
// lanes of 4 states each, so B * d * L threads run (at B = 1, d = 8192,
// N = 16: 32K threads, 8 warps on each of the 132 SMs, every scheduler
// busy); y_t is the sum of the L lanes' partial dot products, two xor
// shuffles at N = 16.  No split over time is needed at these widths: the
// d * N independent recurrences already fill the card.
//
// A block of BLOCK_C channels works through chunks of TC = 16 L steps.
// Each thread loads its share of the next chunk's dt, x, B and C into
// registers (16-byte loads where aligned) before it runs this chunk's
// steps, so the loads fly while it computes; between chunks the block
// writes the loaded chunk to shared memory once, as f32, with dt * x
// taken once per (step, channel): the conversion needs the values in
// registers anyway, so they are loaded there rather than copied to shared
// memory by cp.async and converted in a second pass.  Steps run U at a time, straight-line: their
// exponentials and dt * x * B first, which do not depend on h, then the
// U-step recurrence, then y, so a warp has U * 4 exponentials in flight.
// y is gathered per chunk in shared memory and written coalesced.
//
// Exponentials are the accurate expf: one MUFU.EX2 each, after a range
// reduction on the FMA pipe.  ex2.approx of dt * A * log2 e alone would
// save that reduction, but its error, compounded over the recurrence,
// reaches 1.3e-4 to 2.1e-4 in y at B = 1, S = 512 against the plain
// version's torch.exp (H100, seeds 0-2, tools/kernel_ab.py), past the
// 1e-4 bar; expf keeps it under 3e-5.  At dt = 0 expf gives exactly 1, so
// a padded step leaves h bit for bit.  All offsets are 64-bit.  Decode
// (S = 1) is one chunk of one step.
#include "cp_async.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int BLOCK_C = 32;   // channels per block
constexpr int SPL = 4;        // states per lane
constexpr int U = 8;          // steps whose exponentials are taken together

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of T as floats (bf16 -> f32 is a shift: its bits are the top
// half of the f32's)
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// VEC = 16 / sizeof(T) elements at p into a 16-byte register: one load
// when vec (p 16-byte aligned), else element by element, those at or
// past n left 0
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int n, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec && n >= VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  using Bits = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
  const Bits* q = reinterpret_cast<const Bits*>(p);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (i < n) w[i * sizeof(T) / 4] |= (uint32_t)q[i] << (8 * (i * sizeof(T) % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int K> struct VecOf;
template <> struct VecOf<2> { using type = float2; };
template <> struct VecOf<4> { using type = float4; };

// SPL consecutive floats of 16-byte aligned shared memory
__device__ __forceinline__ void load_spl(const float* p, float (&v)[SPL]) {
  using V = typename VecOf<SPL>::type;
  *reinterpret_cast<V*>(v) = *reinterpret_cast<const V*>(p);
}

// grid (ceil(d / BLOCK_C), B), block BLOCK_C * N / SPL threads: channel
// c0 + tid / L, states (tid % L) * SPL + [0, SPL).  vec: dt, x, B and C
// are read 16 bytes at a time (d and S * N multiples of 16 bytes' worth
// of elements, 16-byte aligned bases).
template <typename T, int N>
__global__ void __launch_bounds__(BLOCK_C * N / SPL)
selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ hout, int S,
                      int d, int vec) {
  constexpr int L = N / SPL;                 // lanes per channel
  constexpr int NT = BLOCK_C * L;            // threads
  constexpr int TC = 16 * L;                 // steps per chunk
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int XU = TC * BLOCK_C / VEC / NT;            // dt (and x) loads per thread
  constexpr int BU = (TC * N / VEC + NT - 1) / NT;       // B (and C) loads per thread
  // the chunk as the steps read it: f32, dt * x taken once per (step,
  // channel)
  __shared__ __align__(16) float f_dt[TC][BLOCK_C];
  __shared__ __align__(16) float f_dx[TC][BLOCK_C];
  __shared__ __align__(16) float f_B[TC * N];
  __shared__ __align__(16) float f_C[TC * N];
  __shared__ __align__(16) float s_y[TC][BLOCK_C];

  const int tid = threadIdx.x, cl = tid / L, n0 = (tid % L) * SPL;
  const int c0 = blockIdx.x * BLOCK_C, c = c0 + cl;
  const int cols = min(BLOCK_C, d - c0);
  const int64_t b = blockIdx.y;
  const bool live = c < d;
  const int64_t state0 = (b * d + c) * N + n0;   // h0/hout offset of this lane's states
  const int64_t row0 = b * S;                    // row of (b, t = 0)

  // the next chunk's dt, x, B and C, in flight in registers while this
  // chunk's steps run
  uint4 rdt[XU], rx[XU], rb[BU], rc[BU];
  auto load = [&](int k) {
    const int t0 = k * TC, nt = min(TC, S - t0);
#pragma unroll
    for (int j = 0; j < XU; ++j) {
      const int i = tid + j * NT, t = i / (BLOCK_C / VEC), cu = i % (BLOCK_C / VEC) * VEC;
      const int n = t < nt ? cols - cu : 0;
      const int64_t off = (row0 + t0 + t) * d + c0 + cu;
      rdt[j] = load16(dt + off, n, vec);
      rx[j] = load16(x + off, n, vec);
    }
    const int64_t bc0 = (row0 + t0) * N;     // B/C rows of the chunk: contiguous
#pragma unroll
    for (int j = 0; j < BU; ++j) {
      const int e = (tid + j * NT) * VEC;
      rb[j] = load16(Bm + bc0 + e, nt * N - e, vec);
      rc[j] = load16(Cm + bc0 + e, nt * N - e, vec);
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < XU; ++j) {
      const int i = tid + j * NT, t = i / (BLOCK_C / VEC), cu = i % (BLOCK_C / VEC) * VEC;
      float fd[VEC], fx[VEC];
      unpack(rdt[j], fd);
      unpack(rx[j], fx);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        f_dt[t][cu + e] = fd[e];
        f_dx[t][cu + e] = fd[e] * fx[e];
      }
    }
#pragma unroll
    for (int j = 0; j < BU; ++j) {
      const int e0 = (tid + j * NT) * VEC;
      if (e0 < TC * N) {
        float fb[VEC], fc[VEC];
        unpack(rb[j], fb);
        unpack(rc[j], fc);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          f_B[e0 + e] = fb[e];
          f_C[e0 + e] = fc[e];
        }
      }
    }
  };
  auto store_y = [&](int k) {
    const int t0 = k * TC, nt = min(TC, S - t0);
    for (int i = tid; i < nt * BLOCK_C; i += NT) {
      const int t = i / BLOCK_C, cc = i % BLOCK_C;
      if (cc < cols) y[(row0 + t0 + t) * d + c0 + cc] = s_y[t][cc];
    }
  };

  float a[SPL], h[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    a[i] = live ? A[(int64_t)c * N + n0 + i] : 0.f;
    h[i] = (live && h0 != nullptr) ? h0[state0 + i] : 0.f;
  }

  // steps tu .. tu + UU - 1 of the staged chunk
  auto steps = [&](int tu, auto uu) {
    constexpr int UU = decltype(uu)::value;
    float e[UU][SPL], w[UU][SPL], cv[UU][SPL];
#pragma unroll
    for (int u = 0; u < UU; ++u) {
      const float dtv = f_dt[tu + u][cl], dx = f_dx[tu + u][cl];
      float bv[SPL];
      load_spl(&f_B[(tu + u) * N + n0], bv);
      load_spl(&f_C[(tu + u) * N + n0], cv[u]);
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        e[u][i] = expf(dtv * a[i]);
        w[u][i] = dx * bv[i];
      }
    }
    float part[UU];
#pragma unroll
    for (int u = 0; u < UU; ++u) {
      part[u] = 0.f;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        h[i] = fmaf(e[u][i], h[i], w[u][i]);
        part[u] = fmaf(h[i], cv[u][i], part[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UU; ++u) {
#pragma unroll
      for (int o = 1; o < L; o <<= 1) part[u] += __shfl_xor_sync(0xffffffffu, part[u], o);
      if (n0 == 0) s_y[tu + u][cl] = part[u];
    }
  };

  const int n_chunks = (S + TC - 1) / TC;
  load(0);
  for (int k = 0; k < n_chunks; ++k) {
    const int nt = min(TC, S - k * TC);
    __syncthreads();                          // the last chunk's steps are done
    if (k > 0) store_y(k - 1);
    put();
    __syncthreads();
    if (k + 1 < n_chunks) load(k + 1);
    // U steps at a time, straight-line: their exponentials and dt * x * B
    // first (no dependence on h), then the recurrence, then y; the last
    // steps of a chunk one at a time
    int tu = 0;
    for (; tu + U <= nt; tu += U) steps(tu, std::integral_constant<int, U>());
    for (; tu < nt; ++tu) steps(tu, std::integral_constant<int, 1>());
  }
  __syncthreads();
  store_y(n_chunks - 1);
  if (live) {
#pragma unroll
    for (int i = 0; i < SPL; ++i) hout[state0 + i] = h[i];
  }
}

template <typename T, int N>
cudaError_t launch(const void* dt, const void* x, const void* A, const void* Bm,
                   const void* Cm, const void* h0, void* y, void* hout, int B,
                   int S, int d, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t bases = (uintptr_t)dt | (uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm;
  const int vec = d % VEC == 0 && (int64_t)S * N % VEC == 0 && bases % 16 == 0;
  dim3 grid((d + BLOCK_C - 1) / BLOCK_C, B);
  selective_scan_kernel<T, N><<<grid, BLOCK_C * N / SPL, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), S, d, vec);
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

// ---------------------------------------------------------------------------
// Per-head mode (selective_scan_heads): Mamba-2, whose reference is the
// lax.scan over _ssm2_step in repro/models/mamba.py.  Channels come in
// heads of P, and dt [B, S, H] and A [H] are one per head:
//
//   h_t = exp(dt_t[h] * A[h]) * h_{t-1} + (dt_t[h] * x_t) * B_t
//   y_t = h_t . C_t
//
// over h [B, H, P, N] (the memory of [B, d, N], d = H * P), one B/C group.
//
// Bound: operations, but no longer the exponentials.  P is a multiple of
// HBLOCK_C, so a block's channels share one head, and dA_t = expf(dt_t *
// A[h]) is taken once per (step, block) when the chunk is staged, beside
// dt * x once per (step, channel).  What is left per (t, c, n) is three
// f32 instructions: dt * x * B, the FMA into h, the FMA into y.  At
// zamba2's widths (d = 7168, N = 64) a 512-step call at B = 1 is 0.70 G
// of them, 0.021 ms over the f32 lanes; the bytes (x, y once each) take
// a third of that.
//
// Design: Mamba-1's layout (4 states a lane, 16 lanes a channel at N = 64)
// measured 0.146 ms here (H100, 14% of the bound): per step each lane
// paid two shared-memory loads for its 4 states of B and C, one for
// dt * x, one for dA and four shuffles to sum y, against 12 FMAs, so the
// shared-memory and shuffle pipes, not the FMAs, set the pace.  Here a
// lane holds a 4 x 4 tile: 4 channels by 4 states.  Per step it loads
// dt * x of its 4 channels, B and C of its 4 states (one 16-byte load
// each) and dA, and does 48 FMA-pipe instructions; the 16 lanes of a
// channel quad sum its 4 partial y's in 5 shuffles (a transposed
// reduction: halve the values each lane keeps at each of the first two
// steps), and the lanes holding the sums store y straight to device
// memory, 32 bytes a warp a step.  Blocks of HBLOCK_C = 32 channels (128
// threads) take the sequence in chunks of HTC steps, each thread loading
// its share of the next chunk into registers while this one runs from
// shared memory, as in the Mamba-1 kernel; steps run HU at a time,
// straight-line, so one step's shuffles overlap the next one's FMAs.
// The bf16 instance stores the final state 16 bytes a channel (hout
// starts on 16 bytes): at decode the state is most of the bytes, and that
// runs 6-8% faster on the H100.  16-byte loads of h0 were faster still at
// decode but slowed prefill by up to 1.9%, and any 16-byte state access
// spills the f32 instance, which ptxas holds at 168 registers.
// On the H100, 8 steps at a time ran faster than 4; chunks of 64 steps
// and blocks of 16 channels did not help at zamba2's shapes.  The
// exponential is the accurate expf (at
// dt = 0 it gives exactly 1, so a padded step leaves h bit for bit).  All
// offsets are 64-bit.
constexpr int HN = 64;                    // state size
constexpr int HC = 4;                     // channels per lane
constexpr int HS = 4;                     // states per lane
constexpr int HL = HN / HS;               // lanes per channel quad
constexpr int HBLOCK_C = 32;              // channels per block
constexpr int HNT = HBLOCK_C / HC * HL;   // threads per block
constexpr int HTC = 32;                   // steps per chunk
constexpr int HU = 8;                     // steps run together

template <typename T>
__global__ void __launch_bounds__(HNT)
selective_scan_heads_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                            const float* __restrict__ A,
                            const T* __restrict__ Bm, const T* __restrict__ Cm,
                            const float* __restrict__ h0,
                            float* __restrict__ y, float* __restrict__ hout,
                            int S, int H, int P, int vec) {
  constexpr int VEC = 16 / sizeof(T);           // elements per 16-byte load
  constexpr int XN = HTC * HBLOCK_C / VEC;      // 16-byte x loads per chunk
  constexpr int XU = (XN + HNT - 1) / HNT;      // per thread
  constexpr int BU = (HTC * HN / VEC + HNT - 1) / HNT;   // B (and C) loads per thread
  // the chunk as the steps read it, in f32: dt * x per (step, channel),
  // exp(dt * A) per step, B and C per (step, state)
  __shared__ __align__(16) float f_dx[HTC][HBLOCK_C];
  __shared__ __align__(16) float f_B[HTC * HN];
  __shared__ __align__(16) float f_C[HTC * HN];
  __shared__ float f_dA[HTC];

  const int d = H * P;
  const int tid = threadIdx.x, l = tid % HL, n0 = l * HS;
  const int cl = tid / HL * HC;                 // first channel of the quad, in the block
  const int c0 = blockIdx.x * HBLOCK_C, hh = c0 / P;
  const int64_t b = blockIdx.y;
  const int64_t row0 = b * S;                   // row of (b, t = 0)
  const float ah = A[hh];

  // the next chunk in flight in registers: x (with its step's dt), B, C,
  // and the dt of step tid for dA
  uint4 rx[XU], rb[BU], rc[BU];
  float rdx[XU], rda = 0.f;
  auto load = [&](int k) {
    const int t0 = k * HTC, nt = min(HTC, S - t0);
#pragma unroll
    for (int j = 0; j < XU; ++j) {
      const int i = tid + j * HNT, t = i / (HBLOCK_C / VEC);
      const int cu = i % (HBLOCK_C / VEC) * VEC;
      const bool in = i < XN && t < nt;
      rx[j] = load16(x + (row0 + t0 + t) * d + c0 + cu, in ? VEC : 0, vec);
      rdx[j] = in ? to_f(dt[(row0 + t0 + t) * H + hh]) : 0.f;
    }
    if (tid < HTC) rda = tid < nt ? to_f(dt[(row0 + t0 + tid) * H + hh]) : 0.f;
    const int64_t bc0 = (row0 + t0) * HN;       // B/C rows of the chunk: contiguous
#pragma unroll
    for (int j = 0; j < BU; ++j) {
      const int e = (tid + j * HNT) * VEC;
      rb[j] = load16(Bm + bc0 + e, nt * HN - e, vec);
      rc[j] = load16(Cm + bc0 + e, nt * HN - e, vec);
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < XU; ++j) {
      const int i = tid + j * HNT, t = i / (HBLOCK_C / VEC);
      const int cu = i % (HBLOCK_C / VEC) * VEC;
      if (XN % HNT != 0 && i >= XN) break;
      float fx[VEC];
      unpack(rx[j], fx);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f_dx[t][cu + e] = rdx[j] * fx[e];
    }
    if (tid < HTC) f_dA[tid] = expf(rda * ah);
#pragma unroll
    for (int j = 0; j < BU; ++j) {
      const int e0 = (tid + j * HNT) * VEC;
      if (e0 < HTC * HN) {
        float fb[VEC], fc[VEC];
        unpack(rb[j], fb);
        unpack(rc[j], fc);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          f_B[e0 + e] = fb[e];
          f_C[e0 + e] = fc[e];
        }
      }
    }
  };
  float h[HC][HS];
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int n = 0; n < HS; ++n)
      h[c][n] = h0 != nullptr ? h0[(b * d + c0 + cl + c) * HN + n0 + n] : 0.f;

  // steps tu .. tu + UU - 1 of chunk row t0's staged chunk: the
  // recurrence and each channel's partial y over this lane's states, then
  // the sums over the quad's 16 lanes (lane bits 3 and 2 pick the channel
  // each lane keeps; lanes 0, 4, 8, 12 of the quad store channels 0-3, so
  // a warp stores 8 adjacent floats a step)
  const bool hi8 = l & 8, hi4 = l & 4;
  float* yq = y + c0 + cl + (hi8 ? 2 : 0) + (hi4 ? 1 : 0);
  auto steps = [&](int64_t t0, int tu, auto uu) {
    constexpr int UU = decltype(uu)::value;
    float yp[UU][HC];
#pragma unroll
    for (int u = 0; u < UU; ++u) {
      const int t = tu + u;
      const float dA = f_dA[t];
      const float4 xv = *reinterpret_cast<const float4*>(&f_dx[t][cl]);
      const float4 bv = *reinterpret_cast<const float4*>(&f_B[t * HN + n0]);
      const float4 cv = *reinterpret_cast<const float4*>(&f_C[t * HN + n0]);
      const float xs[HC] = {xv.x, xv.y, xv.z, xv.w};
      const float bs[HS] = {bv.x, bv.y, bv.z, bv.w};
      const float cs[HS] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        yp[u][c] = 0.f;
#pragma unroll
        for (int n = 0; n < HS; ++n) {
          h[c][n] = fmaf(dA, h[c][n], xs[c] * bs[n]);
          yp[u][c] = fmaf(h[c][n], cs[n], yp[u][c]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UU; ++u) {
      // lanes l and l ^ 8: keep channels (hi8 ? 2 : 0) + {0, 1}
      float k0 = hi8 ? yp[u][2] : yp[u][0], k1 = hi8 ? yp[u][3] : yp[u][1];
      const float s0 = hi8 ? yp[u][0] : yp[u][2], s1 = hi8 ? yp[u][1] : yp[u][3];
      k0 += __shfl_xor_sync(0xffffffffu, s0, 8);
      k1 += __shfl_xor_sync(0xffffffffu, s1, 8);
      // lanes l and l ^ 4: keep channel (hi8 ? 2 : 0) + (hi4 ? 1 : 0)
      float k = hi4 ? k1 : k0;
      k += __shfl_xor_sync(0xffffffffu, hi4 ? k0 : k1, 4);
      k += __shfl_xor_sync(0xffffffffu, k, 2);
      k += __shfl_xor_sync(0xffffffffu, k, 1);
      if ((l & 3) == 0) yq[(row0 + t0 + tu + u) * d] = k;
    }
  };

  const int n_chunks = (S + HTC - 1) / HTC;
  load(0);
  for (int k = 0; k < n_chunks; ++k) {
    const int64_t t0 = (int64_t)k * HTC;
    const int nt = min(HTC, S - k * HTC);
    __syncthreads();                          // the last chunk's steps are done
    put();
    __syncthreads();
    if (k + 1 < n_chunks) load(k + 1);
    int tu = 0;
    for (; tu + HU <= nt; tu += HU) steps(t0, tu, std::integral_constant<int, HU>());
    for (; tu < nt; ++tu) steps(t0, tu, std::integral_constant<int, 1>());
  }
  // the final state: 16 bytes a channel, 4 in the f32 instance (above)
#pragma unroll
  for (int c = 0; c < HC; ++c) {
    float* const hc = hout + (b * d + c0 + cl + c) * HN + n0;
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<float4*>(hc) = make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
    } else {
#pragma unroll
      for (int n = 0; n < HS; ++n) hc[n] = h[c][n];
    }
  }
}

template <typename T>
cudaError_t launch_heads(const void* dt, const void* x, const void* A,
                         const void* Bm, const void* Cm, const void* h0,
                         void* y, void* hout, int B, int S, int H, int P,
                         cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // x, B and C 16 bytes at a time (dt is read one element at a time)
  const uintptr_t bases = (uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm;
  const int vec = bases % 16 == 0 && P % VEC == 0;
  // the final state 16 bytes at a time
  if ((uintptr_t)hout % 16 != 0) return cudaErrorInvalidValue;
  dim3 grid(H * P / HBLOCK_C, B);
  selective_scan_heads_kernel<T><<<grid, HNT, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), S, H, P, vec);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward of both modes (training): selective_scan_bwd (Mamba-1) and
// selective_scan_heads_bwd (the per-head mode).  They compute the gradient
// of selective_scan_tpu (repro/kernels/selective_scan/kernel.py), which the
// JAX package takes with jax.grad through lax.scan over _ssm1_step /
// _ssm2_step (repro/models/mamba.py); the Pallas kernel has no backward.
// With g_t the gradient with respect to h_t (from dh_final):
//
//   g_t   = dA_{t+1} g_{t+1} + dy_t C_t
//   dC_t  = sum_c dy_t h_t          dB_t = sum_c g_t dt_t x_t
//   dx_t  = sum_n g_t dt_t B_t      ddt_t = sum_n g_t (A dA_t h_{t-1} + x_t B_t)
//   dA    = sum_{b,t} g_t dt_t dA_t h_{t-1}      dh0 = dA_0 g_0
//
// (per-head mode: ddt and dA also sum over the head's P channels).
//
// Bound (chip_smoke.py::scan_bwd_bound): operations.  The least f32
// instructions per (step, channel, state) over the f32 lanes, or one
// exponential per (step, channel, state) (Mamba-1; the per-head mode one
// a step and head) over the special-function units, whichever is larger;
// the bytes (dt, x, B, C and dy read once, ddt, dx, dB and dC written
// once) take less.  The instructions: the state rebuilt (dt x B and its
// FMA), g (g dA and its FMA with dy C), dC, dB and dx (one FMA each), then
// Mamba-1's q = g dA h_{t-1} and its FMAs into dA and ddt: 10; the
// per-head mode's dA and ddt factor through s_t = sum g dA h_{t-1}, one
// FMA: 8.  0.161 ms at falcon-mamba-7b's training shape (B 2, S 2048, d
// 8192, N 16, bf16), 0.225 ms at zamba2-7b's widths (B 1, S 2048, H 112,
// P 64, N 64) on an H100 at 700 W.
//
// The states are never rebuilt by inverting the recurrence (h_{t-1} = (h_t
// - dt x B) / dA): dA = exp(dt A) underflows to 0 at Mamba-1's A down to
// -N.  A block runs the recurrence forward from h0 (pass 1), writing the
// state every CK steps to the scratch buffer hs, then walks the sequence
// backward (pass 2), rebuilding each CK-step interval's states from the
// saved one and running the reverse recurrence over them.
//
// Design.  A block holds BWD_C = 64 channels of one lane b (per-head mode:
// of one head; a block past the last multiple of 64 masks its tail, whose
// warps run on zeros and write nothing) and stages the sequence in chunks
// of BWD_TC = 16 steps through a ring of two stages in shared memory, each
// filled by 16-byte cp.async (8-byte for a bf16 B / C row at N = 4): the
// next chunk in the walk's direction is copied while this one runs (pass 1
// forward; pass 2 backward, also copying dy, C and the chunk's saved
// states).  Once a chunk has landed the block converts it to f32 in shared
// memory: dt, dt * x and x (and dy) once per (step, channel), B and C once
// per (step, state), dA = exp(dt A) once per (step, head) in the per-head
// mode.  No lane loads from device memory inside the step loops; the per-head
// dt ([B, S, H], one element at a stride of H) is loaded a chunk ahead into
// lanes 0-15 of every warp, which hand it to the converting lanes by
// shuffles.  Two block barriers a chunk (the copies landed; the chunk
// converted), none inside it.
//
// Mamba-1 (selective_scan_bwd_kernel<T, N>): a thread holds one channel by
// 4 states (the forward's L = N / 4 lanes a channel), a warp 32 / L
// channels by all N states, a block 64 L threads: at N = 16, 256 threads
// and at most 128 registers, two blocks an SM, so falcon-mamba's training
// grid (128 x 2 blocks) is resident in one wave (the other instances ask
// for as many blocks as their shared memory holds, which leaves them more
// registers).  CK = 8: pass 2 first takes an interval's 32 exponentials
// into shared memory, one float4 a (step, thread), then rebuilds its 9
// states in registers (hist[9][4]) from them, so neither the rebuild nor
// the reverse step holds an exponential in flight, and each exponential
// is taken twice in all (pass 1, pass 2).  The reverse step is 8 f32
// instructions a state (g +=
// dy C; the dC, dB and dx terms; g dA; (g dA) h_{t-1}, whose A- and
// dt-weighted sums are ddt's first term and dA), then two reductions: dx
// and ddt over the channel's L lanes (two values, transposed: the lower
// lanes keep dx's sum, the upper ddt's; 2 shuffles at N = 16) and dB, dC
// over the warp's channels (8 values transposed over xor 16, 8 and 4:
// 4 + 2 + 1 = 7 shuffles, after which each lane holds one of the warp's
// 2N sums).  Those go to shared memory, one slot a (step, warp); at the
// end of each chunk the block adds its warps in order into its partial of
// dB and dC and writes dx and ddt coalesced.
//
// Per-head mode (selective_scan_heads_bwd_kernel<T>): dA_t is one value a
// step, so the gradient takes no exponential a state and its cost is f32
// instructions.  A thread holds 4 channels by 2 states (B and C read as
// 8-byte broadcasts), a warp 32 channels by 8 states, a block 512 threads
// over 64 channels of one head: at zamba2-7b's widths 112 blocks of 16
// warps at most 128 registers a thread, one block an SM, the whole grid
// resident at once.  CK = 16 = the staged chunk, but a thread keeps the
// states of only 4 steps in registers (hist[5][4][2]): pass 2 runs forward
// from the chunk's saved state to the starts of its 4-step sub-chunks
// (kept in shared memory), then for each sub-chunk, last first, rebuilds
// its states and runs the reverse step.  ddt and dA factor through s_t =
// sum_{c,n} g_t h_{t-1}, since A and dA_t are one a head: ddt_t = A dA_t
// s_t + sum_c x_c (sum_n g_t B_n), dA = sum_t dt_t dA_t s_t, so the reverse
// step is 6 f32 instructions a (channel, state) (g += dy C; the dC, dB, dx
// and s terms; g dA).  Each thread folds its part of ddt_t into one value
// (5 shuffles sum the warp's); dB and dC (4 values over the warp's 8
// channel groups: 4 shuffles) and dx (4 channels over the warp's 4 state
// lanes: 3 shuffles) go to shared memory, and the block adds its warps in
// order at the end of each chunk.
//
// Determinism: no atomics.  Every sum runs in a fixed order (in a thread;
// across lanes by fixed xor levels; across warps in warp order; across
// blocks and lanes b by fold_kernel, in block order), so every call gives
// the same bits.  ddt, dx, dB and dC are rounded once to the inputs' type;
// dA and dh0 are f32.  Exponentials are expf, as in the forward, and the
// states are rebuilt with the forward's arithmetic (fmaf(dA, h, (dt * x) *
// B)).  All offsets are 64-bit.
//
// Scratch, f32, each byte written once and read once.  Mamba-1: hs [B, S /
// 8, d, N], pB and pC [d / 64, B, S, N], pA [B, d, N]; at falcon-mamba's
// training shape 268 + 2 x 34 + 1 MB, 0.67 GB moved a call (0.81 GB with
// 32-channel blocks).  Per-head: hs [B, S / 16, d, N], pB and pC
// [H ceil(P / 64), B, S, N], pdt [B, S, H, ceil(P / 64)], pA [H, B,
// ceil(P / 64)]; at zamba2's widths 235 + 2 x 59 + 1 MB, 0.71 GB moved
// (1.41 GB with states saved every 8 steps and 32-channel blocks).
//
// These replace a first, simple pair of backward kernels (each thread
// loading its own inputs from device memory every step, each exponential
// three times, 24-28 shuffles a step, two barriers every 8 steps, 32-channel
// blocks; 161-173 registers in the per-head mode, two waves), which took
// 3.40 ms and 6.34 ms device at the two shapes above (H100 80GB HBM3,
// 700 W; PERF.md).
constexpr int BWD_C = 64;          // channels a backward block holds
constexpr int BWD_TC = 16;         // steps a backward block stages at a time
constexpr int BWD_CK = 8;          // Mamba-1: steps between saved states
constexpr int HB_CK = BWD_TC;      // per-head: steps between saved states
constexpr int HB_SUB = 4;          // per-head: steps whose states a thread holds
constexpr int HB_NT = 512;         // per-head: threads a block
constexpr unsigned FULLW = 0xffffffffu;
static_assert(BWD_C == HN, "the per-head staging indexes B / C rows as channel rows");

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

using cpa::cp_async;
using cpa::cp_async_commit;
using cpa::cp_async_wait;

// rows of `bytes` each (a multiple of PIECE) from src (row stride gstride
// bytes) to dst (row stride sstride), in PIECE-byte copies over NT threads
template <int NT, int PIECE>
__device__ __forceinline__ void stage_rows(char* dst, int sstride, const void* src,
                                           int64_t gstride, int rows, int bytes, int tid) {
  const char* s = static_cast<const char*>(src);
  const int per = bytes / PIECE;
  for (int i = tid; i < rows * per; i += NT) {
    const int r = i / per, p = i - r * per;
    cp_async<PIECE>(dst + r * sstride + p * PIECE, s + r * gstride + p * PIECE);
  }
}

// One level of a transposed xor reduction over lanes l and l ^ o: of the K
// values v holds, lanes with bit o set keep the upper K / 2, the others
// the lower, each adding its partner's copy (K / 2 shuffles)
template <int K>
__device__ __forceinline__ void tsum(float* v, int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < K / 2; ++i) {
    const float send = up ? v[i] : v[i + K / 2];
    const float keep = up ? v[i + K / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(FULLW, send, o);
  }
}

// Mamba-1 backward: its threads and its dynamic shared memory (byte
// offsets)
template <typename T, int N>
struct Bwd1 {
  static constexpr int SZ = sizeof(T);
  static constexpr int L = N / SPL;              // lanes a channel
  static constexpr int NT = BWD_C * L;           // threads a block
  static constexpr int NW = NT / 32;             // warps a block
  static constexpr int NI = BWD_TC / BWD_CK;     // saved states a chunk
  static constexpr int BP = N * SZ < 16 ? N * SZ : 16;   // B / C copy bytes
  // a ring stage: the chunk as it lies in device memory
  static constexpr int R_DT = 0;                                 // T [TC][C]
  static constexpr int R_X = R_DT + BWD_TC * BWD_C * SZ;         // T [TC][C]
  static constexpr int R_DY = R_X + BWD_TC * BWD_C * SZ;         // f32 [TC][C]
  static constexpr int R_B = R_DY + BWD_TC * BWD_C * 4;          // T [TC][N]
  static constexpr int R_C = R_B + align16(BWD_TC * N * SZ);     // T [TC][N]
  static constexpr int R_H = R_C + align16(BWD_TC * N * SZ);     // f32 [NI][C][N]
  static constexpr int STAGE = R_H + NI * BWD_C * N * 4;
  // the chunk in f32, an interval's exponentials, the warps' sums
  static constexpr int F_CH = 2 * STAGE;                   // float4 [TC][C]: dt, dt x, x, dy
  static constexpr int F_B = F_CH + BWD_TC * BWD_C * 16;   // [TC][N]
  static constexpr int F_C = F_B + BWD_TC * N * 4;         // [TC][N]
  static constexpr int S_E = F_C + BWD_TC * N * 4;         // float4 [CK][NT]
  static constexpr int S_RED = S_E + BWD_CK * NT * 16;     // [TC][NW][2N]: dB, dC
  static constexpr int S_OUT = S_RED + BWD_TC * NW * 2 * N * 4;   // float2 [TC][C]: dx, ddt
  static constexpr int SMEM = S_OUT + BWD_TC * BWD_C * 8;
  // blocks an SM asked of the compiler: as many as shared memory holds
  // (227 KB, 1 KB reserved a block), at most 512 threads' worth; only at
  // bf16, N = 16 does that cap registers (at 128: two blocks an SM)
  static constexpr int FIT = (227 * 1024) / (SMEM + 1024);
  static constexpr int MINB = FIT < 512 / NT ? (FIT > 0 ? FIT : 1) : 512 / NT;
};

// grid (ceil(d / 64), B), Bwd1::NT threads, Bwd1::SMEM bytes of dynamic
// shared memory.  hs [B, ceil(S / 8), d, N]; pB / pC [ceil(d / 64), B, S,
// N]: each block's sums of dB / dC over its channels; pA [B, d, N]: each
// lane's dA.  ddt, dx [B, S, d] in T, dh0 [B, d, N] f32.
template <typename T, int N>
__global__ void __launch_bounds__(Bwd1<T, N>::NT, Bwd1<T, N>::MINB)
selective_scan_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm, const float* __restrict__ h0,
                          const float* __restrict__ dy,
                          const float* __restrict__ dhf, float* __restrict__ hs,
                          T* __restrict__ ddt, T* __restrict__ dx,
                          float* __restrict__ dh0, float* __restrict__ pB,
                          float* __restrict__ pC, float* __restrict__ pA, int S,
                          int d) {
  using G = Bwd1<T, N>;
  constexpr int L = G::L, NT = G::NT, NW = G::NW, NI = G::NI, SZ = G::SZ;
  constexpr int TC = BWD_TC, CK = BWD_CK;
  extern __shared__ __align__(16) char smem[];
  float4* f_ch = reinterpret_cast<float4*>(smem + G::F_CH);
  float* f_B = reinterpret_cast<float*>(smem + G::F_B);
  float* f_C = reinterpret_cast<float*>(smem + G::F_C);
  float4* s_e = reinterpret_cast<float4*>(smem + G::S_E);
  float* s_red = reinterpret_cast<float*>(smem + G::S_RED);
  float2* s_out = reinterpret_cast<float2*>(smem + G::S_OUT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / L, l = tid % L, n0 = l * SPL;
  const int blk = blockIdx.x, c0 = blk * BWD_C, cols = min(BWD_C, d - c0);
  const bool live = cl < cols;
  const int64_t b = blockIdx.y, nb = gridDim.y, row0 = b * S;
  const int64_t state0 = (b * d + c0 + cl) * N + n0;   // h0 / dh_final / dh0 / pA
  const int nch = (S + TC - 1) / TC, nck = (S + CK - 1) / CK;
  // the block's saved state k: hs[b][k][c0 .. c0 + 64)[N]
  auto saved = [&](int k) { return hs + ((b * nck + k) * d + c0) * N; };

  float a[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) a[i] = live ? A[(int64_t)(c0 + cl) * N + n0 + i] : 0.f;

  // chunk k's dt, x and B (pass 2: also dy, C and its saved states) into
  // ring stage k & 1, as one cp.async group
  auto fetch = [&](int k, bool rev) {
    char* st = smem + (k & 1) * G::STAGE;
    const int t0 = k * TC, nt = min(TC, S - t0);
    const int64_t r = row0 + t0;
    stage_rows<NT, 16>(st + G::R_DT, BWD_C * SZ, dt + r * d + c0, (int64_t)d * SZ, nt,
                       cols * SZ, tid);
    stage_rows<NT, 16>(st + G::R_X, BWD_C * SZ, x + r * d + c0, (int64_t)d * SZ, nt,
                       cols * SZ, tid);
    stage_rows<NT, G::BP>(st + G::R_B, 0, Bm + r * N, 0, 1, nt * N * SZ, tid);
    if (rev) {
      stage_rows<NT, 16>(st + G::R_DY, BWD_C * 4, dy + r * d + c0, (int64_t)d * 4, nt,
                         cols * 4, tid);
      stage_rows<NT, G::BP>(st + G::R_C, 0, Cm + r * N, 0, 1, nt * N * SZ, tid);
#pragma unroll
      for (int j = 0; j < NI; ++j)
        if (k * NI + j < nck)
          stage_rows<NT, 16>(st + G::R_H + j * BWD_C * N * 4, 0, saved(k * NI + j), 0, 1,
                             cols * N * 4, tid);
    }
    cp_async_commit();
  };
  // chunk k from its ring stage to f32: zeros past the sequence's end and
  // the block's live channels
  auto convert = [&](int k, bool rev) {
    const char* st = smem + (k & 1) * G::STAGE;
    const int nt = min(TC, S - k * TC);
    const T* r_dt = reinterpret_cast<const T*>(st + G::R_DT);
    const T* r_x = reinterpret_cast<const T*>(st + G::R_X);
    const float* r_dy = reinterpret_cast<const float*>(st + G::R_DY);
    const T* r_b = reinterpret_cast<const T*>(st + G::R_B);
    const T* r_c = reinterpret_cast<const T*>(st + G::R_C);
    for (int i = tid; i < TC * BWD_C; i += NT) {
      const int t = i / BWD_C, cc = i % BWD_C;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < nt && cc < cols) {
        const float dtv = to_f(r_dt[i]), xv = to_f(r_x[i]);
        v = make_float4(dtv, dtv * xv, xv, rev ? r_dy[i] : 0.f);
      }
      f_ch[i] = v;
    }
    for (int i = tid; i < TC * N; i += NT) {
      const bool in = i < nt * N;
      f_B[i] = in ? to_f(r_b[i]) : 0.f;
      if (rev) f_C[i] = in ? to_f(r_c[i]) : 0.f;
    }
  };

  // 1. forward from h0, saving the state at the start of every interval
  float h[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) h[i] = (live && h0 != nullptr) ? h0[state0 + i] : 0.f;
  auto fstep = [&](int u) {
    const float4 ch = f_ch[u * BWD_C + cl];
    const float4 bv = *reinterpret_cast<const float4*>(f_B + u * N + n0);
    const float bs[SPL] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < SPL; ++i) h[i] = fmaf(expf(ch.x * a[i]), h[i], ch.y * bs[i]);
  };
  fetch(0, false);
  for (int k = 0; k < nch; ++k) {
    cp_async_wait<0>();
    __syncthreads();                  // chunk k landed; chunk k - 1's steps done
    convert(k, false);
    if (k + 1 < nch) fetch(k + 1, false);
    __syncthreads();
    const int nt = min(TC, S - k * TC);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int u0 = j * CK;
      if (u0 < nt) {
        if (live)
          *reinterpret_cast<float4*>(saved(k * NI + j) + cl * N + n0) =
              make_float4(h[0], h[1], h[2], h[3]);
        if (nt - u0 >= CK) {
#pragma unroll
          for (int u = 0; u < CK; ++u) fstep(u0 + u);
        } else {
          for (int u = 0; u < nt - u0; ++u) fstep(u0 + u);
        }
      }
    }
  }

  // 2. the intervals in reverse
  float g[SPL], accA[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    g[i] = (live && dhf != nullptr) ? dhf[state0 + i] : 0.f;
    accA[i] = 0.f;
  }
  // chunk k's sums: its warps' dB / dC in warp order into the block's
  // partial; dx and ddt to device memory
  auto flush = [&](int k) {
    const int t0 = k * TC, nt = min(TC, S - t0);
    for (int i = tid; i < nt * 2 * N; i += NT) {
      const int u = i / (2 * N), j = i % (2 * N);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += s_red[(u * NW + w) * 2 * N + j];
      (j < N ? pB : pC)[((blk * nb + b) * S + t0 + u) * N + j % N] = s;
    }
    for (int i = tid; i < nt * BWD_C; i += NT) {
      const int u = i / BWD_C, cc = i % BWD_C;
      if (cc < cols) {
        const float2 v = s_out[i];
        const int64_t o = (row0 + t0 + u) * d + c0 + cc;
        dx[o] = from_f<T>(v.x);
        ddt[o] = from_f<T>(v.y);
      }
    }
  };
  // reverse step u of the staged chunk, uu of its interval; hp / hn the
  // states before / after it
  auto rstep = [&](int u, int uu, const float (&hp)[SPL], const float (&hn)[SPL]) {
    const float4 ch = f_ch[u * BWD_C + cl];                      // dt, dt x, x, dy
    const float4 bv = *reinterpret_cast<const float4*>(f_B + u * N + n0);
    const float4 cv = *reinterpret_cast<const float4*>(f_C + u * N + n0);
    const float4 ev = s_e[uu * NT + tid];                        // dA_t
    const float bs[SPL] = {bv.x, bv.y, bv.z, bv.w}, cs[SPL] = {cv.x, cv.y, cv.z, cv.w};
    const float es[SPL] = {ev.x, ev.y, ev.z, ev.w};
    float v[2 * SPL], sgb = 0.f, sga = 0.f;       // v: dB terms, then dC terms
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      g[i] = fmaf(ch.w, cs[i], g[i]);                            // g_t
      v[SPL + i] = ch.w * hn[i];
      v[i] = g[i] * ch.y;
      sgb = fmaf(g[i], bs[i], sgb);
      const float ge = g[i] * es[i];                             // to h_{t-1}
      const float q = ge * hp[i];
      sga = fmaf(a[i], q, sga);
      accA[i] = fmaf(ch.x, q, accA[i]);
      g[i] = ge;
    }
    // dx = dt sum_n g B and ddt = sum_n a g dA h + x sum_n g B over the
    // channel's L lanes: the lower half keeps dx's sum, the upper ddt's
    float w[2] = {sgb, fmaf(ch.z, sgb, sga)};
    if constexpr (L == 1) {
      s_out[u * BWD_C + cl] = make_float2(ch.x * w[0], w[1]);
    } else {
      tsum<2>(w, lane, L / 2);
#pragma unroll
      for (int o = L / 4; o >= 1; o >>= 1) w[0] += __shfl_xor_sync(FULLW, w[0], o);
      const bool up = l & (L / 2);
      if ((l & (L / 2 - 1)) == 0)
        reinterpret_cast<float*>(s_out + u * BWD_C + cl)[up] = up ? w[0] : ch.x * w[0];
    }
    // dB and dC over the warp's 32 / L channels: 8 values transposed over
    // xor 16, 8, 4, then plain levels down to L; lane bits 4-2 name the
    // value (dB or dC, one of the lane's 4 states) the lane ends with
    tsum<8>(v, lane, 16);
    tsum<4>(v, lane, 8);
    tsum<2>(v, lane, 4);
#pragma unroll
    for (int o = 2; o >= L; o >>= 1) v[0] += __shfl_xor_sync(FULLW, v[0], o);
    const int vi = (lane >> 2) & 7;
    if ((lane & (3 & ~(L - 1))) == 0)
      s_red[(u * NW + warp) * 2 * N + (vi >> 2) * N + n0 + (vi & 3)] = v[0];
  };
  // rebuild step u of the staged chunk (uu of its interval): hout = dA
  // hin + (dt x) B with dA from s_e
  auto bstep = [&](int u, int uu, const float (&hin)[SPL], float (&hout)[SPL]) {
    const float4 ch = f_ch[u * BWD_C + cl];
    const float4 bv = *reinterpret_cast<const float4*>(f_B + u * N + n0);
    const float4 ev = s_e[uu * NT + tid];
    const float bs[SPL] = {bv.x, bv.y, bv.z, bv.w}, es[SPL] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
    for (int i = 0; i < SPL; ++i) hout[i] = fmaf(es[i], hin[i], ch.y * bs[i]);
  };
  // interval j (n steps) of the staged chunk in stage st: its
  // exponentials, once each, into s_e; then its states rebuilt into
  // registers; then its reverse steps
  auto interval = [&](const char* st, int j, int n, auto full) {
    constexpr bool FULL = decltype(full)::value;
    const int u0 = j * CK;
    for (int u = 0; u < n; ++u) {
      const float dtv = f_ch[(u0 + u) * BWD_C + cl].x;
      s_e[u * NT + tid] = make_float4(expf(dtv * a[0]), expf(dtv * a[1]),
                                      expf(dtv * a[2]), expf(dtv * a[3]));
    }
    float hist[CK + 1][SPL];
    const float4 h4 = live ? *reinterpret_cast<const float4*>(
                                 reinterpret_cast<const float*>(st + G::R_H) +
                                 j * BWD_C * N + cl * N + n0)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    hist[0][0] = h4.x; hist[0][1] = h4.y; hist[0][2] = h4.z; hist[0][3] = h4.w;
#pragma unroll
    for (int u = 0; u < CK; ++u)
      if (FULL || u < n) bstep(u0 + u, u, hist[u], hist[u + 1]);
#pragma unroll
    for (int u = CK - 1; u >= 0; --u)
      if (FULL || u < n) rstep(u0 + u, u, hist[u], hist[u + 1]);
  };

  __syncthreads();                    // pass 1's saved states before their copies
  fetch(nch - 1, true);
  for (int k = nch - 1; k >= 0; --k) {
    cp_async_wait<0>();
    __syncthreads();                  // chunk k landed; chunk k + 1's steps done
    if (k + 1 < nch) flush(k + 1);
    convert(k, true);
    if (k > 0) fetch(k - 1, true);
    __syncthreads();
    const char* st = smem + (k & 1) * G::STAGE;
    const int nt = min(TC, S - k * TC);
    for (int j = (nt - 1) / CK; j >= 0; --j) {
      const int n = min(CK, nt - j * CK);
      if (n == CK)
        interval(st, j, n, std::true_type());
      else
        interval(st, j, n, std::false_type());
    }
  }
  __syncthreads();
  flush(0);
  if (live) {
    *reinterpret_cast<float4*>(dh0 + state0) = make_float4(g[0], g[1], g[2], g[3]);
    *reinterpret_cast<float4*>(pA + state0) =
        make_float4(accA[0], accA[1], accA[2], accA[3]);
  }
}

// Per-head backward: its dynamic shared memory (byte offsets)
template <typename T>
struct BwdH {
  static constexpr int SZ = sizeof(T);
  static constexpr int NT = HB_NT, NW = NT / 32;
  static constexpr int NSUB = HB_CK / HB_SUB;    // sub-chunks a chunk
  // a ring stage: the chunk as it lies in device memory
  static constexpr int R_X = 0;                                  // T [TC][C]
  static constexpr int R_DY = R_X + BWD_TC * BWD_C * SZ;         // f32 [TC][C]
  static constexpr int R_B = R_DY + BWD_TC * BWD_C * 4;          // T [TC][N]
  static constexpr int R_C = R_B + BWD_TC * HN * SZ;             // T [TC][N]
  static constexpr int R_H = R_C + BWD_TC * HN * SZ;             // f32 [C][N]: saved state
  static constexpr int STAGE = R_H + BWD_C * HN * 4;
  // the chunk in f32
  static constexpr int F_X = 2 * STAGE;                          // [TC][C]: x
  static constexpr int F_DTX = F_X + BWD_TC * BWD_C * 4;         // [TC][C]: dt x
  static constexpr int F_DY = F_DTX + BWD_TC * BWD_C * 4;        // [TC][C]: dy
  static constexpr int F_B = F_DY + BWD_TC * BWD_C * 4;          // [TC][N]
  static constexpr int F_C = F_B + BWD_TC * HN * 4;              // [TC][N]
  static constexpr int F_ST = F_C + BWD_TC * HN * 4;             // float4 [TC]: dA, dt dA, A dA, dt
  // each thread's states at the sub-chunk starts 1 .. NSUB - 1
  static constexpr int S_SUB = F_ST + BWD_TC * 16;               // float4 [NSUB - 1][2][NT]
  // the warps' sums: dB / dC by channel half, dt sum_n g B by state
  // eighth, ddt by warp; dA by warp
  static constexpr int S_BC = S_SUB + (NSUB - 1) * 2 * NT * 16;  // [TC][2][2][N]
  static constexpr int S_G = S_BC + BWD_TC * 4 * HN * 4;         // [TC][8][C]
  static constexpr int S_U = S_G + BWD_TC * 8 * BWD_C * 4;       // [TC][NW]
  static constexpr int S_A = S_U + BWD_TC * NW * 4;              // [NW]
  static constexpr int SMEM = S_A + NW * 4;
};

// grid (H ceil(P / 64), B), HB_NT threads, BwdH::SMEM bytes of dynamic
// shared memory; block (hh ceil(P / 64) + jb) holds channels jb * 64 .. of
// head hh.  hs [B, ceil(S / 16), H * P, N]; pB / pC [H ceil(P / 64), B, S,
// N]; pdt [B, S, H, ceil(P / 64)]: each block's ddt; pA [H, B, ceil(P /
// 64)]: each block's dA.  dx [B, S, H * P] in T, dh0 [B, H, P, N] f32.
template <typename T>
__global__ void __launch_bounds__(HB_NT, 1)
selective_scan_heads_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                                const float* __restrict__ A,
                                const T* __restrict__ Bm, const T* __restrict__ Cm,
                                const float* __restrict__ h0,
                                const float* __restrict__ dy,
                                const float* __restrict__ dhf,
                                float* __restrict__ hs, T* __restrict__ dx,
                                float* __restrict__ dh0, float* __restrict__ pB,
                                float* __restrict__ pC, float* __restrict__ pdt,
                                float* __restrict__ pA, int S, int H, int P) {
  using G = BwdH<T>;
  constexpr int NT = G::NT, NW = G::NW, SZ = G::SZ, TC = BWD_TC, SUB = HB_SUB;
  extern __shared__ __align__(16) char smem[];
  float* f_x = reinterpret_cast<float*>(smem + G::F_X);
  float* f_dtx = reinterpret_cast<float*>(smem + G::F_DTX);
  float* f_dy = reinterpret_cast<float*>(smem + G::F_DY);
  float* f_B = reinterpret_cast<float*>(smem + G::F_B);
  float* f_C = reinterpret_cast<float*>(smem + G::F_C);
  float4* f_st = reinterpret_cast<float4*>(smem + G::F_ST);
  float4* s_sub = reinterpret_cast<float4*>(smem + G::S_SUB);
  float* s_bc = reinterpret_cast<float*>(smem + G::S_BC);
  float* s_g = reinterpret_cast<float*>(smem + G::S_G);
  float* s_u = reinterpret_cast<float*>(smem + G::S_U);
  float* s_a = reinterpret_cast<float*>(smem + G::S_A);

  const int d = H * P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bph = (P + BWD_C - 1) / BWD_C;
  const int hh = blockIdx.x / bph, jb = blockIdx.x % bph;
  const int c0 = hh * P + jb * BWD_C, cols = min(BWD_C, P - jb * BWD_C);
  // warp: channel half cs, state eighth ss; lane: channel group (bits 4-2)
  // and state pair (bits 1-0)
  const int cs = warp >> 3, ss = warp & 7;
  const int cb = cs * 32 + (lane >> 2) * HC;     // the thread's 4 channels, in the block
  const int nb0 = ss * 8 + (lane & 3) * 2;       // its 2 states
  const bool live = cb < cols;
  const int64_t b = blockIdx.y, nbat = gridDim.y, row0 = b * S;
  const int nch = (S + TC - 1) / TC;
  const float ah = A[hh];
  auto saved = [&](int k) { return hs + ((b * nch + k) * d + c0) * HN; };
  auto state_at = [&](int j) { return (b * d + c0 + cb + j) * HN + nb0; };

  // chunk k's x and B (pass 2: also dy, C and its saved state) into ring
  // stage k & 1, as one cp.async group; its dt into rdt of lanes 0 .. 15
  float rdt = 0.f;
  auto fetch = [&](int k, bool rev) {
    char* st = smem + (k & 1) * G::STAGE;
    const int t0 = k * TC, nt = min(TC, S - t0);
    const int64_t r = row0 + t0;
    stage_rows<NT, 16>(st + G::R_X, BWD_C * SZ, x + r * d + c0, (int64_t)d * SZ, nt,
                       cols * SZ, tid);
    stage_rows<NT, 16>(st + G::R_B, 0, Bm + r * HN, 0, 1, nt * HN * SZ, tid);
    if (rev) {
      stage_rows<NT, 16>(st + G::R_DY, BWD_C * 4, dy + r * d + c0, (int64_t)d * 4, nt,
                         cols * 4, tid);
      stage_rows<NT, 16>(st + G::R_C, 0, Cm + r * HN, 0, 1, nt * HN * SZ, tid);
      stage_rows<NT, 16>(st + G::R_H, 0, saved(k), 0, 1, cols * HN * 4, tid);
    }
    cp_async_commit();
    rdt = lane < nt ? to_f(dt[(r + lane) * H + hh]) : 0.f;
  };
  // chunk k from its ring stage to f32 (zeros past the sequence's end and
  // the block's live channels); dt of step t from lane t of each warp
  auto convert = [&](int k, bool rev) {
    const char* st = smem + (k & 1) * G::STAGE;
    const int nt = min(TC, S - k * TC);
    const T* r_x = reinterpret_cast<const T*>(st + G::R_X);
    const float* r_dy = reinterpret_cast<const float*>(st + G::R_DY);
    const T* r_b = reinterpret_cast<const T*>(st + G::R_B);
    const T* r_c = reinterpret_cast<const T*>(st + G::R_C);
#pragma unroll
    for (int j = 0; j < TC * BWD_C / NT; ++j) {   // a warp's 32 entries share a step
      const int i = tid + j * NT, t = i / BWD_C, cc = i % BWD_C;
      const float dtv = __shfl_sync(FULLW, rdt, t);
      const bool in = t < nt && cc < cols;
      const float xv = in ? to_f(r_x[i]) : 0.f;
      f_x[i] = xv;
      f_dtx[i] = dtv * xv;
      f_dy[i] = (rev && in) ? r_dy[i] : 0.f;
      f_B[i] = t < nt ? to_f(r_b[i]) : 0.f;
      if (rev) f_C[i] = t < nt ? to_f(r_c[i]) : 0.f;
    }
    if (tid < TC) {
      const float e = expf(rdt * ah);
      f_st[tid] = make_float4(e, rdt * e, ah * e, rdt);
    }
  };
  // forward step u: hout = dA hin + (dt x) B
  auto fstep = [&](int u, const float (&hin)[HC][2], float (&hout)[HC][2]) {
    const float dA = f_st[u].x;
    const float4 xv = *reinterpret_cast<const float4*>(f_dtx + u * BWD_C + cb);
    const float2 bv = *reinterpret_cast<const float2*>(f_B + u * HN + nb0);
    const float xs[HC] = {xv.x, xv.y, xv.z, xv.w}, bs[2] = {bv.x, bv.y};
#pragma unroll
    for (int j = 0; j < HC; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) hout[j][n] = fmaf(dA, hin[j][n], xs[j] * bs[n]);
  };

  // 1. forward from h0, saving the state at the start of every chunk
  float h[HC][2];
#pragma unroll
  for (int j = 0; j < HC; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      h[j][n] = (live && h0 != nullptr) ? h0[state_at(j) + n] : 0.f;
  fetch(0, false);
  for (int k = 0; k < nch; ++k) {
    cp_async_wait<0>();
    __syncthreads();                  // chunk k landed; chunk k - 1's steps done
    convert(k, false);
    if (k + 1 < nch) fetch(k + 1, false);
    __syncthreads();
    if (live) {
#pragma unroll
      for (int j = 0; j < HC; ++j)
        *reinterpret_cast<float2*>(saved(k) + (cb + j) * HN + nb0) =
            make_float2(h[j][0], h[j][1]);
    }
    const int nt = min(TC, S - k * TC);
    if (nt == TC) {
#pragma unroll
      for (int u = 0; u < TC; ++u) fstep(u, h, h);
    } else {
      for (int u = 0; u < nt; ++u) fstep(u, h, h);
    }
  }

  // 2. the chunks in reverse
  float g[HC][2], accA = 0.f;
#pragma unroll
  for (int j = 0; j < HC; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      g[j][n] = (live && dhf != nullptr) ? dhf[state_at(j) + n] : 0.f;
  // chunk k's sums, its warps in order: dB / dC into the block's partial,
  // dx to device memory, ddt into the block's partial
  auto flush = [&](int k) {
    const int t0 = k * TC, nt = min(TC, S - t0);
    for (int i = tid; i < nt * 2 * HN; i += NT) {
      const int u = i / (2 * HN), j = i % (2 * HN);
      const float s = s_bc[(u * 2 + 0) * 2 * HN + j] + s_bc[(u * 2 + 1) * 2 * HN + j];
      (j < HN ? pB : pC)[(((int64_t)blockIdx.x * nbat + b) * S + t0 + u) * HN + j % HN] = s;
    }
    for (int i = tid; i < nt * BWD_C; i += NT) {
      const int u = i / BWD_C, cc = i % BWD_C;
      if (cc < cols) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) s += s_g[(u * 8 + q) * BWD_C + cc];
        dx[(row0 + t0 + u) * d + c0 + cc] = from_f<T>(s);
      }
    }
    if (tid < nt) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += s_u[tid * NW + w];
      pdt[((row0 + t0 + tid) * H + hh) * bph + jb] = s;
    }
  };
  // reverse step u of the staged chunk (hp / hn the states before / after
  // it); returns the thread's part of ddt_t
  auto rstep = [&](int u, const float (&hp)[HC][2], const float (&hn)[HC][2]) {
    const float4 stv = f_st[u];                                  // dA, dt dA, A dA, dt
    const float4 xv = *reinterpret_cast<const float4*>(f_x + u * BWD_C + cb);
    const float4 dv = *reinterpret_cast<const float4*>(f_dtx + u * BWD_C + cb);
    const float4 yv = *reinterpret_cast<const float4*>(f_dy + u * BWD_C + cb);
    const float2 bv = *reinterpret_cast<const float2*>(f_B + u * HN + nb0);
    const float2 cv = *reinterpret_cast<const float2*>(f_C + u * HN + nb0);
    const float xs[HC] = {xv.x, xv.y, xv.z, xv.w}, dxs[HC] = {dv.x, dv.y, dv.z, dv.w};
    const float ys[HC] = {yv.x, yv.y, yv.z, yv.w};
    const float bs[2] = {bv.x, bv.y}, csv[2] = {cv.x, cv.y};
    float v[4] = {0.f, 0.f, 0.f, 0.f}, sg[HC], s = 0.f;   // v: dB (2 states), dC (2)
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      sg[j] = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        g[j][n] = fmaf(ys[j], csv[n], g[j][n]);                  // g_t
        v[2 + n] = fmaf(ys[j], hn[j][n], v[2 + n]);
        v[n] = fmaf(g[j][n], dxs[j], v[n]);
        sg[j] = fmaf(g[j][n], bs[n], sg[j]);
        s = fmaf(g[j][n], hp[j][n], s);
        g[j][n] *= stv.x;                                        // to h_{t-1}
      }
    }
    float du = stv.z * s;
#pragma unroll
    for (int j = 0; j < HC; ++j) du = fmaf(xs[j], sg[j], du);
    accA = fmaf(stv.y, s, accA);
    // dB and dC over the warp's 8 channel groups: transposed over xor 16,
    // 8, plain over xor 4; lane bits 4-3 name the value the lane ends with
    tsum<4>(v, lane, 16);
    tsum<2>(v, lane, 8);
    v[0] += __shfl_xor_sync(FULLW, v[0], 4);
    if (!(lane & 4)) {
      const int vi = (lane >> 3) & 3;
      s_bc[((u * 2 + cs) * 2 + (vi >> 1)) * HN + nb0 + (vi & 1)] = v[0];
    }
    // dx over the warp's 4 state lanes: transposed over xor 2, 1; lane
    // bits 1-0 name the channel
    tsum<4>(sg, lane, 2);
    tsum<2>(sg, lane, 1);
    s_g[(u * 8 + ss) * BWD_C + cb + (lane & 3)] = stv.w * sg[0];
    return du;
  };
  // sub-chunk q (n steps) of the staged chunk: its states rebuilt from the
  // saved state (q = 0, sv) or its start in s_sub, then its reverse steps,
  // each followed by the warp's sum of its ddt part
  auto sub = [&](const float* sv, int q, int n, auto full) {
    constexpr bool FULL = decltype(full)::value;
    float hist[SUB + 1][HC][2];
    if (q == 0) {
#pragma unroll
      for (int j = 0; j < HC; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          hist[0][j][m] = live ? sv[(cb + j) * HN + nb0 + m] : 0.f;
    } else {
      const float4 p0 = s_sub[((q - 1) * 2 + 0) * NT + tid];
      const float4 p1 = s_sub[((q - 1) * 2 + 1) * NT + tid];
      hist[0][0][0] = p0.x; hist[0][0][1] = p0.y; hist[0][1][0] = p0.z; hist[0][1][1] = p0.w;
      hist[0][2][0] = p1.x; hist[0][2][1] = p1.y; hist[0][3][0] = p1.z; hist[0][3][1] = p1.w;
    }
#pragma unroll
    for (int u = 0; u < SUB; ++u)
      if (FULL || u < n) fstep(q * SUB + u, hist[u], hist[u + 1]);
#pragma unroll
    for (int u = SUB - 1; u >= 0; --u) {
      if (FULL || u < n) {
        float du = rstep(q * SUB + u, hist[u], hist[u + 1]);
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) du += __shfl_xor_sync(FULLW, du, o);
        if (lane == 0) s_u[(q * SUB + u) * NW + warp] = du;
      }
    }
  };

  __syncthreads();                    // pass 1's saved states before their copies
  fetch(nch - 1, true);
  for (int k = nch - 1; k >= 0; --k) {
    cp_async_wait<0>();
    __syncthreads();                  // chunk k landed; chunk k + 1's steps done
    if (k + 1 < nch) flush(k + 1);
    convert(k, true);
    if (k > 0) fetch(k - 1, true);
    __syncthreads();
    const float* sv = reinterpret_cast<const float*>(smem + (k & 1) * G::STAGE + G::R_H);
    const int nt = min(TC, S - k * TC), nsub = (nt + SUB - 1) / SUB;
    // the states at the starts of sub-chunks 1 .. nsub - 1
#pragma unroll
    for (int j = 0; j < HC; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m) h[j][m] = live ? sv[(cb + j) * HN + nb0 + m] : 0.f;
    for (int q = 1; q < nsub; ++q) {
#pragma unroll
      for (int u = 0; u < SUB; ++u) fstep((q - 1) * SUB + u, h, h);
      s_sub[((q - 1) * 2 + 0) * NT + tid] = make_float4(h[0][0], h[0][1], h[1][0], h[1][1]);
      s_sub[((q - 1) * 2 + 1) * NT + tid] = make_float4(h[2][0], h[2][1], h[3][0], h[3][1]);
    }
    for (int q = nsub - 1; q >= 0; --q) {
      const int n = min(SUB, nt - q * SUB);
      if (n == SUB)
        sub(sv, q, n, std::true_type());
      else
        sub(sv, q, n, std::false_type());
    }
  }
  __syncthreads();
  flush(0);
  if (live) {
#pragma unroll
    for (int j = 0; j < HC; ++j)
      *reinterpret_cast<float2*>(dh0 + state_at(j)) = make_float2(g[j][0], g[j][1]);
  }
  // dA: the thread's sum over its steps, the warp's lanes, the block's
  // warps in order
  float s = accA;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(FULLW, s, o);
  if (lane == 0) s_a[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) t += s_a[w];
    pA[((int64_t)hh * nbat + b) * bph + jb] = t;
  }
}

// out[i] = sum_{j < m} in[i * si + j * sj] in order, for i < n: the fixed
// order fold of the backward's partials
template <typename TO>
__global__ void __launch_bounds__(256)
fold_kernel(const float* __restrict__ in, TO* __restrict__ out, int64_t n,
            int m, int64_t si, int64_t sj) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = in + i * si;
  float s = 0.f;
  for (int j = 0; j < m; ++j) s += p[j * sj];
  out[i] = from_f<TO>(s);
}

template <typename TO>
cudaError_t fold(const float* in, void* out, int64_t n, int m, int64_t si,
                 int64_t sj, cudaStream_t stream) {
  const int64_t blocks = (n + 255) / 256;
  fold_kernel<TO><<<(unsigned)blocks, 256, 0, stream>>>(
      in, static_cast<TO*>(out), n, m, si, sj);
  return cudaGetLastError();
}

// a kernel's dynamic shared memory above the 48 KB default, with the SM's
// shared memory preferred over L1 so that Mamba-1's blocks fit two an SM
template <typename K>
cudaError_t allow_smem(K* kern, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// ws: hs, pB, pC, pA as above
template <typename T, int N>
cudaError_t launch_bwd(const void* dt, const void* x, const void* A,
                       const void* Bm, const void* Cm, const void* h0,
                       const void* dy, const void* dhf, void* ddt, void* dx,
                       void* dA, void* dB, void* dC, void* dh0, void* hs,
                       void* pB, void* pC, void* pA, int B, int S, int d,
                       cudaStream_t stream) {
  using G = Bwd1<T, N>;
  static const cudaError_t attr = allow_smem(selective_scan_bwd_kernel<T, N>, G::SMEM);
  if (attr != cudaSuccess) return attr;
  const int nblk = (d + BWD_C - 1) / BWD_C;
  selective_scan_bwd_kernel<T, N><<<dim3(nblk, B), G::NT, G::SMEM, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dhf),
      static_cast<float*>(hs), static_cast<T*>(ddt), static_cast<T*>(dx),
      static_cast<float*>(dh0), static_cast<float*>(pB), static_cast<float*>(pC),
      static_cast<float*>(pA), S, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t bsn = (int64_t)B * S * N;
  if ((err = fold<T>(static_cast<const float*>(pB), dB, bsn, nblk, 1, bsn, stream)))
    return err;
  if ((err = fold<T>(static_cast<const float*>(pC), dC, bsn, nblk, 1, bsn, stream)))
    return err;
  // dA [d, N]: the lanes' in order
  return fold<float>(static_cast<const float*>(pA), dA, (int64_t)d * N, B, 1,
                     (int64_t)d * N, stream);
}

template <typename T>
cudaError_t dispatch_bwd(const void* dt, const void* x, const void* A,
                         const void* Bm, const void* Cm, const void* h0,
                         const void* dy, const void* dhf, void* ddt, void* dx,
                         void* dA, void* dB, void* dC, void* dh0, void* hs,
                         void* pB, void* pC, void* pA, int B, int S, int d,
                         int N, cudaStream_t s) {
#define BWD(NN) launch_bwd<T, NN>(dt, x, A, Bm, Cm, h0, dy, dhf, ddt, dx, dA, dB, \
                                  dC, dh0, hs, pB, pC, pA, B, S, d, s)
  switch (N) {
    case 4: return BWD(4);
    case 8: return BWD(8);
    case 16: return BWD(16);
    default: return cudaErrorInvalidValue;
  }
#undef BWD
}

template <typename T>
cudaError_t launch_heads_bwd(const void* dt, const void* x, const void* A,
                             const void* Bm, const void* Cm, const void* h0,
                             const void* dy, const void* dhf, void* ddt, void* dx,
                             void* dA, void* dB, void* dC, void* dh0, void* hs,
                             void* pB, void* pC, void* pdt, void* pA, int B, int S,
                             int H, int P, cudaStream_t stream) {
  using G = BwdH<T>;
  static const cudaError_t attr = allow_smem(selective_scan_heads_bwd_kernel<T>, G::SMEM);
  if (attr != cudaSuccess) return attr;
  const int bph = (P + BWD_C - 1) / BWD_C, nblk = H * bph;
  selective_scan_heads_bwd_kernel<T><<<dim3(nblk, B), HB_NT, G::SMEM, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dhf),
      static_cast<float*>(hs), static_cast<T*>(dx), static_cast<float*>(dh0),
      static_cast<float*>(pB), static_cast<float*>(pC), static_cast<float*>(pdt),
      static_cast<float*>(pA), S, H, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t bsn = (int64_t)B * S * HN;
  if ((err = fold<T>(static_cast<const float*>(pB), dB, bsn, nblk, 1, bsn, stream)))
    return err;
  if ((err = fold<T>(static_cast<const float*>(pC), dC, bsn, nblk, 1, bsn, stream)))
    return err;
  // ddt [B, S, H]: a head's blocks in order; dA [H]: its lanes' and blocks'
  if ((err = fold<T>(static_cast<const float*>(pdt), ddt, (int64_t)B * S * H, bph,
                     bph, 1, stream)))
    return err;
  return fold<float>(static_cast<const float*>(pA), dA, H, B * bph,
                     (int64_t)B * bph, 1, stream);
}

// out: threads, dynamic shared bytes, registers, local (spilled) bytes and
// resident blocks an SM of one backward kernel instance
template <typename K>
cudaError_t kernel_info(K* kern, int threads, int smem, int* out) {
  cudaError_t e = allow_smem(kern, smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, smem);
  if (e != cudaSuccess) return e;
  out[0] = threads;
  out[1] = smem;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = blocks;
  return cudaSuccess;
}

template <typename T>
cudaError_t bwd_info(int heads, int N, int* out) {
  if (heads) {
    if (N != HN) return cudaErrorInvalidValue;
    return kernel_info(selective_scan_heads_bwd_kernel<T>, HB_NT, BwdH<T>::SMEM, out);
  }
  switch (N) {
    case 4: return kernel_info(selective_scan_bwd_kernel<T, 4>, Bwd1<T, 4>::NT,
                               Bwd1<T, 4>::SMEM, out);
    case 8: return kernel_info(selective_scan_bwd_kernel<T, 8>, Bwd1<T, 8>::NT,
                               Bwd1<T, 8>::SMEM, out);
    case 16: return kernel_info(selective_scan_bwd_kernel<T, 16>, Bwd1<T, 16>::NT,
                                Bwd1<T, 16>::SMEM, out);
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

// The per-head mode: dt [B, S, H], x [B, S, H * P], A [H], B/C [B, S, N],
// h0 / hout [B, H, P, N]; dtype as above.  P must be a multiple of
// HBLOCK_C (a block's channels in one head) and N 64; hout starts on 16
// bytes.  Returns the launch's cudaError_t; nothing synchronises.
extern "C" int selective_scan_heads(const void* dt, const void* x,
                                    const void* A, const void* Bm,
                                    const void* Cm, const void* h0, void* y,
                                    void* hout, int dtype, int B, int S, int H,
                                    int P, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % HBLOCK_C != 0 || N != HN ||
      (int64_t)H * P > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_heads<float>(dt, x, A, Bm, Cm, h0, y, hout, B, S, H, P, s);
  if (dtype == 1)
    return (int)launch_heads<__nv_bfloat16>(dt, x, A, Bm, Cm, h0, y, hout, B,
                                            S, H, P, s);
  return (int)cudaErrorInvalidValue;
}

// Mamba-1's backward.  dy [B, S, d] f32 (the gradient of y), dh_final
// [B, d, N] f32 or null (zeros); h0 as in the forward.  Writes ddt, dx
// [B, S, d] and dB, dC [B, S, N] in the inputs' type (dtype as above), dA
// [d, N] and dh0 [B, d, N] in f32.  Scratch, all f32: hs [B, ceil(S / 8),
// d, N], pB and pC [ceil(d / 64), B, S, N], pA [B, d, N].  d must be a
// multiple of 32; dt, x, B, C and dy 16-byte aligned.  Returns the first
// failing launch's cudaError_t; nothing synchronises.
extern "C" int selective_scan_bwd(const void* dt, const void* x, const void* A,
                                  const void* Bm, const void* Cm,
                                  const void* h0, const void* dy,
                                  const void* dhf, void* ddt, void* dx,
                                  void* dA, void* dB, void* dC, void* dh0,
                                  void* hs, void* pB, void* pC, void* pA,
                                  int dtype, int B, int S, int d, int N,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || d <= 0 || d % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_bwd<float>(dt, x, A, Bm, Cm, h0, dy, dhf, ddt, dx, dA,
                                    dB, dC, dh0, hs, pB, pC, pA, B, S, d, N, s);
  if (dtype == 1)
    return (int)dispatch_bwd<__nv_bfloat16>(dt, x, A, Bm, Cm, h0, dy, dhf, ddt,
                                            dx, dA, dB, dC, dh0, hs, pB, pC, pA,
                                            B, S, d, N, s);
  return (int)cudaErrorInvalidValue;
}

// The per-head mode's backward: dt [B, S, H], x and dy [B, S, H * P], A
// [H], B/C [B, S, N], h0 and dh_final [B, H, P, N] (either may be null).
// Writes ddt [B, S, H], dx [B, S, H * P], dB and dC [B, S, N] in the
// inputs' type, dA [H] and dh0 [B, H, P, N] in f32.  Scratch, all f32: hs
// [B, ceil(S / 16), H * P, N], pB and pC [H ceil(P / 64), B, S, N], pdt
// [B, S, H, ceil(P / 64)], pA [H, B, ceil(P / 64)].  P a multiple of 32,
// N 64; x, B, C and dy 16-byte aligned.  Returns the first failing
// launch's cudaError_t; nothing synchronises.
extern "C" int selective_scan_heads_bwd(const void* dt, const void* x,
                                        const void* A, const void* Bm,
                                        const void* Cm, const void* h0,
                                        const void* dy, const void* dhf,
                                        void* ddt, void* dx, void* dA,
                                        void* dB, void* dC, void* dh0,
                                        void* hs, void* pB, void* pC,
                                        void* pdt, void* pA, int dtype, int B,
                                        int S, int H, int P, int N,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 32 != 0 || N != HN ||
      (int64_t)H * P > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_heads_bwd<float>(dt, x, A, Bm, Cm, h0, dy, dhf, ddt, dx,
                                        dA, dB, dC, dh0, hs, pB, pC, pdt, pA, B,
                                        S, H, P, s);
  if (dtype == 1)
    return (int)launch_heads_bwd<__nv_bfloat16>(dt, x, A, Bm, Cm, h0, dy, dhf,
                                                ddt, dx, dA, dB, dC, dh0, hs, pB,
                                                pC, pdt, pA, B, S, H, P, s);
  return (int)cudaErrorInvalidValue;
}

// One backward instance as the card runs it (heads: the per-head mode's,
// else Mamba-1's at state size N; dtype as above): out[0..4] = threads a
// block, dynamic shared bytes a block, registers a thread, local (spilled)
// bytes a thread, resident blocks an SM (the occupancy API).  Returns a
// cudaError_t.
extern "C" int selective_scan_bwd_info(int heads, int dtype, int N, int* out) {
  if (dtype == 0) return (int)bwd_info<float>(heads, N, out);
  if (dtype == 1) return (int)bwd_info<__nv_bfloat16>(heads, N, out);
  return (int)cudaErrorInvalidValue;
}
