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
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int n = 0; n < HS; ++n)
      hout[(b * d + c0 + cl + c) * HN + n0 + n] = h[c][n];
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
  dim3 grid(H * P / HBLOCK_C, B);
  selective_scan_heads_kernel<T><<<grid, HNT, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), S, H, P, vec);
  return cudaGetLastError();
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
// HBLOCK_C (a block's channels in one head) and N 64.  Returns the
// launch's cudaError_t; nothing synchronises.
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
