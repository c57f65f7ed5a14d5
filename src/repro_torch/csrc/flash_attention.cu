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
// is read and written in place.  f32 or bf16 in and out; D = 64 or 128.
//
// The TPU grid walks (b, h, q block, kv block) with the kv block innermost
// and the softmax state carried in VMEM scratch across grid steps.  CUDA
// blocks run in no order, so here one block of 128 threads owns (b, h, a
// tile of BQ = 8 * TM query rows) and loops over tiles of 64 keys: it
// stages K^T and V of the tile in shared memory as f32, and each thread
// computes a TM x 4 patch of the scores and a TM x D/16 patch of the
// output from registers (16 threads share a row group: row max and row sum
// are shuffles within a half warp).  Tiles wholly after the tile's last
// causal key or before its first window key are skipped.  TM shrinks from
// 8 towards 1 while the grid would not fill the card once (decode rows,
// short chunks).
//
// Bound: operations for long sequences (4 * Sq * Sk * D per head on the
// tensor cores, and Sq * Sk exponentials), bytes for Sq = 1 (each K/V row
// is read once).  This first version is deliberately simple: f32 products
// on CUDA cores from shared memory, one tile in flight.  Tensor cores
// (wgmma), TMA staging, warp specialisation and split-KV for short query
// tiles are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;   // 8 row groups x 16 column groups
constexpr int BK = 64;         // keys per K/V tile
constexpr int PAD = 4;         // keeps transposed rows 16-byte aligned

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

struct Strides {
  int64_t b, h, s;
};

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

template <typename T, int D, int TM>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Strides qst,
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
  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + kh * kst.h;
  const T* vb = v + b * vst.b + kh * vst.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[d * BQP + r] = q0 + r < Sq ? to_f32(qb[(q0 + r) * qst.s + d]) : 0.f;
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
        kx = to_f32(kb[(k0 + j) * kst.s + d]);
        vx = to_f32(vb[(k0 + j) * vst.s + d]);
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

  T* ob = out + b * ost.b + h * ost.h;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    if (r < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        ob[r * ost.s + tx * DC + c] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D, int TM>
cudaError_t launch_tm(const void* q, const void* k, const void* v, void* out,
                      const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                      int causal, int window, int kv_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, TM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + 8 * TM - 1) / (8 * TM), H, B);
  flash_kernel<T, D, TM><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), st[0], st[1], st[2], st[3], H, Kh, Sq, Sk, causal,
      window, kv_offset, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Strides* st, int B, int H, int Kh, int Sq, int Sk,
                   int causal, int window, int kv_offset, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the largest row tile whose grid still covers every SM once
  int tm = 8;
  while (tm > 1 && (int64_t)B * H * ((Sq + 8 * tm - 1) / (8 * tm)) < sms) tm /= 2;
  switch (tm) {
    case 8: return launch_tm<T, D, 8>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
    case 4: return launch_tm<T, D, 4>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
    case 2: return launch_tm<T, D, 2>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
    default: return launch_tm<T, D, 1>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
  }
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     const Strides* st, int B, int H, int Kh, int Sq, int Sk, int D,
                     int causal, int window, int kv_offset, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, out, st, B, H, Kh, Sq, Sk, causal, window, kv_offset, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  strides: 12 int64 values, the
// (batch, head, sequence) strides in elements of q, k, v and out, in that
// order.  Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int B, int H, int Kh, int Sq, int Sk, int D,
                               int causal, int window, int kv_offset,
                               const int64_t* strides, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  if (Kh <= 0 || H % Kh != 0) return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, out, st, B, H, Kh, Sq, Sk, D, causal, window,
                                kv_offset, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(q, k, v, out, st, B, H, Kh, Sq, Sk, D, causal,
                                        window, kv_offset, s);
  return (int)cudaErrorInvalidValue;
}
