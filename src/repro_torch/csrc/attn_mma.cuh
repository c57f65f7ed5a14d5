// One bf16 tensor-core attention tile for Hopper (sm_90a), shared by the
// chunked-prefill paged attention (paged_attention.cu) and flash attention
// (flash_attention.cu).
//
// A block of NW warps owns 16 query rows per warp.  The caller's
// problem object says where each query row and each key's K and V rows
// live and at which position each query row sits; this tile walks the
// caller's range of key tiles and leaves each warp's rows as an f32 online
// softmax state (row max m in log2 units, row sum l, unnormalised output
// acc) in registers, for the caller's epilogue to store.
//
// Per key tile of BK keys:
//   - K and V rows are staged as bf16 in a ring of STAGES shared-memory
//     buffers by 16-byte cp.async.cg copies (commit_group / wait_group), so
//     the next tile's copies fly while this one is computed.  Rows are
//     padded by 16 bytes (LD = D + 8), so the eight rows an ldmatrix phase
//     reads fall in eight different bank groups.  Keys past the caller's
//     limit are zero-filled (cp.async with source size 0), never read.
//   - S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 accumulate): Q's
//     A-fragments are loaded once with ldmatrix and kept in registers (D <=
//     128; at D = 256 they are re-read from shared memory per tile, which
//     keeps the 128 accumulator registers of O out of spills), K's
//     B-fragments come from ldmatrix on the K rows.
//   - Scores are scaled after the product (by 1/sqrt(D), as the TPU kernels
//     do, times log2 e so the exponentials are exp2, in the exponent's
//     FMA).  Only edge tiles (the causal diagonal, the window's first key,
//     the key limit) compute a mask: a masked score counts as the finite
//     NEG_INF for the row max, and its probability is set to exactly 0, so
//     a masked key adds nothing to l or acc and a row that sees no key
//     keeps l = 0, acc = 0.
//   - Row max and row sum are shuffles across the four lanes that share a
//     row; l stays a per-lane partial sum until the end of the walk.
//   - P is rounded to bf16 and packed into A-fragments in registers (no
//     shared-memory round trip); O += P V takes V's B-fragments through
//     ldmatrix.trans.  l sums the rounded P, so numerator and denominator
//     weigh each key alike and the output's error stays at its own
//     rounding.
//
// Bound: at long tiles the two products (4 * rows * keys * D operations
// on the tensor cores) and the exponentials; at short query tiles the
// bytes of K and V, which the callers attack with more blocks (split-KV in
// flash attention).  mma.sync, not wgmma: its 16-row M fits the short
// tiles of the serving path (decode rows, 32-row text chunks, folded GQA
// rows), and paged K/V rows (2 * D bytes, strided by Kh * D across pages)
// are not one TMA box.  A wgmma + TMA + warp-specialised version of this
// tile is later work.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_WARPS = 4;

// Tile shape per head dim: keys per tile, ring depth, Q kept in registers.
// Any D that is a multiple of 16 up to 256 (the products step 16 deep and
// 16 wide); above that the O accumulators no longer fit a warp's registers
// (MLA's 576-wide latent rows run on attn_latent.cuh instead).
template <int D>
struct Cfg {
  static_assert(D % 16 == 0 && D >= 32 && D <= 256, "head dim 16k, 32 <= D <= 256");
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr bool Q_REGS = D <= 128;
  static constexpr int LD = D + 8;          // padded row, in elements
  static constexpr int CH = D / 8;          // 16-byte chunks per row
  static size_t smem_bytes(int rows) {       // rows: the block's query rows
    return (size_t)(rows + STAGES * 2 * BK) * LD * sizeof(bf16);
  }
};

// The softmax state of the two rows a lane holds (g and g + 8 of its
// warp's 16, g = lane / 4): m in log2 units, l, and for each 8-column
// tile n of the output the columns 8n + 2 (lane % 4) and the next one.
template <int D>
struct RowState {
  float acc[D / 8][4];
  float m[2], l[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when !valid, reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b for one 16x8x16 tile: bf16 A (row) and B (col), f32 C
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit.  Only arguments <= 0 reach it, so
// flushing results below 2^-126 to 0 changes no sum.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the sum of the two bf16 values of a packed pair, exactly widened
__device__ __forceinline__ float pair_sum(uint32_t x) {
  return __uint_as_float(x << 16) + __uint_as_float(x & 0xffff0000u);
}

// One key tile's online-softmax update of a lane's two rows: s holds the
// raw scores; p gets the probabilities as bf16 pairs, (s[n][0], s[n][1])
// in p[n][0] and (s[n][2], s[n][3]) in p[n][1], the A-fragment halves P V
// takes, and l sums those rounded values.  Scores are scaled after the
// product (scale_log2 = log2(e) / sqrt(D), folded into exp2's FMA); with
// MASKED, bit n * 4 + e of vis says whether key (n, e) is visible, and a
// masked key counts as the finite NEG_INF for the row max and gets p = 0
// exactly.
template <int D, int BK, bool MASKED>
__device__ __forceinline__ void softmax_tile(const float (&s)[BK / 8][4], uint32_t vis,
                                             float scale_log2, RowState<D>& st,
                                             uint32_t (&p)[BK / 8][2]) {
  auto visible = [&](int n, int e) { return !MASKED || ((vis >> (n * 4 + e)) & 1u); };
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (visible(n, e)) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mx[i] = fmaxf(st.m[i], mx[i] == NEG_INF ? NEG_INF : mx[i] * scale_log2);
    alpha[i] = ex2(st.m[i] - mx[i]);
    st.m[i] = mx[i];
  }
  auto prob = [&](int n, int e) {
    return visible(n, e) ? ex2(fmaf(s[n][e], scale_log2, -mx[e >> 1])) : 0.f;
  };
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      p[n][i] = pack_bf16(prob(n, 2 * i), prob(n, 2 * i + 1));
      rs[i] += pair_sum(p[n][i]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = alpha[i] * st.l[i] + rs[i];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.acc[n][0] *= alpha[0];
    st.acc[n][1] *= alpha[0];
    st.acc[n][2] *= alpha[1];
    st.acc[n][3] *= alpha[1];
  }
}

// Walk key tiles [kt_begin, kt_end) for the block's query rows, 16 per
// warp.  Prob provides:
//   rows_valid          query rows of this block that exist (the first ones)
//   q_base, k_base      any readable address (the source of zero-fills)
//   q_row(r)            row r's D elements, r < rows_valid
//   qpos(r)             row r's position, for any r < 16 * NW (non-decreasing)
//   kv_rows<N, STEP>(j, row)
//                       row[m] = the row index of key j + m * STEP, or -1
//                       for a key at or past kv_limit (m < N)
//   kv_row(j)           the same for one key (needed only when D / 8 does
//                       not divide the block's threads; FlashProb has none)
//   k_at(i), v_at(i)    the K and V rows of row index i
//   kv_limit, causal, window
// Key j is visible to a row at qpos when j < kv_limit, (!causal or j <=
// qpos) and (window <= 0 or j > qpos - window).  Every thread of the block
// calls this with blockDim.x = 32 * NW; smem holds Cfg<D>::smem_bytes(16
// * NW).  The block size is a template argument so that the copy loops
// unroll and a thread's row indices (for paged K/V, table lookups) are all
// looked up before its copies are issued.
template <int D, int NW, class Prob>
__device__ __forceinline__ void attend(const Prob& P, int kt_begin, int kt_end,
                                       float scale_log2, RowState<D>& st, bf16* smem) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, LD = C::LD, CH = C::CH, STAGES = C::STAGES;
  constexpr int NTHR = 32 * NW, ROWS = 16 * NW;
  static_assert((BK * CH) % NTHR == 0 && (ROWS * CH) % NTHR == 0, "copy split");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = warp * 16, g = lane / 4, tig = lane % 4;

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.f;
  st.m[0] = st.m[1] = NEG_INF;
  st.l[0] = st.l[1] = 0.f;
  if (kt_begin >= kt_end) return;

  bf16* sQ = smem;
  bf16* sKV = sQ + ROWS * LD;          // stage s: K at s * 2 * BK * LD, then V

  // When CH divides the block, thread tid copies chunk tid % CH of keys
  // tid / CH + m * NTHR / CH, their rows found with one division a tile;
  // else chunk i % CH of key i / CH for i = tid + m * NTHR, each key's row
  // looked up on its own (P.kv_row).  The second path would serve every
  // D, but costs a division by the page size per chunk: 18% and 22% more
  // device time at D = 64 and 128 on an H100 (tools/kernel_ab.py --mla).
  auto load_tile = [&](int kt, int stage) {
    constexpr int PER = BK * CH / NTHR;
    bf16* kd = sKV + stage * 2 * BK * LD;
    bf16* vd = kd + BK * LD;
    if constexpr (NTHR % CH == 0) {
      constexpr int STEP = NTHR / CH;
      const int c = tid % CH;
      int row[PER];
      P.template kv_rows<PER, STEP>(kt * BK + tid / CH, row);
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int j = tid / CH + m * STEP;
        const bool ok = row[m] >= 0;
        cp_async16(kd + j * LD + c * 8, ok ? P.k_at(row[m]) + c * 8 : P.k_base, ok);
        cp_async16(vd + j * LD + c * 8, ok ? P.v_at(row[m]) + c * 8 : P.k_base, ok);
      }
    } else {
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int i = tid + m * NTHR, j = i / CH, c = i % CH;
        const int row = P.kv_row(kt * BK + j);
        const bool ok = row >= 0;
        cp_async16(kd + j * LD + c * 8, ok ? P.k_at(row) + c * 8 : P.k_base, ok);
        cp_async16(vd + j * LD + c * 8, ok ? P.v_at(row) + c * 8 : P.k_base, ok);
      }
    }
  };

  // group 0: Q and the first tile; then one group per further tile
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NTHR) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < P.rows_valid;
    cp_async16(sQ + r * LD + c * 8, ok ? P.q_row(r) + c * 8 : P.q_base, ok);
  }
  load_tile(kt_begin, 0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < STAGES - 1; ++s) {
    if (kt_begin + s < kt_end) load_tile(kt_begin + s, s);
    cp_async_commit();
  }

  const bool active = r0 < P.rows_valid;   // this warp has a row to compute
  const int qlo = P.qpos(r0), qhi = P.qpos(r0 + 15);
  const int qp0 = P.qpos(r0 + g), qp1 = P.qpos(r0 + g + 8);
  uint32_t qf[C::Q_REGS ? D / 16 : 1][4];

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    cp_async_wait<STAGES - 2>();   // tile kt (and Q) have landed
    __syncthreads();               // ... for every thread; tile kt-1 is done
    if (kt + STAGES - 1 < kt_end) load_tile(kt + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    if (!active) continue;

    const bf16* sK = sKV + (it % STAGES) * 2 * BK * LD;
    const bf16* sV = sK + BK * LD;
    if constexpr (C::Q_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[kk], sQ + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }

    // S = Q K^T: 16 rows x BK keys per warp
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (C::Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, sQ + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        uint32_t b[4];
        ldsm_x4(b, sK + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma16816(s[2 * nn], a, b[0], b[1]);
        mma16816(s[2 * nn + 1], a, b[2], b[3]);
      }
    }

    // online softmax into bf16 pairs of P; only edge tiles compute a mask
    const int k0 = kt * BK;
    uint32_t pb[BK / 8][2];
    if (k0 + BK <= P.kv_limit && (!P.causal || k0 + BK - 1 <= qlo) &&
        (P.window <= 0 || k0 > qhi - P.window)) {
      softmax_tile<D, BK, false>(s, 0u, scale_log2, st, pb);
    } else {
      uint32_t vis = 0u;             // bit n * 4 + e: the key is visible
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * tig + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (key < P.kv_limit && (!P.causal || key <= qp) &&
              (P.window <= 0 || key > qp - P.window))
            vis |= 1u << (n * 4 + e);
        }
      softmax_tile<D, BK, true>(s, vis, scale_log2, st, pb);
    }

    // O += P V: P's bf16 pairs, laid out as its C-fragments, are the
    // A-fragments in registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pb[2 * kk][0], pb[2 * kk][1], pb[2 * kk + 1][0],
                             pb[2 * kk + 1][1]};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        ldsm_x4_t(b, sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dd * 16 +
                         (lane >> 4) * 8);
        mma16816(st.acc[2 * dd], a, b[0], b[1]);
        mma16816(st.acc[2 * dd + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();   // only empty groups are left; leave none in flight

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 1);
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 2);
  }
}

// Sets a kernel's dynamic shared-memory limit once per process (the first
// launch of each instantiation), not on every launch
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The SM count of the current device, asked once per process
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

}  // namespace attn
