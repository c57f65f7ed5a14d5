// The warp-specialised wgmma attention forward body for Hopper (sm_90a),
// shared by flash attention's wide bf16 forward (flash_attention.cu,
// fwd::flash_fwd_wgmma_kernel; contiguous K/V) and the bf16 chunked
// prefill over pages (paged_attention.cu, pwg::paged_prefill_wgmma_kernel;
// K/V rows looked up in a block table), and the constants, tile kinds and
// walk that flash attention's backward shares with it.
//
// A block owns BLOCK = 128 query rows of one (b, query head): two consumer
// warpgroups of BM = 64 rows and a producer warpgroup.  The caller's
// producer loads the block's Q once (q_full) and streams K and V tiles of
// BN = 64 keys through a ring of ST shared-memory stages by TMA, each
// stage's arrival counted on its `full` mbarrier (stage_acquire) and its
// release by the 8 consumer warps on its `empty` one.  Every tile is
// 64-column chunks of [64 rows][64 columns] in the 128-byte swizzle wgmma
// reads (hopper::heads_map writes it; columns past D read as zeros, so D =
// 112's second and D = 160's third chunk are part zeros).  The consumers
// (consume) walk the tiles in order; per tile each warpgroup
//   1. computes S = Q K^T [64 rows x 64 keys] on wgmma m64n64k16, both
//      operands K-major in shared memory, over the D real columns only (7
//      k-steps at 112, 10 at 160);
//   2. runs the online softmax in f32 registers in log2 units (attn_mma.cuh's
//      softmax_tile: exp2 with the 1/sqrt(D) log2(e) scale folded into its
//      FMA, P rounded to bf16 and l summing the rounded P), with a mask
//      only on tiles tile_kind calls EDGE, EMPTY tiles skipped;
//   3. adds P V [64 x DV] on wgmma m64n{DV}k16 with P in registers and the
//      V tile read MN-major where it lies: no transposed copy of V and no
//      round trip of P through shared memory.
// and leaves its two rows' state (m, l summed over the row's lanes, O
// unnormalised) in registers for the caller's epilogue.  Key j is visible
// to a row at position qpos when j < Sk and sees(qpos, j): (not causal or
// j <= qpos) and (window <= 0 or j > qpos - window).
#pragma once

#include "attn_mma.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace wgattn {

using namespace hopper;
using attn::bf16;
using attn::NEG_INF;

constexpr int BM = 64;                 // a consumer warpgroup's own rows (wgmma's M)
constexpr int BLOCK = 2 * BM;          // a block's own rows
constexpr int BN = 64;                 // rows of a streamed tile
constexpr int THREADS = 384;           // two consumer warpgroups and a producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int CONSUMER_REGS = 240;     // setmaxnreg: 256 x 240 + 128 x 24 = 64,512
constexpr int PRODUCER_REGS = 24;
constexpr int BOX = BN * 128;          // bytes of 64 rows of one 64-column chunk
constexpr size_t SMEM_MAX = 232448;    // a block's shared memory on Hopper
enum Kind { EMPTY = 0, EDGE = 1, FULL = 2 };

__device__ __forceinline__ bool sees(int qpos, int key, int causal, int window) {
  return (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// The key tiles [kt_begin, kt_end) of `bk` keys that query rows [q0, q0 +
// rows) can see, as the forward walks them.
__device__ __forceinline__ void key_tiles(int q0, int rows, int Sk, int bk, int causal,
                                          int window, int kv_offset, int& kt_begin,
                                          int& kt_end) {
  const int q_lo = kv_offset + q0, q_hi = kv_offset + q0 + rows - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  kt_begin = k_begin / bk;
  kt_end = k_end > k_begin ? (k_end + bk - 1) / bk : kt_begin;
}

// How the mask meets the tile of query rows [q0, q0 + nq) and keys [k0,
// k0 + nk), by the rule of sees(): EMPTY when no pair is visible (rows at
// or past Sq and keys at or past Sk are no pair), FULL when every pair of
// the whole tile is (none past an edge), else EDGE.  Only EDGE tiles
// compute a mask.  kernels/flash_attention/ops.py keeps a copy
// (tile_kind) that the CPU tests hold against the mask.
__device__ __forceinline__ int tile_kind(int q0, int nq, int k0, int nk, int Sq, int Sk,
                                         int causal, int window, int kv_offset) {
  const int rq = min(nq, Sq - q0), rk = min(nk, Sk - k0);
  if (rq <= 0 || rk <= 0) return EMPTY;
  const int q_lo = kv_offset + q0, q_hi = q_lo + rq - 1, k_hi = k0 + rk - 1;
  if ((causal && k0 > q_hi) || (window > 0 && k_hi <= q_lo - window)) return EMPTY;
  const bool all = rq == nq && rk == nk && (!causal || k_hi <= q_lo) &&
                   (window <= 0 || k0 > q_hi - window);
  return all ? FULL : EDGE;
}

template <class Smem>
__device__ __forceinline__ Smem& smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                  ~uintptr_t(1023));
}

// x, as a value the compiler cannot carry from one step of the tile loop to
// the next: it keeps the products' descriptors (two registers each, 32 for
// the scores at D = 256) from being hoisted out of the loop and held
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// ---------------------------------------------------------------------------
// the forward body
// ---------------------------------------------------------------------------
template <int D, int DV, int ST>
struct alignas(1024) FwdSmem {
  static constexpr int CK = (D + 63) / 64, CV = (DV + 63) / 64;   // 64-column chunks
  bf16 q[CK][BLOCK * 64];              // chunk c: [128 query rows][64 columns], swizzled
  bf16 k[ST][CK][BN * 64];             // chunk c of a stage: [64 keys][64]
  bf16 v[ST][CV][BN * 64];
  uint64_t full[ST], empty[ST], q_full;
};

// the most stages (up to 4) that fit a block's shared memory (+ the base's alignment)
template <int D, int DV>
constexpr int FWD_STAGES = sizeof(FwdSmem<D, DV, 4>) + 1024 <= SMEM_MAX   ? 4
                           : sizeof(FwdSmem<D, DV, 3>) + 1024 <= SMEM_MAX ? 3
                                                                          : 2;
template <int D, int DV>
constexpr size_t fwd_smem_bytes() {
  return sizeof(FwdSmem<D, DV, FWD_STAGES<D, DV>>) + 1024;
}

// The ring's barriers, set up by thread 0 before any thread uses them:
// each stage's `full` completes on one arrival (the producer's expected
// bytes) and `empty` on each consumer warp's release
template <class Sm, int ST>
__device__ __forceinline__ void ring_init(Sm& sm) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);   // each consumer warp releases
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer's step it: waits until the consumers released stage it %
// ST (from the second round on) and expects `bytes` on its full barrier;
// returns the stage
template <int ST, class Sm>
__device__ __forceinline__ int stage_acquire(Sm& sm, int it, unsigned bytes) {
  const int s = it % ST;
  if (it >= ST) mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
  mbar_expect(&sm.full[s], bytes);
  return s;
}

// s [64 x 64] = Q K^T over D columns: the warpgroup's 64 rows of Q at q
// (64-column chunks 2 BOX apart), the tile's 64 keys at k (chunks BOX
// apart), both K-major, swizzled; issued, not waited for
template <int D>
__device__ __forceinline__ void issue_scores(float* s, uint32_t q, uint32_t k) {
  q = opaque(q);
  k = opaque(k);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss<64, 0>(s, desc(q + (kk / 4) * 2 * BOX + (kk % 4) * 32, 16, 1024),
                  desc(k + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024), kk);
}

// o [64 x DV] += P V: P's bf16 pairs in the accumulator layout (pf[n][i]:
// row g + 8 i, keys 8 n + 2 t4 and + 1) as register A fragments, the
// tile's 64 V rows at v (chunks BOX apart) read MN-major; issued, not
// waited for
template <int DV>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (&pf)[8][2], uint32_t v) {
  v = opaque(v);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
    const uint64_t db = desc(v + kk * 16 * 128, BOX, 1024);
    if constexpr (DV == 128)
      mma_rs_n128(o, a, db);
    else if constexpr (DV == 256)
      mma_rs_n256(o, a, db);
    else
      mma_rs<DV>(o, a, db);
  }
}

// The consumers' walk (every thread of the two consumer warpgroups): the
// n_iter key tiles from kt_begin, tile it in stage it % ST, for this
// warpgroup's query rows [qw, qw + 64) of Sq (row i at position kv_offset
// + i) against Sk keys.  Leaves st as a lane's two rows' state: O
// unnormalised in wgmma's layout, m in log2 units, l summed over the
// row's four lanes.  Its own rows: qw + 16 warp + lane / 4 and + 8.
template <int D, int DV, int ST>
__device__ __forceinline__ void consume(FwdSmem<D, DV, ST>& sm, attn::RowState<DV>& st,
                                        int kt_begin, int n_iter, int qw, int Sq, int Sk,
                                        int causal, int window, int kv_offset,
                                        float scale_log2) {
  const int lane = threadIdx.x % 32, wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int t4 = lane % 4;
  const int qp0 = kv_offset + qw + warp * 16 + lane / 4, qp1 = qp0 + 8;
  const uint32_t q_addr = smem_u32(sm.q) + wg * BM * 128;
  float* const o = &st.acc[0][0];      // O [64 x DV] in wgmma's layout
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  st.m[0] = st.m[1] = NEG_INF;
  st.l[0] = st.l[1] = 0.f;
  if (n_iter > 0) mbar_wait(&sm.q_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % ST;
    mbar_wait(&sm.full[s], (uint32_t)((it / ST) & 1));
    const int k0 = (kt_begin + it) * BN;
    const int kind = tile_kind(qw, BM, k0, BN, Sq, Sk, causal, window, kv_offset);
    if (kind != EMPTY) {
      float sc[8][4];                    // S [64 x 64] in wgmma's layout: softmax_tile's s[n][e]
      wg_fence();
      issue_scores<D>(&sc[0][0], q_addr, smem_u32(sm.k[s]));
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(&sc[0][0]);
      uint32_t pf[8][2];                 // the online softmax (O rescaled), P as bf16
      if (kind == FULL) {
        attn::softmax_tile<DV, BN, false>(sc, 0u, scale_log2, st, pf);
      } else {
        uint32_t vis = 0u;               // bit 4 n + e: the entry's key is visible
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1);
            if (key < Sk && sees(e < 2 ? qp0 : qp1, key, causal, window))
              vis |= 1u << (4 * n + e);
          }
        attn::softmax_tile<DV, BN, true>(sc, vis, scale_log2, st, pf);
      }
      fence_regs<DV / 2>(o);
      wg_fence();
      issue_pv<DV>(o, pf, smem_u32(sm.v[s]));
      wg_commit();
      wg_wait<0>();
      fence_regs<DV / 2>(o);
    }
    __syncwarp();                        // each consumer warp is done with the stage
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 1);
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 2);
  }
}

}  // namespace wgattn
