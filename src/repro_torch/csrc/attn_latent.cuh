// MLA's latent-row attention for Hopper (sm_90a): decode and chunked
// prefill at D = 576 on wgmma tiles, included by paged_attention.cu.
//
// Replaces, for bf16 at D = 576 with one KV head and K and V the same
// pages, the Pallas TPU kernels paged_attention_tpu and
// paged_prefill_attention_tpu (repro/kernels/paged_attention/kernel.py)
// at the shape absorbed MLA gives them (repro/models/mla.py): all H = 128
// query heads of a request attend over latent rows of R + rope = 512 + 64
// = 576 bf16 values, and the value of a key is its whole latent row.  The
// mask rule, the 1/sqrt(D) scale and the [.., 576] output are
// paged_attention.cu's.
//
// What bounds it: many query rows (heads, times chunk rows in prefill)
// share each latent row, so the work is two chained matrix products over
// one operand: S = Q K^T and O += P V, with V = K.  Decode at B = 8, ctx
// 600-700 moves 6 MB of latent rows (0.0025 ms at 3.35 TB/s) but computes
// 1.5 GFLOP, which only the tensor cores keep near that; a 512-token
// chunk computes 39 GFLOP (0.039 ms at 989 TFLOP/s) beside 150 MB of q and
// out.  So each latent tile is loaded once per block and used by both
// products, on wgmma at M = 64:
//
// - A block holds BM = 64 query rows: in decode 64 heads of one request
//   (grid (n_split, ceil(H / 64), B)), in prefill 64 (chunk row c, head
//   g) pairs r = c * H + g (grid (ceil(C * H / 64), 1, B), the blocks of
//   the last rows, which see the most keys, first).  Its Q tile (64 x 576,
//   72 KB) stays in shared memory as wgmma's A operand.
// - Latent tiles of BK = 32 keys (two 16-row pages, 36 KB) stream through
//   a ring of STAGES = 3 shared-memory stages filled by TMA: a producer
//   warpgroup looks up each page in the block table and asks for boxes
//   of 64 columns x one page of rows (the pool seen as a [n_pages * page,
//   576] matrix, 128-byte swizzle), completion counted on the stage's
//   mbarrier; each consumer warp releases a stage on a second mbarrier.
//   A tile is 18 boxes, and issuing them from a consumer warp held its
//   warpgroup back, so the loads have a warpgroup of their own (its four
//   warps issue a tile's boxes side by side); setmaxnreg gives its
//   registers to the consumers (232 each: O alone is 160 in warpgroup 1),
//   which a warpgroup-less ninth warp would have capped at 168 (three
//   warps on one of the SM's four register files).  A page past the table
//   is read as rows past the pool, which TMA fills with zeros.  Shared
//   memory: 72 + 3 x 36 + 8.5 KB + the merge's 3 KB, one block per SM.
// - Warpgroup 0 computes S = Q K^T (36 wgmma m64n32k16, both operands
//   K-major from shared memory), the online softmax in f32 (log2 units, as
//   attn_mma.cuh's tile: l sums the P that the product weighs), and
//   O[:, 0:256) += P V with P as its A operand in registers.  It hands P
//   (as those A fragments) and each row's rescale to warpgroup 1 through
//   shared memory (named barriers P_FULL / P_EMPTY), which computes
//   O[:, 256:576) += P V.  V is the same shared-memory tile read as a
//   transposed (MN-major) B operand: no second copy of the latent rows.
//   O is 64 x 576 f32 in registers.  Prefill rounds P to bf16 once (bar
//   2e-2, as attn_mma.cuh's tile does); decode, whose bar of 4e-3 was set
//   for a P that is not rounded, takes P as hi + lo, two bf16 products (P
//   to about 16 bits): one rounding alone fails that bar on lanes of few
//   keys (outputs near 1-2, tests/test_torch_latent.py), and decode's
//   products are cheap.
// - Decode splits each request's keys into n_split <= 8 ranges of whole
//   pages (latent_decode_plan in kernels/paged_attention/ops.py, from
//   shapes only): as many as the card runs every cluster of at once.  The
//   split blocks of a (request, head tile) are one thread-block cluster:
//   each block owns 64 / n_split rows of the tile, every block sends its
//   partial of those rows (m, l, f32 O) into the owner's shared memory
//   (distributed shared memory), and the owner merges them by log-sum-exp
//   (send_partial, merge_received).  No partial goes through device memory
//   and no counter is kept: the tile-counter merge of attn_merge.cuh (the
//   last block to arrive merges) left one block reading all n_split x 147
//   KB of a tile, longer than the splits' own work at B = 8.  A range past
//   the lane's length sends l = 0.
// - The output of one split (prefill, or decode in one split) is
//   normalised, rounded to bf16, staged in the shared memory Q held and
//   written out as whole 16-byte pieces of rows.
#pragma once

#include "attn_mma.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace latent {

using attn::bf16;
using attn::NEG_INF;
using attn::smem_u32;

constexpr int D = 576;                 // latent row: R + rope = 512 + 64
constexpr int DC = D / 64;             // 64-column chunks, one 128-byte swizzle row each
constexpr int BM = 64;                 // query rows of a block (wgmma's M)
constexpr int BK = 32;                 // keys of a latent tile
constexpr int STAGES = 3;
constexpr int WG0_COLS = 256;          // O's columns in warpgroup 0; the rest in warpgroup 1
constexpr int WG1_COLS = D - WG0_COLS;
constexpr int THREADS = 384;           // two consumer warpgroups and a producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int CONSUMER_REGS = 232;     // setmaxnreg: 256 x 232 + 128 x 40 <= 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CHUNK_Q = BM * 128;      // bytes of one 64-column chunk of the Q tile
constexpr int CHUNK_KV = BK * 128;     // ... of a latent tile
constexpr int KV_BYTES = DC * CHUNK_KV;
constexpr int LDS = D + 8;             // row stride of the staged bf16 output and of a
                                       // received f32 partial, in elements (padded)
constexpr int MAX_SPLIT = 8;           // split-KV blocks of a cluster (the portable most)
constexpr int RECV_ROWS = BM + MAX_SPLIT;   // n_split x ceil(64 / n_split) at most
enum Bar { P_FULL = 1, P_EMPTY = 2, EPI = 3, LOAD = 4 };   // named barriers (0: __syncthreads)
constexpr int LOAD_WARPS = 4;          // producer warps issuing a tile's copies

struct alignas(1024) Smem {
  bf16 q[BM * D];                      // chunk c at c * CHUNK_Q: [64 rows][64], swizzled
  bf16 kv[STAGES][BK * D];             // chunk c at c * CHUNK_KV: [32 keys][64], swizzled
  uint4 p[2][4][2][32];                // P as A fragments: [hi, lo][warp][k step][lane]
  float alpha[BM], lsum[BM];
  float rm[RECV_ROWS], rl[RECV_ROWS];  // split-KV: the splits' m (log2 units) and l, received
  float w[BM][MAX_SPLIT], inv[BM];     // split-KV merge: each split's weight, 1 / sum
  uint64_t full[STAGES], empty[STAGES], q_full;
};
static_assert(sizeof(bf16) * BM * LDS <= sizeof(bf16) * (BM * D + STAGES * BK * D),
              "the staged output fits the Q tile and the ring");
static_assert(sizeof(float) * RECV_ROWS * LDS <= sizeof(bf16) * (BM * D + STAGES * BK * D),
              "the received f32 partials fit the Q tile and the ring");
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;   // + alignment of the dynamic base

struct Params {
  const int32_t* tables;               // [B, max_pages]
  const int32_t* lens;                 // decode: tokens valid; prefill: tokens before the chunk
  bf16* out;                           // [B * C * H, D]
  int B, C, H, page, max_pages, split_pages, box_rows, pool_rows, decode;
  float scale_log2;
};

// ---------------------------------------------------------------------------
// mbarriers, TMA, named barriers, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one box of the map at (column c0, row c1) into dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// every thread of every block of the cluster; orders shared-memory writes
// before it with the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// the address of a shared variable in block `rank` of the cluster
__device__ __forceinline__ uint32_t peer(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_peer(uint32_t a, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(x) : "memory");
}
__device__ __forceinline__ void st_peer2(uint32_t a, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(x), "f"(y) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// A wgmma shared-memory operand in the 128-byte swizzle layout: rows of
// 128 bytes, 8-row groups `sbo` bytes apart; for an MN-major (transposed)
// operand, 64-element blocks of the MN dimension `lbo` bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define LAT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define LAT_F16(d, i) LAT_F4(d, i), LAT_F4(d, i + 4), LAT_F4(d, i + 8), LAT_F4(d, i + 12)
#define LAT_F64(d, i) LAT_F16(d, i), LAT_F16(d, i + 16), LAT_F16(d, i + 32), LAT_F16(d, i + 48)

// d[64 x 32] += A[64 x 16] B[16 x 32]: A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : LAT_F16(d, 0)
      : "l"(da), "l"(db), "r"(1));
}
// d[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : LAT_F16(d, 0), LAT_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[64 x 256] += A[64 x 16] B[16 x 256]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n256(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : LAT_F64(d, 0), LAT_F64(d, 64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef LAT_F4
#undef LAT_F16
#undef LAT_F64

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
struct Blk {                           // one block's share of the work
  int b, row0, rows_valid, ctx, k0, k1, n_tiles, split;
  int64_t orow0;                       // row of the tile's row 0 in q / out ([B * C * H, D])
  // the position of tile row r (ctx + its chunk row)
  __device__ int qpos(int r, int H) const { return ctx + (row0 + r) / H; }
};

// The producer warps (warpgroup 2): the Q tile, then latent tile it
// of the block's range into stage it % STAGES once the consumers released
// it, counted on the stage's full barrier.  A tile's keys are whole boxes
// of box_rows pool rows, one box a column chunk; a page past the table is
// read as rows past the pool, which TMA fills with zeros.  Lane i looks up
// box i's row; lane 0 of each of LOAD_WARPS warps issues every
// LOAD_WARPS-th column chunk's copies, with uniform operands: the copies
// of a tile issued from one thread took a large share of a tile's time,
// several warps issue them side by side.
__device__ __forceinline__ int box_row(const Params& p, const Blk& k, int it, int i) {
  if (i >= BK / p.box_rows) return 0;
  const int key = k.k0 + it * BK + i * p.box_rows;
  const int pg = key / p.page;
  return pg < p.max_pages ? p.tables[(int64_t)k.b * p.max_pages + pg] * p.page + key % p.page
                          : p.pool_rows;
}
__device__ __forceinline__ void produce(Smem& sm, const CUtensorMap* q_map,
                                        const CUtensorMap* kv_map, const Params& p,
                                        const Blk& k) {
  const int w = threadIdx.x / 32 - CONSUMERS / 32, lane = threadIdx.x % 32;
  if (w == 0 && lane == 0) {
    mbar_expect(&sm.q_full, BM * D * sizeof(bf16));
#pragma unroll
    for (int c = 0; c < DC; ++c)
      tma_load(reinterpret_cast<unsigned char*>(sm.q) + c * CHUNK_Q, q_map, c * 64,
               (int)k.orow0, &sm.q_full);
  }
  for (int it = 0; it < k.n_tiles; ++it) {
    const int s = it % STAGES;
    const int my_row = box_row(p, k, it, lane);
    if (w == 0 && lane == 0) {
      if (it >= STAGES) mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
      mbar_expect(&sm.full[s], KV_BYTES);
    }
    bar_sync(LOAD, 32 * LOAD_WARPS);   // the stage is free
    unsigned char* dst = reinterpret_cast<unsigned char*>(sm.kv[s]);
    for (int bx = 0; bx < BK / p.box_rows; ++bx) {
      const int row = __shfl_sync(0xffffffffu, my_row, bx);
      if (lane == 0)
        for (int c = w; c < DC; c += LOAD_WARPS)
          tma_load(dst + c * CHUNK_KV + bx * p.box_rows * 128, kv_map, c * 64, row, &sm.full[s]);
    }
    __syncwarp();
  }
}

// Warpgroup 0's online softmax of one latent tile for a lane's two rows
// (g and g + 8 of its warp's 16): sc holds the raw scores in wgmma's
// accumulator layout (sc[n][e]: key 8n + 2 (lane % 4) + (e & 1), row g + 8
// (e >> 1)).  Scores are scaled after the product (scale_log2 = log2(e) /
// sqrt(D), in exp2's FMA); with MASKED, bit n * 4 + e of vis says whether
// the key is visible, and a masked key counts as the finite NEG_INF for the
// row max and gets p = 0 exactly.  P leaves as the A fragments of P V (bf16
// pairs: hi[2 kk][.] and hi[2 kk + 1][.] are k step kk), rounded once, or
// with split as hi + lo, lo the bf16 rounding of what hi left out (P to
// about 16 bits: decode's bar was set for a P that is not rounded); l
// sums the P that the product weighs.  alpha: the rows' rescale.
template <bool MASKED>
__device__ __forceinline__ void softmax_latent(const float (&sc)[BK / 8][4], uint32_t vis,
                                               float scale_log2, bool split, float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               uint32_t (&hi)[BK / 8][2],
                                               uint32_t (&lo)[BK / 8][2]) {
  auto visible = [&](int n, int e) { return !MASKED || ((vis >> (n * 4 + e)) & 1u); };
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (visible(n, e)) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mx[i] = fmaxf(m[i], mx[i] == NEG_INF ? NEG_INF : mx[i] * scale_log2);
    alpha[i] = attn::ex2(m[i] - mx[i]);
    m[i] = mx[i];
  }
  auto prob = [&](int n, int e) {
    return visible(n, e) ? attn::ex2(fmaf(sc[n][e], scale_log2, -mx[e >> 1])) : 0.f;
  };
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = prob(n, 2 * i), p1 = prob(n, 2 * i + 1);
      hi[n][i] = attn::pack_bf16(p0, p1);
      rs[i] += attn::pair_sum(hi[n][i]);
      lo[n][i] = 0u;
      if (split) {
        const uint32_t h = hi[n][i];
        lo[n][i] = attn::pack_bf16(p0 - __uint_as_float(h << 16),
                                   p1 - __uint_as_float(h & 0xffff0000u));
        rs[i] += attn::pair_sum(lo[n][i]);
      }
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
}

// rows g and g + 8 of a consumer thread's accumulator tile (wgmma's
// layout: acc[4 n + e], column 8 n + 2 (lane % 4) + (e & 1)) times their
// rescale
template <int COLS>
__device__ __forceinline__ void rescale(float* acc, float a0, float a1) {
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n) {
    acc[4 * n] *= a0;
    acc[4 * n + 1] *= a0;
    acc[4 * n + 2] *= a1;
    acc[4 * n + 3] *= a1;
  }
}

// S = Q K^T of one latent tile into sc (wgmma's accumulator layout),
// issued, not waited for
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 8][4], uint32_t q_addr,
                                             uint32_t kv_addr) {
  float* scf = &sc[0][0];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) scf[i] = 0.f;
  fence_regs<BK / 2>(scf);
  wg_fence();
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss_n32(scf, desc(q_addr + c * CHUNK_Q + kk * 32, 16, 1024),
                 desc(kv_addr + c * CHUNK_KV + kk * 32, 16, 1024));
  wg_commit();
}

// Warpgroup 0: S = Q K^T, the online softmax, O[:, 0:256) += P V.  Leaves its O
// (unnormalised) in acc, m in log2 units and l (summed over the row's four
// lanes) for its rows g and g + 8.
__device__ __forceinline__ void consume_scores(Smem& sm, const Params& p, const Blk& k,
                                               float (&acc)[WG0_COLS / 2], float (&m)[2],
                                               float (&l)[2]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int ra = warp * 16 + g, rb = ra + 8;     // this lane's two tile rows
  const int qpa = k.qpos(ra, p.H), qpb = k.qpos(rb, p.H), qlo = k.qpos(0, p.H);
  const bool split = p.decode;                   // P as hi + lo
#pragma unroll
  for (int i = 0; i < WG0_COLS / 2; ++i) acc[i] = 0.f;
  m[0] = m[1] = NEG_INF;
  l[0] = l[1] = 0.f;
  const uint32_t q_addr = smem_u32(sm.q);
  mbar_wait(&sm.q_full, 0);
  for (int it = 0; it < k.n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t kv_addr = smem_u32(sm.kv[s]);
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    float st[BK / 8][4];
    issue_scores(st, q_addr, kv_addr);
    wg_wait<0>();
    fence_regs<BK / 2>(&st[0][0]);

    // the online softmax; only edge tiles compute a mask
    const int kb = k.k0 + it * BK;
    uint32_t hi[BK / 8][2], lo[BK / 8][2];
    float alpha[2];
    if (kb + BK <= k.k1 && kb + BK - 1 <= qlo) {
      softmax_latent<false>(st, 0u, p.scale_log2, split, m, l, alpha, hi, lo);
    } else {
      uint32_t vis = 0u;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + n * 8 + 2 * t4 + (e & 1);
          if (key < k.k1 && key <= (e < 2 ? qpa : qpb)) vis |= 1u << (n * 4 + e);
        }
      softmax_latent<true>(st, vis, p.scale_log2, split, m, l, alpha, hi, lo);
    }
    const uint32_t ah[2][4] = {{hi[0][0], hi[0][1], hi[1][0], hi[1][1]},
                               {hi[2][0], hi[2][1], hi[3][0], hi[3][1]}};
    const uint32_t al[2][4] = {{lo[0][0], lo[0][1], lo[1][0], lo[1][1]},
                               {lo[2][0], lo[2][1], lo[3][0], lo[3][1]}};

    // hand P and the rescale to warpgroup 1
    bar_sync(P_EMPTY, CONSUMERS);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      sm.p[0][warp][kk][lane] = make_uint4(ah[kk][0], ah[kk][1], ah[kk][2], ah[kk][3]);
      if (split) sm.p[1][warp][kk][lane] = make_uint4(al[kk][0], al[kk][1], al[kk][2], al[kk][3]);
    }
    if (t4 == 0) {
      sm.alpha[ra] = alpha[0];
      sm.alpha[rb] = alpha[1];
    }
    bar_arrive(P_FULL, CONSUMERS);

    // O[:, 0:256) = alpha O + P V, V the same tile read MN-major
    fence_regs<WG0_COLS / 2>(acc);
    rescale<WG0_COLS>(acc, alpha[0], alpha[1]);
    fence_regs<WG0_COLS / 2>(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t dv = desc(kv_addr + kk * 16 * 128, CHUNK_KV, 1024);
      mma_rs_n256(acc, ah[kk], dv);
      if (split) mma_rs_n256(acc, al[kk], dv);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs<WG0_COLS / 2>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
}

// Warpgroup 1: O[:, 256:576) = alpha O + P V with warpgroup 0's P and
// rescale.
__device__ __forceinline__ void consume_values(Smem& sm, const Params& p, const Blk& k,
                                               float (&o)[WG1_COLS / 2]) {
  const int tid = threadIdx.x - 128, warp = tid / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const bool split = p.decode;
#pragma unroll
  for (int i = 0; i < WG1_COLS / 2; ++i) o[i] = 0.f;
  bar_arrive(P_EMPTY, CONSUMERS);      // the P buffer starts free
  for (int it = 0; it < k.n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    bar_sync(P_FULL, CONSUMERS);
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint4 h = sm.p[0][warp][kk][lane];
      const uint4 w = split ? sm.p[1][warp][kk][lane] : make_uint4(0, 0, 0, 0);
      ah[kk][0] = h.x;
      ah[kk][1] = h.y;
      ah[kk][2] = h.z;
      ah[kk][3] = h.w;
      al[kk][0] = w.x;
      al[kk][1] = w.y;
      al[kk][2] = w.z;
      al[kk][3] = w.w;
    }
    const float a0 = sm.alpha[ra], a1 = sm.alpha[rb];
    if (it + 1 < k.n_tiles) bar_arrive(P_EMPTY, CONSUMERS);
    fence_regs<WG1_COLS / 2>(o);
    rescale<WG1_COLS>(o, a0, a1);
    fence_regs<WG1_COLS / 2>(o);
    wg_fence();
    const uint32_t kv_addr = smem_u32(sm.kv[s]) + (WG0_COLS / 64) * CHUNK_KV;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t dv = desc(kv_addr + kk * 16 * 128, CHUNK_KV, 1024);
      const uint64_t dv8 = desc(kv_addr + 4 * CHUNK_KV + kk * 16 * 128, CHUNK_KV, 1024);
      mma_rs_n256(o, ah[kk], dv);
      mma_rs_n64(o + 128, ah[kk], dv8);
      if (split) {
        mma_rs_n256(o, al[kk], dv);
        mma_rs_n64(o + 128, al[kk], dv8);
      }
    }
    wg_commit();
    wg_wait<0>();
    fence_regs<WG1_COLS / 2>(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }
}
static_assert(WG1_COLS == 256 + 64, "warpgroup 1's products: one n256 and one n64");

// A consumer thread's O columns [col0, col0 + COLS) of its rows ra and ra
// + 8, divided by the rows' sums, as bf16 into the staged tile
template <int COLS>
__device__ __forceinline__ void stage(Smem& sm, const float* acc, int col0, int ra, float la,
                                      float lb) {
  bf16* so = sm.q;                     // [BM][LDS], over Q and the ring's first rows
  const float ia = 1.f / fmaxf(la, 1e-30f), ib = 1.f / fmaxf(lb, 1e-30f);
  const int col = col0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(so + ra * LDS + col + 8 * n) =
        __floats2bfloat162_rn(acc[4 * n] * ia, acc[4 * n + 1] * ia);
    *reinterpret_cast<__nv_bfloat162*>(so + (ra + 8) * LDS + col + 8 * n) =
        __floats2bfloat162_rn(acc[4 * n + 2] * ib, acc[4 * n + 3] * ib);
  }
}

// Split-KV decode: the n_split blocks of a (request, head tile) form one
// cluster.  Block `rank` owns rows [rank * per, (rank + 1) * per) of the
// tile (per = ceil(64 / n_split)); every block sends its partial of those
// rows (m in log2 units, l, unnormalised O in f32) into the owner's
// shared memory (distributed shared memory stores, which do not wait on
// the network as loads do), and the owner merges them by log-sum-exp.  A
// split that saw no key (l = 0) weighs nothing and its O is not read.
template <int COLS>
__device__ __forceinline__ void send_partial(Smem& sm, const Blk& k, const float* acc, int col0,
                                             int ra) {
  const int n = gridDim.x, per = (BM + n - 1) / n;
  const int col = col0 + 2 * (threadIdx.x % 4);
  const float* recv = reinterpret_cast<const float*>(sm.q);   // [RECV_ROWS][LDS]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    if (r >= k.rows_valid) continue;
    const uint32_t dst = peer(recv + (k.split * per + r % per) * LDS + col, r / per);
#pragma unroll
    for (int i = 0; i < COLS / 8; ++i)
      st_peer2(dst + 32 * i, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
}
__device__ __forceinline__ void send_state(Smem& sm, const Blk& k, int r, float m, float l) {
  const int n = gridDim.x, per = (BM + n - 1) / n;
  if (r >= k.rows_valid) return;
  const int slot = k.split * per + r % per;
  st_peer(peer(&sm.rm[slot], r / per), m);
  st_peer(peer(&sm.rl[slot], r / per), l);
}
// the owner's merge of its rows, by the 256 consumer threads
__device__ __forceinline__ void merge_received(Smem& sm, const Params& p, const Blk& k) {
  const int n = gridDim.x, per = (BM + n - 1) / n, r0 = k.split * per;
  const int nr = max(0, min(k.rows_valid, r0 + per) - r0);
  const float* recv = reinterpret_cast<const float*>(sm.q);
  const int tid = threadIdx.x;
  if (tid < nr) {
    float M = NEG_INF, L = 0.f;
    for (int s = 0; s < n; ++s)
      if (sm.rl[s * per + tid] > 0.f) M = fmaxf(M, sm.rm[s * per + tid]);
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      const float l = s < n ? sm.rl[s * per + tid] : 0.f;
      const float w = l > 0.f ? attn::ex2(sm.rm[s * per + tid] - M) : 0.f;
      sm.w[tid][s] = w;
      L = fmaf(w, l, L);
    }
    sm.inv[tid] = 1.f / fmaxf(L, 1e-30f);
  }
  bar_sync(EPI, CONSUMERS);
  for (int u = tid; u < nr * (D / 4); u += CONSUMERS) {
    const int j = u / (D / 4), c = u % (D / 4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n; ++s) {
      const float w = sm.w[j][s];
      if (w > 0.f) {
        const float4 x = *reinterpret_cast<const float4*>(recv + (s * per + j) * LDS + c);
        a.x = fmaf(w, x.x, a.x);
        a.y = fmaf(w, x.y, a.y);
        a.z = fmaf(w, x.z, a.z);
        a.w = fmaf(w, x.w, a.w);
      }
    }
    const float inv = sm.inv[j];
    *reinterpret_cast<uint2*>(p.out + (k.orow0 + r0 + j) * D + c) =
        make_uint2(attn::pack_bf16(a.x * inv, a.y * inv), attn::pack_bf16(a.z * inv, a.w * inv));
  }
}

// The two consumer warpgroups: the tile's products, then its output (one
// split: normalised, staged and written out; split-KV: sent to the rows'
// owners and merged).
__device__ __forceinline__ void consume(Smem& sm, const Params& p, const Blk& k, bool split) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ra = warp % 4 * 16 + lane / 4;   // this thread's first tile row
  if (!split && k.n_tiles == 0) {      // no key: a zero row
    for (int i = threadIdx.x; i < k.rows_valid * (D / 8); i += CONSUMERS)
      *reinterpret_cast<uint4*>(p.out + k.orow0 * D + i * 8) = make_uint4(0, 0, 0, 0);
    return;
  }
  if (warp < 4) {
    float acc[WG0_COLS / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    if (k.n_tiles > 0) consume_scores(sm, p, k, acc, m, l);
    if (!split) {
      if (lane % 4 == 0) {
        sm.lsum[ra] = l[0];
        sm.lsum[ra + 8] = l[1];
      }
      bar_sync(EPI, CONSUMERS);        // every product is done: Q's memory is free
      stage<WG0_COLS>(sm, acc, 0, ra, l[0], l[1]);
    } else {
      cluster_sync();                  // every block's products are done
      if (lane % 4 == 0) {
        send_state(sm, k, ra, m[0], l[0]);
        send_state(sm, k, ra + 8, m[1], l[1]);
      }
      if (k.n_tiles > 0) send_partial<WG0_COLS>(sm, k, acc, 0, ra);
    }
  } else {
    float o[WG1_COLS / 2];
    if (k.n_tiles > 0) consume_values(sm, p, k, o);
    if (!split) {
      bar_sync(EPI, CONSUMERS);
      stage<WG1_COLS>(sm, o, WG0_COLS, ra, sm.lsum[ra], sm.lsum[ra + 8]);
    } else {
      cluster_sync();
      if (k.n_tiles > 0) send_partial<WG1_COLS>(sm, k, o, WG0_COLS, ra);
    }
  }
  if (split) {
    cluster_sync();                    // every partial has arrived
    merge_received(sm, p, k);
    return;
  }
  bar_sync(EPI, CONSUMERS);            // the tile is staged
  const bf16* so = sm.q;
  for (int i = threadIdx.x; i < k.rows_valid * (D / 8); i += CONSUMERS) {
    const int r = i / (D / 8), c = i % (D / 8);
    *reinterpret_cast<uint4*>(p.out + (k.orow0 + r) * D + c * 8) =
        *reinterpret_cast<const uint4*>(so + r * LDS + c * 8);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
latent_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap kv_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~uintptr_t(1023));
  Blk k;
  k.b = blockIdx.z;
  const int n_rows = p.C * p.H;        // the request's query rows (decode: C = 1)
  k.split = p.decode ? blockIdx.x : 0;
  // prefill: the blocks of the last rows, which see the most keys, first
  k.row0 = (p.decode ? blockIdx.y : gridDim.x - 1 - blockIdx.x) * BM;
  k.rows_valid = min(BM, n_rows - k.row0);
  k.orow0 = (int64_t)k.b * n_rows + k.row0;
  const int len = p.lens[k.b];
  const int kv_limit = p.max_pages * p.page;
  if (p.decode) {                      // the query sits at len - 1 and sees keys < len
    k.ctx = len - 1;
    k.k0 = k.split * p.split_pages * p.page;
    k.k1 = min(min(len, kv_limit), (k.split + 1) * p.split_pages * p.page);
  } else {                             // chunk row c sits at ctx + c
    k.ctx = len;
    k.k0 = 0;
    k.k1 = min(kv_limit, k.qpos(k.rows_valid - 1, p.H) + 1);
  }
  k.n_tiles = k.k1 > k.k0 ? (k.k1 - k.k0 + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);   // each consumer warp releases
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const bool split = p.decode && gridDim.x > 1;   // a cluster of split blocks
  if (threadIdx.x >= CONSUMERS) {      // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < CONSUMERS + 32 * LOAD_WARPS && k.n_tiles > 0)
      produce(sm, &q_map, &kv_map, p, k);
    if (split) {                       // the cluster's barriers count every thread
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  consume(sm, p, k, split);
}

// ---------------------------------------------------------------------------
// host side: the tensor maps and the launch
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// a [rows, 576] bf16 matrix at ptr, read in boxes of 64 columns x box_rows
// rows with the 128-byte swizzle wgmma reads; rows past the end read as 0
inline bool rows_map(CUtensorMap* map, const void* ptr, int64_t rows, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr || rows < 1) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the pages a TMA box covers: one page up to 32 rows, 32 rows of a longer one
inline int box_rows(int page) {
  if (page >= 8 && page <= BK && BK % page == 0) return page;
  return page > BK && page % BK == 0 ? BK : 0;
}

// How many clusters of n blocks of the kernel the card holds at once
// (blocks of a cluster share a GPC; one block takes an SM)
inline cudaError_t max_clusters(int n, int* out) {
  static const cudaError_t attr = attn::allow_smem(latent_kernel, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  if (n < 1 || n > MAX_SPLIT) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, latent_kernel, &cfg);
}

// grid.x > 1 in decode: split-KV, its blocks one cluster per (request,
// head tile)
inline cudaError_t launch(const void* q, int64_t q_rows, const void* pages, const Params& p,
                          dim3 grid, cudaStream_t s) {
  static const cudaError_t attr = attn::allow_smem(latent_kernel, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap qm, km;
  if (p.box_rows == 0 || (p.decode && grid.x > MAX_SPLIT) || !rows_map(&qm, q, q_rows, BM) ||
      !rows_map(&km, pages, p.pool_rows, p.box_rows))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.decode ? grid.x : 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, latent_kernel, qm, km, p);
}

}  // namespace latent
