// Paged attention for Hopper (sm_90a): decode and chunked prefill.
//
// Replaces the Pallas TPU kernels in repro/kernels/paged_attention/
// kernel.py: paged_attention_tpu (body _paged_kernel, decode) and
// paged_prefill_attention_tpu (body _paged_prefill_kernel, chunked
// prefill).  Both reduce to one rule: query row c of request b sits at
// position qpos = ctx_b + c and sees key positions pos with
//
//     pos <= qpos   and, when window > 0,   pos > qpos - window.
//
// Decode is the C == 1 case with ctx_b = lengths[b] - 1 (the lengths count
// the token just written): the TPU decode mask pos < lengths[b],
// pos >= lengths[b] - window.  Query head h reads KV head
// h / G.  Scores are scaled by 1/sqrt(D), masked with the finite NEG_INF
// the TPU kernels use, and reduced by an online softmax in f32 that divides
// by max(l, 1e-30), so rows whose mask is empty come out finite.
//
// Layouts (row-major): q/out [B, C, H, D]; k/v pages [n_pages, page, Kh, D];
// tables [B, max_pages] int32; lens [B] int32.  f32 or bf16 in and out, f32
// inside.
//
// The TPU grid walks (batch, page) with the page dimension sequential and
// the softmax state carried in scratch across grid steps.  CUDA blocks run
// in no order, so here a block owns a slice of the work and walks its pages
// in a loop, reading its own table row; pages wholly outside the rows'
// visible keys are skipped.  The bodies:
//
// - decode (f32 and bf16, D = 32, 64, 80, 112, 128, 160 or 256; f32 also 576): bound by
//   the bytes of the cached K/V it reads once per step (LLaVA at B = 8, ctx 600-700:
//   85 MB, 0.0255 ms at 3.35 TB/s).  Split-KV: the wrapper's decode_plan
//   cuts the table's columns into n_split ranges of whole pages, from the
//   shapes alone (no host read of the lengths, so a call can be captured
//   in a CUDA graph), enough for the (b, head group, split) blocks to
//   fill the card with two waves of two blocks per SM.  A block clamps
//   its range to the keys its query sees (pos < len, pos >= len - window)
//   from lengths[b] on the device; one with none left writes l = 0 and
//   counts itself in.  A block of 4 warps holds the G query heads of its
//   KV head in registers (up to 8 a block, so GQA reads each K/V row once
//   per 8 heads), stages its table window in shared memory and reads K/V rows
//   as 16-byte loads, D * size / 16 lanes a row (a D = 128 bf16 row is 16
//   lanes), so a warp reads 2-8 keys a step.  It loads the next batch of
//   keys (up to 4 steps) before it computes this one: at LLaVA's widths
//   (bf16, D = 128, one query head a KV head) 16 KB of K/V loads per
//   block are in flight.  Dot products are f32 FMAs and sub-warp
//   shuffles; each lane group keeps its own online softmax (m, l, acc) in
//   registers, in log2 units (the 1/sqrt(D) scale and log2 e folded into
//   q, exponentials on ex2.approx), combined across the warp by shuffles
//   and across the warps once in shared memory.  P is not rounded: no
//   tensor cores here, so a bf16 output is rounded once.  Rows whose
//   16-byte chunks do not fill a power of two of lanes (D = 80, 112, and
//   576 in f32: MLA's latent rows; stablelm-12b's D = 160) leave the lanes past the row idle; at
//   D = 576 an f32 block holds 2 heads, so their q and acc fit registers
//   (see DecCfg).  One split writes out; more write f32 partials, and the
//   last of a (b, head group) tile's split blocks to finish merges them
//   into out (attn_merge.cuh's arrive_last and merge_rows): one launch.
// - bf16 chunked prefill at D = 112, 128 and 160 over pages of 8, 16 or
//   32 rows (the wrapper's prefill_plan): the wgmma body of
//   attn_wgmma.cuh, which flash attention's wide forward runs too, its
//   producer reading K/V by TMA a page at a time
//   (pwg::paged_prefill_wgmma_kernel, exported as
//   paged_prefill_attention_wgmma).
// - bf16 chunked prefill otherwise, D = 64, 80, 112, 128, 160 or 256: the
//   tensor-core tile of attn_mma.cuh.  The block's rows are
//   (chunk row c, query head g) pairs of its KV head, r = c * G + g, cut
//   into tiles of 64 rows, 16 per warp
//   (GQA folds into the M dimension of the products); blocks of the last
//   rows, which see the most keys, start first.  A key tile is 64 keys
//   (32 at D = 160 and 256): each thread looks up its keys' pages in the table
//   (one division per tile) and copies the rows at ((blk * page + t) * Kh
//   + kh) * D (64-bit offsets) with cp.async.  Bound: the two products
//   (4 * C * ctx * D per head) on the tensor cores, and the exponentials.
// - bf16 at D = 576 with one KV head and K and V the same pages (MLA's
//   latent rows), decode and chunked prefill: the wgmma tiles of
//   attn_latent.cuh, exported as paged_latent_attention and
//   paged_latent_prefill_attention.  The two entry points above refuse
//   bf16 at D = 576.
// - f32 prefill: CUDA-core f32 products from shared memory, one page in
//   flight.  f32 stays off the tensor cores by design (the f32 model
//   checks hold the card to the CPU within 2e-4).  The block's 16 query
//   rows (of the C * G (c, g) pairs) keep their running max, sum and
//   accumulator in shared memory, so any D fits.
#include "attn_mma.cuh"
#include "attn_merge.cuh"
#include "attn_latent.cuh"
#include "attn_wgmma.cuh"

#include <atomic>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

using attn::bf16;
using attn::NEG_INF;
constexpr int THREADS = 128;
constexpr int ROWS_PER_BLOCK = 16;   // query rows of an f32 prefill block

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// grid (ceil(C * G / ROWS_PER_BLOCK), Kh, B): the block's query rows are
// the (chunk row c, head g) pairs r = c * G + g of its KV head, rows row0 ..
// row0 + QR - 1 of the C * G, so its shared memory is bounded whatever G
// and D are.
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ lens, T* __restrict__ out, int C,
                  int H, int Kh, int D, int page, int max_pages, int window,
                  float scale) {
  const int b = blockIdx.z, kh = blockIdx.y;
  const int G = H / Kh;
  const int QR = ROWS_PER_BLOCK;   // query rows of this block
  const int row0 = blockIdx.x * QR;
  const int n_rows = C * G;
  const int DP = D + 1;            // padded stride: no bank conflicts across rows
  extern __shared__ float smem[];
  float* qs = smem;                // [QR, DP] scaled queries
  float* acc = qs + QR * DP;       // [QR, D]
  float* ks = acc + QR * D;        // [page, DP]
  float* vs = ks + page * DP;      // [page, D]
  float* s = vs + page * D;        // [QR, page] scores, then probabilities
  float* m = s + QR * page;        // [QR] running max
  float* l = m + QR;               // [QR] running sum
  float* alpha = l + QR;           // [QR] rescale of this page

  const int tid = threadIdx.x;
  const int ctx = lens[b];

  for (int i = tid; i < QR * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int c = (row0 + r) / G, g = (row0 + r) % G;
    float v = 0.f;
    if (row0 + r < n_rows)
      v = to_f32(q[(((int64_t)b * C + c) * H + kh * G + g) * D + d]) * scale;
    qs[r * DP + d] = v;
    acc[i] = 0.f;
  }
  for (int r = tid; r < QR; r += THREADS) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  // pages any row of the tile can see
  const int q_lo = ctx + row0 / G;
  const int q_hi = ctx + (min(row0 + QR, n_rows) - 1) / G;
  const int j_end = q_hi < 0 ? 0 : min(max_pages, q_hi / page + 1);
  int j_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) j_begin = (q_lo - window + 1) / page;
  __syncthreads();

  // one thread per dot product when there are enough of them, else a warp
  const int gs = (QR * page >= THREADS) ? 1 : 32;
  const int ngroups = THREADS / gs, group = tid / gs, lane = tid % gs;

  for (int j = j_begin; j < j_end; ++j) {
    const int64_t blk = tables[(int64_t)b * max_pages + j];
    for (int i = tid; i < page * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const int64_t off = ((blk * page + t) * Kh + kh) * (int64_t)D + d;
      ks[t * DP + d] = to_f32(kp[off]);
      vs[i] = to_f32(vp[off]);
    }
    __syncthreads();

    for (int idx = group; idx < QR * page; idx += ngroups) {
      const int r = idx / page, t = idx % page;
      float part = 0.f;
      for (int d = lane; d < D; d += gs) part += qs[r * DP + d] * ks[t * DP + d];
      for (int o = gs / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) {
        const int qpos = ctx + (row0 + r) / G;
        const int pos = j * page + t;
        const bool valid = pos <= qpos && (window <= 0 || pos > qpos - window);
        s[idx] = valid ? part : NEG_INF;
      }
    }
    __syncthreads();

    for (int r = tid; r < QR; r += THREADS) {
      float* sr = s + r * page;
      float mx = m[r];
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(sr[t] - mx);
        sr[t] = p;
        sum += p;
      }
      const float a = expf(m[r] - mx);
      l[r] = a * l[r] + sum;
      m[r] = mx;
      alpha[r] = a;
    }
    __syncthreads();

    for (int i = tid; i < QR * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const float* sr = s + r * page;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < page; ++t) a += sr[t] * vs[t * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < QR * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int c = (row0 + r) / G, g = (row0 + r) % G;
    if (row0 + r < n_rows)
      out[(((int64_t)b * C + c) * H + kh * G + g) * D + d] =
          from_f32<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tables,
                   const void* lens, void* out, int B, int C, int H, int Kh, int D,
                   int page, int max_pages, int window, cudaStream_t stream) {
  if (B == 0 || C == 0) return cudaSuccess;
  const int G = H / Kh;
  const size_t QR = ROWS_PER_BLOCK;
  const size_t smem = (QR * (D + 1) + QR * D + (size_t)page * (D + 1) +
                       (size_t)page * D + QR * page + 3 * QR) * sizeof(float);
  // raise the kernel's shared-memory limit only when a launch needs more
  // than any launch before it (D, G and page vary between callers)
  static std::atomic<size_t> allowed{0};
  if (smem > allowed.load()) {
    const cudaError_t err = attn::allow_smem(paged_attn_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    allowed.store(smem);
  }
  const dim3 grid((unsigned)(((int64_t)C * G + QR - 1) / QR), Kh, B);
  paged_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lens),
      static_cast<T*>(out), C, H, Kh, D, page, max_pages, window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode: split-KV over pages, 16-byte loads, the next keys in flight
// ---------------------------------------------------------------------------
constexpr int DEC_WARPS = 4;
constexpr int DEC_TBL = 128;   // table entries a block stages at a time

// 16 bytes of T as floats (bf16 -> f32 is a shift: its bits are the top
// half of the f32's)
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<bf16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// How a decode block reads a row of D elements of T: CH 16-byte chunks, LPK
// lanes a key (the power of two at or above CH, at most 32), NV chunks a
// lane; when LPK does not divide CH, the lanes past the row's last chunk
// load nothing and hold zeros (D = 80 and 112: 10 and 14 bf16 chunks on 16
// lanes; D = 576 in f32: 144 chunks on 32 lanes, 5 a lane).  A lane keeps q
// and acc in registers for each of the block's GT query heads, NV * VEC
// floats each, at most 64 in all: MAX_GT heads a block, 8 up to D = 256
// and 2 at D = 576, built for f32 only (the wrapper's heads_per_block
// mirrors it).
template <typename T, int D>
struct DecCfg {
  static constexpr int VEC = 16 / sizeof(T);                  // elements per 16-byte load
  static_assert(D % VEC == 0, "rows of whole 16-byte chunks");
  static constexpr int CH = D / VEC;
  static constexpr int LPK = CH >= 32 ? 32 : pow2_at_least(CH);  // lanes per key
  static constexpr int NV = (CH + LPK - 1) / LPK;              // loads per lane per row
  static constexpr bool PAD = CH % LPK != 0;                   // some lanes hold no chunk
  static constexpr int KPW = 32 / LPK;                         // keys per warp per step
  static constexpr int MAX_GT = D <= 256 ? 8 : 2;             // query heads a block
  static_assert(MAX_GT * NV * VEC <= 64, "q and acc of a block's heads fit registers");
};

// grid (n_split, H / GT, B), block of DEC_WARPS warps.  The block owns
// query heads h0 .. h0 + GT - 1 of request b (all of one KV head) and the
// keys of table columns [split * split_pages, (split + 1) * split_pages),
// cut to the visible ones.  A key is read by LPK lanes, 16 bytes each; a
// warp reads KPW keys per step, U steps per batch, and loads the next
// batch before it computes this one.  part_m == nullptr: one split, out is
// written; else the block writes its partials (m in natural units, l, acc),
// and the last split block of its (b, head group) tile merges the tile's
// GT rows into out, with the tile's counter in `counters`.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(32 * DEC_WARPS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lens, T* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int H, int Kh, int page,
                    int max_pages, int split_pages, int window, float scale_log2,
                    unsigned* __restrict__ counters) {
  using Cf = DecCfg<T, D>;
  constexpr int VEC = Cf::VEC, LPK = Cf::LPK, NV = Cf::NV, KPW = Cf::KPW;
  static_assert(GT <= Cf::MAX_GT, "the block's heads fit registers");
  constexpr int U = GT * NV >= 4 ? 1 : 4 / (GT * NV);        // steps per batch
  constexpr int STEP = DEC_WARPS * KPW, BATCH = U * STEP;
  __shared__ int tbl[DEC_TBL];
  __shared__ float red_m[DEC_WARPS][GT], red_l[DEC_WARPS][GT];
  __shared__ float red_acc[DEC_WARPS][GT][D];

  const int split = blockIdx.x, h0 = blockIdx.y * GT, b = blockIdx.z;
  const int kh = h0 / (H / Kh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPK, li = lane % LPK;
  // chunk v * LPK + li of a row is this lane's, if the row has it
  auto mine = [&](int v) { return !Cf::PAD || v * LPK + li < Cf::CH; };
  const int64_t prow = ((int64_t)split * gridDim.z + b) * H + h0;   // partial row
  // the tile's GT output rows (b, h0 .. h0 + GT - 1) and its counter
  const int64_t orow = (int64_t)b * H + h0, tile = (int64_t)b * gridDim.y + blockIdx.y;

  // the keys of this split that the query sees: pos < len, and with a
  // window pos >= len - window
  const int len = lens[b];
  int k0 = split * split_pages * page;
  const int k1 = min(min(len, max_pages * page), (split + 1) * split_pages * page);
  if (window > 0) k0 = max(k0, len - window);
  if (k0 >= k1) {
    if (part_m == nullptr) {
      for (int i = threadIdx.x; i < GT * D; i += 32 * DEC_WARPS)
        out[((int64_t)b * H + h0) * D + i] = from_f32<T>(0.f);
      return;
    }
    if (threadIdx.x < GT) {      // l = 0: this split weighs nothing, but counts
      part_m[prow + threadIdx.x] = NEG_INF;
      part_l[prow + threadIdx.x] = 0.f;
    }
    if (attn::arrive_last(counters + tile, gridDim.x))
      attn::merge_rows<T, D>(part_m, part_l, part_acc, (int64_t)gridDim.z * H, orow, GT,
                             gridDim.x, [&](int r) { return out + (orow + r) * D; });
    return;
  }

  float qf[GT][NV][VEC], acc[GT][NV][VEC], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const uint4* qr = reinterpret_cast<const uint4*>(q + ((int64_t)b * H + h0 + g) * D);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      unpack<T>(mine(v) ? qr[v * LPK + li] : make_uint4(0, 0, 0, 0), qf[g][v]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qf[g][v][e] *= scale_log2;
        acc[g][v][e] = 0.f;
      }
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  for (int p_lo = k0 / page; p_lo * page < k1; p_lo += DEC_TBL) {
    const int p_hi = min(p_lo + DEC_TBL, (k1 + page - 1) / page);
    __syncthreads();                       // the last window's readers are done
    for (int i = threadIdx.x; i < p_hi - p_lo; i += 32 * DEC_WARPS)
      tbl[i] = tables[(int64_t)b * max_pages + p_lo + i];
    __syncthreads();
    const int j_lo = max(k0, p_lo * page), j_hi = min(k1, p_hi * page);
    const int lane_key = warp * KPW + sub;

    // K and V of this lane's keys j0 + u * STEP + lane_key; zeros past j_hi
    uint4 kc[U][NV], vc[U][NV], kn[U][NV], vn[U][NV];
    auto load = [&](int j0, uint4 (&kr)[U][NV], uint4 (&vr)[U][NV]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * STEP + lane_key;
        if (j < j_hi) {
          const int pj = j / page;
          const int64_t r = ((int64_t)tbl[pj - p_lo] * page + (j - pj * page)) * Kh + kh;
          const uint4* kr4 = reinterpret_cast<const uint4*>(kp + r * D) + li;
          const uint4* vr4 = reinterpret_cast<const uint4*>(vp + r * D) + li;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            kr[u][v] = mine(v) ? __ldg(kr4 + v * LPK) : make_uint4(0, 0, 0, 0);
            vr[u][v] = mine(v) ? __ldg(vr4 + v * LPK) : make_uint4(0, 0, 0, 0);
          }
        } else {
#pragma unroll
          for (int v = 0; v < NV; ++v) kr[u][v] = vr[u][v] = make_uint4(0, 0, 0, 0);
        }
      }
    };
    load(j_lo, kc, vc);
    for (int j0 = j_lo; j0 < j_hi; j0 += BATCH) {
      if (j0 + BATCH < j_hi) load(j0 + BATCH, kn, vn);
      float s[U][GT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[NV][VEC];
#pragma unroll
        for (int v = 0; v < NV; ++v) unpack<T>(kc[u][v], kf[v]);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int e = 0; e < VEC; ++e) dot = fmaf(qf[g][v][e], kf[v][e], dot);
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          s[u][g] = j0 + u * STEP + lane_key < j_hi ? dot : NEG_INF;
        }
      }
      float vf[U][NV][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < NV; ++v) unpack<T>(vc[u][v], vf[u][v]);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
        const float alpha = attn::ex2(m[g] - mx);
        float p[U], ls = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = s[u][g] > NEG_INF ? attn::ex2(s[u][g] - mx) : 0.f;   // masked: exactly 0
          ls += p[u];
        }
        l[g] = l[g] * alpha + ls;
        m[g] = mx;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float a = acc[g][v][e] * alpha;
#pragma unroll
            for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][v][e], a);
            acc[g][v][e] = a;
          }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kc[u][v] = kn[u][v];
          vc[u][v] = vn[u][v];
        }
    }
  }

  // the warp's KPW key streams, then the block's warps, by log-sum-exp
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float M = fmaxf(m[g], mo), a = attn::ex2(m[g] - M), c = attn::ex2(mo - M);
      l[g] = l[g] * a + lo * c;
      m[g] = M;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][v][e] = acc[g][v][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][v][e], o) * c;
    }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (li == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (mine(v))
#pragma unroll
          for (int e = 0; e < VEC; ++e) red_acc[warp][g][(v * LPK + li) * VEC + e] = acc[g][v][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GT * D; i += 32 * DEC_WARPS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF, L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, red_m[w][g]);
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float c = attn::ex2(red_m[w][g] - M);
      L += red_l[w][g] * c;
      A += red_acc[w][g][d] * c;
    }
    if (part_m == nullptr) {
      out[((int64_t)b * H + h0) * D + i] = from_f32<T>(A / fmaxf(L, 1e-30f));
    } else {
      part_acc[(prow + g) * D + d] = A;
      if (d == 0) {
        part_m[prow + g] = L > 0.f ? M * attn::LN2 : NEG_INF;
        part_l[prow + g] = L;
      }
    }
  }
  if (part_m != nullptr && attn::arrive_last(counters + tile, gridDim.x))
    attn::merge_rows<T, D>(part_m, part_l, part_acc, (int64_t)gridDim.z * H, orow, GT,
                           gridDim.x, [&](int r) { return out + (orow + r) * D; });
}

template <typename T, int D, int GT>
cudaError_t launch_decode_g(const void* q, const void* k, const void* v, const void* tables,
                            const void* lens, void* out, int B, int H, int Kh, int page,
                            int max_pages, int window, int n_split, float* pm, float* pl,
                            float* pa, unsigned* counters, cudaStream_t s) {
  const dim3 grid(n_split, H / GT, B);
  paged_decode_kernel<T, D, GT><<<grid, 32 * DEC_WARPS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lens),
      static_cast<T*>(out), pm, pl, pa, H, Kh, page, max_pages,
      (max_pages + n_split - 1) / n_split, window, attn::LOG2E / sqrtf((float)D), counters);
  return cudaGetLastError();
}

// GT, the query heads of a block: the largest of 8, 4, 2, 1 that divides
// G = H / Kh (all of one KV head) and is at most DecCfg's MAX_GT, so one
// block reads each K/V row for up to MAX_GT query heads
template <typename T, int D>
cudaError_t launch_decode_d(const void* q, const void* k, const void* v, const void* tables,
                            const void* lens, void* out, int B, int H, int Kh, int page,
                            int max_pages, int window, int n_split, float* pm, float* pl,
                            float* pa, unsigned* counters, cudaStream_t s) {
  const int G = H / Kh;
  constexpr int MAX_GT = DecCfg<T, D>::MAX_GT;
  if constexpr (MAX_GT >= 8)
    if (G % 8 == 0)
      return launch_decode_g<T, D, 8>(q, k, v, tables, lens, out, B, H, Kh, page, max_pages,
                                      window, n_split, pm, pl, pa, counters, s);
  if constexpr (MAX_GT >= 4)
    if (G % 4 == 0)
      return launch_decode_g<T, D, 4>(q, k, v, tables, lens, out, B, H, Kh, page, max_pages,
                                      window, n_split, pm, pl, pa, counters, s);
  if (G % 2 == 0)
    return launch_decode_g<T, D, 2>(q, k, v, tables, lens, out, B, H, Kh, page, max_pages,
                                    window, n_split, pm, pl, pa, counters, s);
  return launch_decode_g<T, D, 1>(q, k, v, tables, lens, out, B, H, Kh, page, max_pages,
                                  window, n_split, pm, pl, pa, counters, s);
}

// The split kernel, which (n_split > 1) also merges its partials into out.
// parts: n_split * B * H * (D + 2) floats, m [n_split, B, H], then l,
// then acc [n_split, B, H, D].
template <typename T>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* tables,
                          const void* lens, void* out, int B, int H, int Kh, int D,
                          int page, int max_pages, int window, int n_split, void* parts,
                          unsigned* counters, cudaStream_t s) {
  if (B == 0) return cudaSuccess;
  if (n_split < 1 ||
      (n_split > 1 && (n_split > max_pages || parts == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const int64_t n = (int64_t)n_split * B * H;
  float* pm = n_split > 1 ? static_cast<float*>(parts) : nullptr;
  float* pl = pm != nullptr ? pm + n : nullptr;
  float* pa = pm != nullptr ? pl + n : nullptr;
  const auto run = [&](auto d) {
    return launch_decode_d<T, decltype(d)::value>(q, k, v, tables, lens, out, B, H, Kh, page,
                                                  max_pages, window, n_split, pm, pl, pa,
                                                  counters, s);
  };
  switch (D) {
    case 32: return run(std::integral_constant<int, 32>());
    case 64: return run(std::integral_constant<int, 64>());
    case 80: return run(std::integral_constant<int, 80>());
    case 112: return run(std::integral_constant<int, 112>());
    case 128: return run(std::integral_constant<int, 128>());
    case 160: return run(std::integral_constant<int, 160>());
    case 256: return run(std::integral_constant<int, 256>());
    case 576:   // f32 only: bf16 latent rows run on attn_latent.cuh
      if constexpr (std::is_same<T, float>::value) return run(std::integral_constant<int, 576>());
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 chunked prefill on the tensor-core tile
// ---------------------------------------------------------------------------
struct PagedProb {
  const bf16 *q_base, *k_base, *v_base;
  const int32_t* table;                   // this request's row
  int64_t q_b;                            // q offset of (b, c = 0, h = kh * G)
  int row0, rows_valid, G, H, Kh, D, page, ctx, kv_limit, causal, window;
  __device__ const bf16* q_row(int r) const {
    const int rg = row0 + r;
    return q_base + q_b + ((int64_t)(rg / G) * H + rg % G) * D;
  }
  __device__ int qpos(int r) const { return ctx + (row0 + r) / G; }
  // key j: row j % page of page table[j / page], as a row of the layer's
  // [n_pages * page, Kh, D] pool (kh's D elements of it).  One division
  // per tile: the keys j + m * STEP walk the pages by subtraction.
  template <int N, int STEP>
  __device__ void kv_rows(int j, int (&row)[N]) const {
    int pg = j / page, t = j % page;
#pragma unroll
    for (int m = 0; m < N; ++m) {
      row[m] = j + m * STEP < kv_limit ? table[pg] * page + t : -1;
      for (t += STEP; t >= page; t -= page) ++pg;
    }
  }
  __device__ int kv_row(int j) const {
    return j < kv_limit ? table[j / page] * page + j % page : -1;
  }
  __device__ const bf16* k_at(int i) const { return k_base + (int64_t)i * Kh * D; }
  __device__ const bf16* v_at(int i) const { return v_base + (int64_t)i * Kh * D; }
};

// grid (ceil(C * G / 64), Kh, B); block of 4 warps, 16 rows each (the
// warps whose rows lie past the chunk still copy K/V tiles)
template <int D>
__global__ void __launch_bounds__(32 * attn::MAX_WARPS, 2)
paged_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                         const bf16* __restrict__ vp, const int32_t* __restrict__ tables,
                         const int32_t* __restrict__ ctx_lens, bf16* __restrict__ out,
                         int C, int H, int Kh, int page, int max_pages, int window,
                         float scale_log2) {
  constexpr int BK = attn::Cfg<D>::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int rows = 16 * attn::MAX_WARPS;
  const int b = blockIdx.z, kh = blockIdx.y, G = H / Kh;
  // later rows see more keys (causal), so their blocks start first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * rows;

  PagedProb P;
  P.q_b = ((int64_t)b * C * H + (int64_t)kh * G) * D;
  P.q_base = q;
  P.k_base = kp + (int64_t)kh * D;
  P.v_base = vp + (int64_t)kh * D;
  P.table = tables + (int64_t)b * max_pages;
  P.row0 = row0;
  P.rows_valid = min(rows, C * G - row0);
  P.G = G;
  P.H = H;
  P.Kh = Kh;
  P.D = D;
  P.page = page;
  P.ctx = ctx_lens[b];
  P.kv_limit = max_pages * page;
  P.causal = 1;
  P.window = window;

  // key tiles any row of the tile can see
  const int q_lo = P.qpos(0), q_hi = P.qpos(P.rows_valid - 1);
  const int k_end = min(P.kv_limit, q_hi + 1);
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > k_begin ? (k_end + BK - 1) / BK : kt_begin;

  attn::RowState<D> st;
  attn::attend<D, attn::MAX_WARPS>(P, kt_begin, kt_end, scale_log2, st,
                                   reinterpret_cast<bf16*>(smem_raw));

  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * 16;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= P.rows_valid) continue;
    const float inv = 1.f / fmaxf(st.l[half], 1e-30f);
    bf16* o = out + P.q_b + ((int64_t)((row0 + r) / G) * H + (row0 + r) % G) * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) = __floats2bfloat162_rn(
          st.acc[n][2 * half] * inv, st.acc[n][2 * half + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* tables,
                       const void* ctx_lens, void* out, int B, int C, int H, int Kh,
                       int page, int max_pages, int window, cudaStream_t stream) {
  using Cf = attn::Cfg<D>;
  static const cudaError_t attr =
      attn::allow_smem(paged_prefill_mma_kernel<D>, Cf::smem_bytes(16 * attn::MAX_WARPS));
  if (attr != cudaSuccess) return attr;
  if (B == 0 || C == 0) return cudaSuccess;
  const int n_rows = C * (H / Kh), rows = 16 * attn::MAX_WARPS;
  const dim3 grid((n_rows + rows - 1) / rows, Kh, B);
  paged_prefill_mma_kernel<D><<<grid, 32 * attn::MAX_WARPS, Cf::smem_bytes(rows), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ctx_lens),
      static_cast<bf16*>(out), C, H, Kh, page, max_pages, window,
      attn::LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

int prefill(const void* q, const void* k, const void* v, const void* tables,
            const void* ctx_lens, void* out, int dtype, int B, int C, int H, int Kh,
            int D, int page, int max_pages, int window, cudaStream_t s) {
  if (Kh <= 0 || H % Kh != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, tables, ctx_lens, out, B, C, H, Kh, D, page, max_pages,
                         window, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const auto run = [&](auto d) {
    return launch_mma<decltype(d)::value>(q, k, v, tables, ctx_lens, out, B, C, H, Kh, page,
                                          max_pages, window, s);
  };
  switch (D) {
    case 64: return (int)run(std::integral_constant<int, 64>());
    case 80: return (int)run(std::integral_constant<int, 80>());
    case 112: return (int)run(std::integral_constant<int, 112>());
    case 128: return (int)run(std::integral_constant<int, 128>());
    case 160: return (int)run(std::integral_constant<int, 160>());
    case 256: return (int)run(std::integral_constant<int, 256>());
    default: return (int)cudaErrorInvalidValue;   // 576: attn_latent.cuh
  }
}

// ---------------------------------------------------------------------------
// bf16 chunked prefill on wgmma: attn_wgmma.cuh's body walking the pages
// ---------------------------------------------------------------------------
// paged_prefill_wgmma_kernel<D> takes the bf16 chunks the wrapper's
// prefill_plan sends it (D = 112, 128 and 160, pages of 8, 16 or 32 rows)
// and computes what the tile above computes there: the chunk-causal mask
// (key j visible to chunk row c when j < max_pages * page, j <= ctx_b + c
// and j inside the window), the 1/sqrt(D) scale after the product, P
// rounded to bf16 with l summing the rounded P, rows with no visible key
// 0, every row of the padded chunk computed.  The tile's bits are not kept
// (the products sum in another order).
//
// A block owns (b, query head h, 128 chunk rows) and runs the body of
// flash attention's wide forward (wgattn::consume): the chunk as Sq = C
// rows at positions ctx_b + c, causal, against Sk = max_pages * page keys.
// Only its producer differs.  Q comes once by TMA from a 4-D map over q
// [B, C, H, D] (rows past C read as zeros).  A 64-key tile is 64 / page
// pages (page 8, 16 or 32): lane i of each producer warp looks up page i
// of the tile in the block table, and the four producer warps issue the
// tile's boxes side by side (one box: 64 columns x page rows of one KV
// head, from a map over the layer's pool [n_pages * page, Kh, D] as B =
// 1), a page past the table read as rows past the pool, which TMA fills
// with zeros.  K and V are read where they lie: no gather, no 16-byte
// copies a thread, no per-row table lookup.  setmaxnreg: 256 x 232 + 128
// x 40 (the producer's lookups and shuffles need more than the single
// issuing thread of flash's producer).  One query head a block: each
// K/V tile in shared memory serves 128 query rows either way; packing a
// GQA group's (c, g) rows into one block, as the tile does, would only
// move the sharing of a KV head's tiles among its G heads from L2 into
// the block, at the price of a 5-D map for Q and masks by row / G.  The G
// heads of a KV head are neighbouring blocks.  The grid runs the chunk's
// last row blocks (which walk the most keys) first.  Bound: at the served
// 512-row chunks the bytes of q, out and the K/V rows the tables name
// (PERF.md).
namespace pwg {

using namespace hopper;
using wgattn::BLOCK;
using wgattn::BM;
using wgattn::BN;
using wgattn::BOX;
using wgattn::CONSUMERS;
using wgattn::FwdSmem;
constexpr int THREADS = wgattn::THREADS;
constexpr int CONSUMER_REGS = 232;     // setmaxnreg: 256 x 232 + 128 x 40 = 64,512
constexpr int PRODUCER_REGS = 40;
constexpr int LOAD_WARPS = 4;          // producer warps issuing a tile's copies
constexpr int BAR_LOAD = 1;            // named barrier: the producer warps, a stage acquired

// the head dims this body is built for
template <int D>
constexpr bool BUILT = D == 112 || D == 128 || D == 160;

struct Params {
  const int32_t* tables;               // [B, max_pages]
  const int32_t* ctx_lens;             // [B] tokens cached before the chunk
  bf16* out;                           // [B, C, H, D]
  int B, C, H, Kh, page, max_pages, window, pool_rows;
  float scale_log2;
};

// grid: ceil(C / 128) row blocks x B x H, the row block slowest (the last
// one first), then b, then h (a KV head's G query heads side by side)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, const Params p) {
  constexpr int ST = wgattn::FWD_STAGES<D, D>;
  using Sm = FwdSmem<D, D, ST>;
  constexpr int CK = Sm::CK;
  static_assert(BUILT<D>, "the paged wgmma prefill's widths");
  auto& sm = wgattn::smem<Sm>();
  const int n_qb = (p.C + BLOCK - 1) / BLOCK, bh = p.B * p.H, id = (int)blockIdx.x;
  const int q0 = (n_qb - 1 - id / bh) * BLOCK;
  const int b = id % bh / p.H, h = id % p.H, kh = h / (p.H / p.Kh);
  const int ctx = p.ctx_lens[b], n_keys = p.max_pages * p.page;
  int kt_begin, kt_end;
  wgattn::key_tiles(q0, min(BLOCK, p.C - q0), n_keys, BN, 1, p.window, ctx, kt_begin, kt_end);
  const int n_iter = kt_end - kt_begin;
  wgattn::ring_init<Sm, ST>(sm);

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= CONSUMERS) {        // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (n_iter == 0) return;
    const int w = (threadIdx.x - CONSUMERS) / 32;
    if (w == 0 && lane == 0) {
      mbar_expect(&sm.q_full, CK * 2 * BOX);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c)
          tma_load4(reinterpret_cast<unsigned char*>(sm.q[c]) + r * BOX, &q_map, c * 64,
                    q0 + r * BM, h, b, &sm.q_full);
    }
    const int per = BN / p.page;         // pages a tile
    const int32_t* table = p.tables + (int64_t)b * p.max_pages;
    for (int it = 0; it < n_iter; ++it) {
      const int pg = (kt_begin + it) * BN / p.page + lane;
      const int my_row = lane < per && pg < p.max_pages ? table[pg] * p.page : p.pool_rows;
      int s = it % ST;
      if (w == 0 && lane == 0) s = wgattn::stage_acquire<ST>(sm, it, 2 * CK * BOX);
      bar_sync(BAR_LOAD, 32 * LOAD_WARPS);   // the stage is free and its bytes expected
      for (int i = 0; i < per; ++i) {
        const int row = __shfl_sync(0xffffffffu, my_row, i);
        if (lane == 0)
#pragma unroll
          for (int c = w; c < 2 * CK; c += LOAD_WARPS) {
            bf16* dst = c < CK ? sm.k[s][c] : sm.v[s][c - CK];
            tma_load4(reinterpret_cast<unsigned char*>(dst) + i * p.page * 128,
                      c < CK ? &k_map : &v_map, (c % CK) * 64, row, kh, 0, &sm.full[s]);
          }
      }
      __syncwarp();
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int qw = q0 + threadIdx.x / 128 * BM;   // this warpgroup's rows [qw, qw + 64)
  const int row0 = qw + threadIdx.x % 128 / 32 * 16 + lane / 4;   // and row0 + 8
  attn::RowState<D> st;
  wgattn::consume<D, D, ST>(sm, st, kt_begin, n_iter, qw, p.C, n_keys, 1, p.window, ctx,
                            p.scale_log2);
  const float* const o = &st.acc[0][0];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.C) continue;
    const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
    bf16* out = p.out + (((int64_t)b * p.C + row) * p.H + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, Params p, cudaStream_t s) {
  constexpr size_t smem = wgattn::fwd_smem_bytes<D, D>();
  static_assert(smem <= wgattn::SMEM_MAX, "the paged wgmma prefill's shared memory");
  static const cudaError_t attr = attn::allow_smem(paged_prefill_wgmma_kernel<D>, smem);
  if (attr != cudaSuccess) return attr;
  if (p.B == 0 || p.C == 0 || p.H == 0) return cudaSuccess;
  const int64_t pool_ss = (int64_t)p.Kh * D;   // a pool row: Kh heads of D
  CUtensorMap qm, km, vm;
  if (!heads_map(&qm, q, p.B, p.H, p.C, D, (int64_t)p.C * p.H * D, D, (int64_t)p.H * D, BN) ||
      !heads_map(&km, k, 1, p.Kh, p.pool_rows, D, 0, D, pool_ss, p.page) ||
      !heads_map(&vm, v, 1, p.Kh, p.pool_rows, D, 0, D, pool_ss, p.page))
    return cudaErrorInvalidValue;
  p.scale_log2 = attn::LOG2E / sqrtf((float)D);
  const int64_t blocks = (int64_t)(p.C + BLOCK - 1) / BLOCK * p.B * p.H;
  paged_prefill_wgmma_kernel<D><<<(unsigned)blocks, THREADS, smem, s>>>(qm, km, vm, p);
  return cudaGetLastError();
}

}  // namespace pwg

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Both return a cudaError_t.

// Decode: q/out [B, H, D]; lengths[b] tokens valid (the new one included).
// D = 32, 64, 80, 112, 128, 160 or 256, and 576 in f32.  n_split ranges of ceil(max_pages / n_split)
// table columns; n_split > 1 needs parts, n_split * B * H * (D + 2) f32 of
// scratch, and merges in the same launch with one counter of counters
// (B * H / GT of them, GT the query heads of a block; zero, left zero; see
// attn_merge.cuh) per output tile.
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* tables, const void* lengths, void* out,
                               int dtype, int B, int H, int Kh, int D, int page,
                               int max_pages, int window, int n_split, void* parts,
                               void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kh <= 0 || H % Kh != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_decode<float>(q, k, v, tables, lengths, out, B, H, Kh, D, page,
                                     max_pages, window, n_split, parts,
                                     static_cast<unsigned*>(counters), s);
  if (dtype == 1)
    return (int)launch_decode<bf16>(q, k, v, tables, lengths, out, B, H, Kh, D, page,
                                    max_pages, window, n_split, parts,
                                    static_cast<unsigned*>(counters), s);
  return (int)cudaErrorInvalidValue;
}

// Chunked prefill: q/out [B, C, H, D]; ctx_lens[b] tokens cached before the
// chunk, whose own K/V rows are already in the pages (write-then-attend).
// f32: any D; bf16: D = 64, 80, 112, 128, 160 or 256.
extern "C" int paged_prefill_attention(const void* q, const void* k, const void* v,
                                       const void* tables, const void* ctx_lens,
                                       void* out, int dtype, int B, int C, int H,
                                       int Kh, int D, int page, int max_pages,
                                       int window, void* stream) {
  return prefill(q, k, v, tables, ctx_lens, out, dtype, B, C, H, Kh, D, page, max_pages,
                 window, static_cast<cudaStream_t>(stream));
}

// Chunked prefill on the wgmma body (pwg::paged_prefill_wgmma_kernel):
// bf16, D = 112, 128 or 160, page 8, 16 or 32, K and V pools of pool_rows
// = n_pages * page rows (fewer than 2^31) each 16-byte aligned; otherwise
// cudaErrorInvalidValue.  The rest as paged_prefill_attention.
extern "C" int paged_prefill_attention_wgmma(const void* q, const void* k, const void* v,
                                             const void* tables, const void* ctx_lens,
                                             void* out, int B, int C, int H, int Kh, int D,
                                             int page, int max_pages, int window,
                                             int pool_rows, void* stream) {
  if (Kh <= 0 || H % Kh != 0 || (page != 8 && page != 16 && page != 32) || pool_rows < 1)
    return (int)cudaErrorInvalidValue;
  const pwg::Params p{static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ctx_lens),
                      static_cast<bf16*>(out), B, C, H, Kh, page, max_pages, window, pool_rows,
                      0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 112: return (int)pwg::launch<112>(q, k, v, p, s);
    case 128: return (int)pwg::launch<128>(q, k, v, p, s);
    case 160: return (int)pwg::launch<160>(q, k, v, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// MLA's latent rows (attn_latent.cuh): bf16, D = 576, one KV head, K and V
// the same pages [pool_rows / page, page, 1, 576]; page 8, 16, 32 or a
// multiple of 32.  q and out 16-byte aligned.  Both return a cudaError_t.
//
// Decode: q/out [B, H, 576]; lengths[b] tokens valid (the new one
// included).  n_split (at most 8) ranges of split_pages table columns;
// with n_split > 1 the split blocks of a (b, head tile) are one cluster
// and merge through distributed shared memory in the same launch.
extern "C" int paged_latent_attention(const void* q, const void* pages, const void* tables,
                                      const void* lengths, void* out, int B, int H, int page,
                                      int max_pages, int pool_rows, int n_split,
                                      int split_pages, void* stream) {
  if (B == 0 || H == 0) return (int)cudaSuccess;
  if (n_split < 1 || split_pages < 1 || (int64_t)n_split * split_pages < max_pages)
    return (int)cudaErrorInvalidValue;
  latent::Params p{};
  p.tables = static_cast<const int32_t*>(tables);
  p.lens = static_cast<const int32_t*>(lengths);
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.C = 1;
  p.H = H;
  p.page = page;
  p.max_pages = max_pages;
  p.split_pages = split_pages;
  p.box_rows = latent::box_rows(page);
  p.pool_rows = pool_rows;
  p.decode = 1;
  p.scale_log2 = attn::LOG2E / sqrtf((float)latent::D);
  const dim3 grid(n_split, (H + latent::BM - 1) / latent::BM, B);
  return (int)latent::launch(q, (int64_t)B * H, pages, p, grid,
                             static_cast<cudaStream_t>(stream));
}

// How many clusters of n_split (1-8) latent decode blocks the current card
// runs at once, in *out: the split planner's card width.
extern "C" int paged_latent_max_clusters(int n_split, int* out) {
  return (int)latent::max_clusters(n_split, out);
}

// Chunked prefill: q/out [B, C, H, 576]; ctx_lens[b] tokens cached before
// the chunk, whose own latent rows are already in the pages.
extern "C" int paged_latent_prefill_attention(const void* q, const void* pages,
                                              const void* tables, const void* ctx_lens,
                                              void* out, int B, int C, int H, int page,
                                              int max_pages, int pool_rows, void* stream) {
  if (B == 0 || C == 0 || H == 0) return (int)cudaSuccess;
  latent::Params p{};
  p.tables = static_cast<const int32_t*>(tables);
  p.lens = static_cast<const int32_t*>(ctx_lens);
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.C = C;
  p.H = H;
  p.page = page;
  p.max_pages = max_pages;
  p.box_rows = latent::box_rows(page);
  p.pool_rows = pool_rows;
  p.scale_log2 = attn::LOG2E / sqrtf((float)latent::D);
  const int64_t rows = (int64_t)C * H;
  const dim3 grid((unsigned)((rows + latent::BM - 1) / latent::BM), 1, B);
  return (int)latent::launch(q, (int64_t)B * rows, pages, p, grid,
                             static_cast<cudaStream_t>(stream));
}
