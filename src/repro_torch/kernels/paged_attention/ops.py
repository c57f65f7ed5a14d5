"""Wrappers for paged attention (decode + chunked prefill).

Replace ``repro/kernels/paged_attention/kernel.py::paged_attention_tpu`` and
``paged_prefill_attention_tpu``.  Both launch ``csrc/paged_attention.cu``,
whose blocks walk a request's pages in a loop, carrying an online softmax
in f32.

Decode is bound by the bytes of the cached K/V it reads once per step.
:func:`decode_plan` cuts the block table's columns into ``n_split`` ranges
of whole pages, from the shapes alone, so that the (request, KV head,
split) blocks fill the card; each block reads its keys' K/V rows with
16-byte loads, the next keys in flight while it computes, and writes f32
partials; the last block of each (request, head group) to finish merges
them in the same launch (``launches`` counts such calls as
``paged_attention_split``).  No host read of the lengths: a decode call
can be captured in a CUDA graph.  Decode takes the head dims in
``DECODE_HEAD_DIMS``: 80 and 112 are widths of MLA's latent rows (R +
rope; 80 in DeepSeek-V2's reduced test model), read as 1-KV-head MQA with
all the query heads of a request over the same rows; 160 is stablelm-12b's
head dim (112 also zamba2-7b's).  Every served config's head dim is in
both sets (tests/test_torch_model.py).  bf16 chunked prefill
(head dims in ``PREFILL_BF16_HEAD_DIMS``) runs on one of two bodies, as
:func:`prefill_plan` says: chunks at the head dims of
``PREFILL_WGMMA_DIMS`` (zamba2-7b's 112, LLaVA's 128, stablelm-12b's 160)
over pages of ``PREFILL_WGMMA_PAGES`` rows on
``paged_prefill_wgmma_kernel``, the wgmma + TMA body of
``csrc/attn_wgmma.cuh`` that flash attention's wide forward runs too, its
producer reading K/V a page at a time by TMA (``launches`` counts these
calls as ``paged_prefill_attention_wgmma`` too); the rest on the
tensor-core tile of ``csrc/attn_mma.cuh``.  :func:`prefill_walk` is the
host's copy of the key tiles and pages a block of the body walks.  f32
prefill runs on CUDA-core f32 products, any D.

bf16 at D = 576, DeepSeek-V2's full latent rows, runs on the wgmma tiles
of ``csrc/attn_latent.cuh`` (``launches``: ``paged_attention_latent`` and
``paged_prefill_attention_latent``): 64 query rows a block, each 32-key
latent tile loaded once by TMA and read as both K and V.  They take one KV
head, K and V the same pages and no window, which is the shape absorbed
MLA gives them; any other bf16 call at D = 576 raises on a CUDA tensor, as
does a head dim outside these sets.  :func:`latent_decode_plan` splits the
decode's keys, from the shapes alone, into as many splits as the card runs
at once; a request tile's split blocks form one thread-block cluster and
merge in shared memory.  f32 at D = 576 stays on the CUDA-core decode and
prefill bodies.
"""
from __future__ import annotations

import ctypes as ct
import functools

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import key_tiles, tile_kind
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_ref)

_P, _I = ct.c_void_p, ct.c_int
# q k v tables lens out, dtype B H Kh D page P window n_split, parts,
# counters, stream
_DECODE_ARGS = [_P] * 6 + [_I] * 9 + [_P] * 3
_PREFILL_ARGS = [_P] * 6 + [_I] * 9 + [_P]    # ... dtype B C H Kh D page P window
# latent: q k tables lens out, B H page P pool_rows n_split split_pages,
# stream; prefill: ... out, B C H page P pool_rows, stream
_LATENT_DECODE_ARGS = [_P] * 5 + [_I] * 7 + [_P]
_LATENT_PREFILL_ARGS = [_P] * 5 + [_I] * 6 + [_P]
# wgmma prefill: q k v tables ctx out, B C H Kh D page P window pool_rows,
# stream
_PREFILL_WGMMA_ARGS = [_P] * 6 + [_I] * 9 + [_P]
PREFILL_BF16_HEAD_DIMS = (64, 80, 112, 128, 160, 256, 576)  # bf16 prefill D
# bf16 prefill D the plan sends to the wgmma body, chunks of any length:
# at each the body was faster than the tile, or level with it, at every
# served chunk of 16 to 1,024 rows on an H100 (PERF.md, tools/kernel_ab.py
# --widths, rows paged_prefill_threshold)
PREFILL_WGMMA_DIMS = (112, 128, 160)    # also the D it is built for
PREFILL_WGMMA_ROWS = 128          # its chunk rows a block: two warpgroups
PREFILL_WGMMA_KEYS = 64           # keys of a tile it streams
PREFILL_WGMMA_PAGES = (8, 16, 32)   # page sizes its TMA boxes take
DECODE_HEAD_DIMS = (32, 64, 80, 112, 128, 160, 256, 576)    # decode D
LATENT_D = 576            # bf16 at this D runs on csrc/attn_latent.cuh
LATENT_ROWS = 64          # query rows of a latent block (wgmma's M)
LATENT_KEYS = 32          # keys of a latent tile
LATENT_MIN_SPLIT_KEYS = 128   # no latent decode split covers fewer keys
LATENT_MAX_SPLIT = 8      # split blocks of a cluster (the portable most)
WAVE_BLOCKS = 4           # two waves of two resident 4-warp blocks per SM
MIN_SPLIT_KEYS = 64       # no split covers fewer table columns' keys


def heads_per_block(G: int, D: int) -> int:
    """Query heads a CUDA-core decode block holds: the largest of 8, 4, 2,
    1 that divides G = H / Kh (all of one KV head), at most 2 above D =
    256 (f32 at 576: a lane keeps each head's q and acc in registers;
    ``DecCfg::MAX_GT``)."""
    most = 8 if D <= 256 else 2
    return next(n for n in (8, 4, 2, 1) if G % n == 0 and n <= most)


def decode_plan(B: int, H: int, Kh: int, D: int, max_pages: int, page: int,
                n_sms: int) -> int:
    """n_split for the decode kernel: how many ranges of ceil(max_pages /
    n_split) whole table columns the keys are cut into.  1 when the (b,
    head group) blocks alone reach ``WAVE_BLOCKS`` blocks per SM, or when
    the table is too short to split; else the fewest splits that reach
    that many blocks, none covering fewer than ``MIN_SPLIT_KEYS`` keys'
    columns (a block's fixed cost, its table window and its reduction,
    would outweigh fewer keys) and none empty.  A function of shapes only: the lengths are read by the
    kernel, which skips the part of a split past them."""
    blocks = B * (H // heads_per_block(H // Kh, D))
    most = min(max_pages, max_pages * page // MIN_SPLIT_KEYS)
    target = WAVE_BLOCKS * n_sms
    if blocks >= target or most <= 1:
        return 1
    n_split = min(most, -(-target // blocks))
    per = -(-max_pages // n_split)
    return -(-max_pages // per)


def prefill_plan(D: int, page: int) -> str:
    """Which body a bf16 chunked prefill at head dim D over pages of
    ``page`` rows runs, from the shapes alone: "wgmma"
    (``paged_prefill_wgmma_kernel``) when D is in ``PREFILL_WGMMA_DIMS``
    and its TMA boxes take the page (``PREFILL_WGMMA_PAGES``), else "tile"
    (the mma.sync tile, which reads any page)."""
    return "wgmma" if D in PREFILL_WGMMA_DIMS and \
        page in PREFILL_WGMMA_PAGES else "tile"


def prefill_walk(q0: int, C: int, ctx: int, table, page: int, window: int,
                 pool_rows: int) -> list:
    """The ``PREFILL_WGMMA_KEYS``-key tiles that the wgmma prefill's block
    of chunk rows [q0, q0 + ``PREFILL_WGMMA_ROWS``) of a lane walks (its
    rows at positions ctx + c, its table row ``table``, of max_pages =
    len(table) columns), in order, each as (k0, (kind of warpgroup 0's 64
    rows, kind of warpgroup 1's), the pool row each of the tile's pages is
    read from): flash's :func:`key_tiles` and :func:`tile_kind` over the
    chunk as Sq = C causal rows at offset ctx against max_pages * page
    keys, and page i of a tile read from pool row table[j] * page, j its
    table column, or from ``pool_rows`` (past the pool: zeros) when j is
    past the table, as ``csrc/paged_attention.cu``'s kernel walks them."""
    bk, half = PREFILL_WGMMA_KEYS, PREFILL_WGMMA_ROWS // 2
    n_keys = len(table) * page
    begin, end = key_tiles(q0, min(PREFILL_WGMMA_ROWS, C - q0), n_keys, bk,
                           True, window, ctx)
    return [(kt * bk,
             tuple(tile_kind(q0 + w * half, half, kt * bk, bk, C, n_keys,
                             True, window, ctx) for w in (0, 1)),
             tuple(int(table[j]) * page if j < len(table) else pool_rows
                   for j in range(kt * bk // page, (kt + 1) * bk // page)))
            for kt in range(begin, end)]


def latent_decode_plan(B: int, H: int, max_pages: int, page: int,
                       n_sms: int, max_clusters=None) -> tuple:
    """(n_split, split_pages) for the latent decode kernel: its keys cut
    into n_split ranges of split_pages whole table columns each (whole
    32-key tiles where the page divides 32).  A block holds 64 query heads
    of one request and takes a whole SM (its shared memory), and the
    n_split blocks of a (request, head tile) pair are one thread-block
    cluster, which merges them in shared memory.  So n_split is the most,
    up to ``LATENT_MAX_SPLIT``, for which the card runs every pair's
    cluster at once (``max_clusters(n)``: clusters of n blocks the card
    holds, from the kernel library; ``n_sms // n`` when not given), no
    split covering fewer than ``LATENT_MIN_SPLIT_KEYS`` keys (a block
    loads its 72 KB Q tile and merges: fixed costs) and none empty.  A
    function of shapes only: the kernel reads the lengths and skips the
    part of a split past them."""
    pairs = B * -(-H // LATENT_ROWS)
    most = max(1, min(max_pages, LATENT_MAX_SPLIT,
                      max_pages * page // LATENT_MIN_SPLIT_KEYS))
    fits = max_clusters or (lambda n: n_sms // n)
    n_split = max([n for n in range(1, most + 1) if pairs <= fits(n)],
                  default=1)
    per = -(-max_pages // n_split)
    if LATENT_KEYS % page == 0:          # whole tiles
        tile = LATENT_KEYS // page
        per = -(-per // tile) * tile
    return -(-max_pages // per), per


@functools.lru_cache(maxsize=None)
def latent_max_clusters(index: int, n: int) -> int:
    """Clusters of n latent decode blocks that CUDA device ``index`` runs
    at once (cudaOccupancyMaxActiveClusters), asked once per process."""
    fn = _build.function("paged_attention", "paged_latent_max_clusters",
                         [_I, _P])
    out = ct.c_int()
    with torch.cuda.device(index):
        K.check_launch(fn(n, ct.byref(out)), "paged_latent_max_clusters")
    return out.value


def _latent_box(page: int) -> bool:
    """The page sizes the latent kernels' TMA boxes cover (``box_rows``)."""
    return (8 <= page <= LATENT_KEYS and LATENT_KEYS % page == 0) or \
        page % LATENT_KEYS == 0


def _latent_require(q, k_pages, v_pages, Kh: int, page: int, window: int):
    """The latent kernels' contract, checked before a bf16 call at D = 576
    launches: one KV head, K and V the same pages, no window, a page their
    TMA boxes cover, 16-byte aligned rows, pool rows indexed with 32
    bits."""
    why = ("bf16 paged attention at D = 576 runs on the latent-row kernels "
           "(csrc/attn_latent.cuh), which need ")
    K.require(Kh == 1, why + f"one KV head, got {Kh}")
    K.require(k_pages.data_ptr() == v_pages.data_ptr()
              and k_pages.stride() == v_pages.stride(),
              why + "K and V to be the same pages, got distinct tensors")
    K.require(not window, why + f"no window, got window {window}")
    K.require(_latent_box(page), why + f"a page of 8, 16, 32 or a multiple "
              f"of 32 rows, got {page}")
    K.require((q.data_ptr() | k_pages.data_ptr()) % 16 == 0,
              why + "16-byte aligned q and pages")
    K.require(k_pages.shape[0] * page < 2 ** 31,
              why + "fewer than 2^31 pool rows")


def _check(q, k_pages, v_pages, block_tables, lens, q_ndim: int):
    K.require(q.ndim == q_ndim and k_pages.ndim == 4,
              f"q {tuple(q.shape)} / pages {tuple(k_pages.shape)} rank")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    n_pages, page, Kh, Dk = k_pages.shape
    K.require(q.dtype in K.DTYPE_CODES,
              f"paged attention takes f32/bf16, got {q.dtype}")
    K.require(k_pages.dtype == v_pages.dtype == q.dtype,
              "q and the K/V pages must share one type")
    K.require(v_pages.shape == k_pages.shape and Dk == D,
              f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not "
              f"match q {tuple(q.shape)}")
    K.require(H % Kh == 0, f"{H} query heads over {Kh} KV heads")
    K.require(block_tables.dtype == lens.dtype == torch.int32,
              "block tables and lengths must be int32")
    K.require(block_tables.ndim == 2 and block_tables.shape[0] == B
              and lens.shape == (B,), "block tables / lengths shape")
    K.require(all(t.is_contiguous() for t in
                  (q, k_pages, v_pages, block_tables, lens)),
              "paged attention needs contiguous inputs")
    K.require(len({t.device for t in (q, k_pages, v_pages, block_tables,
                                      lens)}) == 1,
              "paged attention inputs must share one device")
    return B, H, Kh, D, page, block_tables.shape[1]


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    window: int = 0):
    """Decode: q [B, H, D] against pages [n_pages, page, Kh, D] through
    block_tables [B, max_pages]; lengths [B] tokens valid (the new one
    included).  Returns [B, H, D] in q's type.  With more than one split
    (see :func:`decode_plan`) the kernel's last blocks merge the splits."""
    if K.on_cpu(q, k_pages, v_pages, block_tables, lengths):
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   window=window)
    B, H, Kh, D, page, P = _check(q, k_pages, v_pages, block_tables, lengths,
                                  3)
    if q.dtype == torch.bfloat16 and D == LATENT_D:
        _latent_require(q, k_pages, v_pages, Kh, page, window)
        return _latent_decode(q, k_pages, block_tables, lengths, B, H, page,
                              P)
    K.require(D in DECODE_HEAD_DIMS,
              f"paged decode attention takes head dims {DECODE_HEAD_DIMS}, "
              f"got {D}")
    # K/V rows and q rows are read 16 bytes at a time
    K.require((q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()) % 16
              == 0, "paged decode attention needs 16-byte aligned q/pages")
    out = torch.empty_like(q)
    n_split = decode_plan(B, H, Kh, D, P, page,
                          K.n_sms(q.device.index or 0)) if B and P else 1
    parts = torch.empty(n_split * B * H * (D + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None
    fn = _build.function("paged_attention", "paged_attention", _DECODE_ARGS)
    stream = K.stream_ptr(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             K.DTYPE_CODES[q.dtype], B, H, Kh, D, page, P, int(window),
             n_split, None if parts is None else parts.data_ptr(),
             K.tile_counters(q, stream, B * (H // heads_per_block(H // Kh, D)),
                             "paged_attention") if n_split > 1 else None,
             stream)
    K.check_launch(err, "paged_attention")
    K.launches["paged_attention"] += 1
    if n_split > 1:
        K.launches["paged_attention_split"] += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                            window: int = 0):
    """Chunk queries [B, C, H, D] against pages, chunk-causal (query c sits
    at absolute position ``ctx_lens[b] + c``; the chunk's K/V rows must
    already be written into the pages).  Returns [B, C, H, D]."""
    if K.on_cpu(q, k_pages, v_pages, block_tables, ctx_lens):
        return paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                           ctx_lens, window=window)
    B, H, Kh, D, page, P = _check(q, k_pages, v_pages, block_tables,
                                  ctx_lens, 4)
    C = q.shape[1]
    if q.dtype == torch.bfloat16 and D == LATENT_D:
        _latent_require(q, k_pages, v_pages, Kh, page, window)
        return _latent_prefill(q, k_pages, block_tables, ctx_lens, B, C, H,
                               page, P)
    K.require(q.dtype != torch.bfloat16 or D in PREFILL_BF16_HEAD_DIMS,
              f"bf16 paged prefill attention takes head dims "
              f"{PREFILL_BF16_HEAD_DIMS}, got {D}")
    K.require(k_pages.shape[0] * page < 2 ** 31,
              "paged prefill attention indexes pool rows with 32 bits")
    if q.dtype == torch.bfloat16 and \
            prefill_plan(D, page) == "wgmma":
        return _prefill_wgmma(q, k_pages, v_pages, block_tables, ctx_lens,
                              window, B, H, Kh, D, page, P)
    out = torch.empty_like(q)
    fn = _build.function("paged_attention", "paged_prefill_attention",
                         _PREFILL_ARGS)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
             K.DTYPE_CODES[q.dtype], B, C, H, Kh, D, page, P, int(window),
             K.stream_ptr(q))
    K.check_launch(err, "paged_prefill_attention")
    K.launches["paged_prefill_attention"] += 1
    return out


def _prefill_wgmma(q, k_pages, v_pages, block_tables, ctx_lens, window,
                   B, H, Kh, D, page, P):
    """bf16 chunked prefill on ``paged_prefill_wgmma_kernel``, where
    :func:`prefill_plan` sends it (inputs checked by :func:`_check`):
    16-byte aligned q and pages, or it raises; launched, never sent
    elsewhere."""
    why = "bf16 paged prefill on the wgmma body needs "
    K.require((q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()) % 16
              == 0, why + "16-byte aligned q and pages")
    pool_rows = k_pages.shape[0] * page
    K.require(0 < pool_rows < 2 ** 31,
              why + f"1 to 2^31 - 1 pool rows, got {pool_rows}")
    out = torch.empty_like(q)
    fn = _build.function("paged_attention", "paged_prefill_attention_wgmma",
                         _PREFILL_WGMMA_ARGS)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
             B, q.shape[1], H, Kh, D, page, P, int(window), pool_rows,
             K.stream_ptr(q))
    K.check_launch(err, "paged_prefill_attention_wgmma")
    K.launches["paged_prefill_attention"] += 1
    K.launches["paged_prefill_attention_wgmma"] += 1
    return out


def _latent_decode(q, pages, block_tables, lengths, B, H, page, P):
    """Decode on the latent kernel (checked by :func:`_latent_require`):
    split as :func:`latent_decode_plan` says, the splits of a request tile
    merged by their cluster in the same launch."""
    out = torch.empty_like(q)
    index = q.device.index or 0
    n_split, per = latent_decode_plan(
        B, H, P, page, K.n_sms(index),
        functools.partial(latent_max_clusters, index)) if B and P \
        else (1, max(P, 1))
    fn = _build.function("paged_attention", "paged_latent_attention",
                         _LATENT_DECODE_ARGS)
    err = fn(q.data_ptr(), pages.data_ptr(), block_tables.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), B, H, page, P,
             pages.shape[0] * page, n_split, per, K.stream_ptr(q))
    K.check_launch(err, "paged_latent_attention")
    K.launches["paged_attention_latent"] += 1
    return out


def _latent_prefill(q, pages, block_tables, ctx_lens, B, C, H, page, P):
    """Chunked prefill on the latent kernel (checked by
    :func:`_latent_require`): one block per 64 (chunk row, head) pairs."""
    out = torch.empty_like(q)
    fn = _build.function("paged_attention", "paged_latent_prefill_attention",
                         _LATENT_PREFILL_ARGS)
    err = fn(q.data_ptr(), pages.data_ptr(), block_tables.data_ptr(),
             ctx_lens.data_ptr(), out.data_ptr(), B, C, H, page, P,
             pages.shape[0] * page, K.stream_ptr(q))
    K.check_launch(err, "paged_latent_prefill_attention")
    K.launches["paged_prefill_attention_latent"] += 1
    return out
