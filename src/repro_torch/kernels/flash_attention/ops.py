"""Wrappers for full-sequence flash attention.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_tpu``
and the block padding of its wrapper.  It launches
``csrc/flash_attention.cu``: one block per (batch, head, tile of query
rows) loops over tiles of 64 keys and carries an online softmax in f32;
ragged Sq and Sk are bounded inside the kernel, and q/k/v/out are
addressed through their strides, so head-split views of a projection are
read and written without a copy.

bf16 runs on one of two bodies, as :func:`plan` says.  At the wide head
dims (:data:`WGMMA_DIMS`: D = 112, 160, 256 and MLA's (192, 128)) a call
whose grid needs no split (training's full-sequence calls) runs
``flash_fwd_wgmma_kernel``: 128-row blocks of two consumer warpgroups on
``wgmma``, K and V streamed by TMA through a ring of shared-memory stages,
P kept in registers (``launches`` counts these calls as
``flash_attention_wgmma`` too).  Every other bf16 call runs the
``mma.sync`` tile of ``csrc/attn_mma.cuh``: when the grid of query tiles
is too small to fill the card (decode rows, short prefill chunks),
:func:`plan` splits the keys, and the kernel writes per-split f32
partials and the last block of each (b, h, query tile) to finish merges
them in the same launch (``launches`` counts such calls as
``flash_attention_split``).  f32 runs on CUDA-core f32 products, which
keep the f32 model checks' tolerances.  The kernels are built for the
(Dqk, Dv) pairs of :data:`HEAD_DIMS`: every attention width of the repo's
configs, V as wide as Q and K except MLA's (queries and keys 192 wide,
values 128).

Training differentiates it: :func:`flash_attention` goes through
:class:`FlashAttentionFn` when grad is on and an input requires it.  Its
forward also writes each row's log-sum-exp, and its backward is the
kernel ``flash_attention_bwd`` of the same file (δ = rowsum(dO ∘ O), a
dK/dV kernel over blocks of 128 keys and a dQ kernel over blocks of 128
query rows; bf16 on ``wgmma`` fed by TMA, each gradient element one
block's sum in a fixed order, with no atomic add, so every call gives the
same bits; above D = 128 a second bf16 body of 64-row blocks, whose two
warpgroups split the products and each own half of the gradient's
columns); the JAX package differentiates its jnp attention instead.
:func:`tile_kind`, :func:`query_range` and :func:`key_tiles` are the
host's copies of how the backward classifies its tiles and which tiles
its blocks walk; :func:`wgmma_walk` the tiles a block of the forward's
``wgmma`` body walks.
"""
from __future__ import annotations

import ctypes as ct
import functools

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    BLOCK_K, flash_attention_bwd_ref, flash_attention_fwd_ref,
    flash_attention_ref, merge_partials_ref)

_P, _I = ct.c_void_p, ct.c_int
_STRIDES = ct.POINTER(ct.c_int64)
# q k v out, dtype B H Kh Sq Sk D Dv causal window kv_offset, strides,
# rows n_split, parts, counters, lse, stream
_ARGS = [_P] * 4 + [_I] * 11 + [_STRIDES] + [_I] * 2 + [_P] * 4
# q k v out dout lse delta dq dk dv, dtype B H Kh Sq Sk D Dv causal window
# kv_offset, strides, stream
_BWD_ARGS = [_P] * 10 + [_I] * 11 + [_STRIDES, _P]
# part_m part_l part_acc out, dtype n_split B H Sq D, strides, stream
_MERGE_ARGS = [_P] * 4 + [_I] * 6 + [_STRIDES, _P]
# (Dqk, Dv) the kernels are built for: llama/LLaVA/whisper/granite (64,
# 128), zamba2-7b (112), stablelm-12b (160), gemma (256), DeepSeek-V2's MLA
# (queries and keys 128 + 64 wide, values 128)
HEAD_DIMS = ((64, 64), (112, 112), (128, 128), (160, 160), (192, 128),
             (256, 256))
BWD_BLOCK = 128     # the bf16 backward's own rows a block: keys (dK/dV) or
#                     query rows (dQ), two warpgroups of 64 (up to D = 128;
#                     above, 64 rows whose tiles the two warpgroups split)
BWD_TILE = 64       # rows of a tile it streams: query rows (dK/dV) or keys (dQ)
# (Dqk, Dv) of the bf16 forward's wgmma body; 64 and 128 stay on the
# mma.sync tile
WGMMA_DIMS = ((112, 112), (160, 160), (192, 128), (256, 256))
WGMMA_ROWS = 128    # its query rows a block: two warpgroups of 64
MERGE_HEAD_DIMS = (32, 64, 112, 128, 160, 256)    # D the merge is built for
MAX_WARPS = 4                           # warps of a block
MAX_SPLITS_64 = 4   # splits of a 64-row tile, whose last block folds in the
#                     others' partials one round trip to L2 each


def tile_rows(Sq: int) -> int:
    """The bf16 kernel's query tile: one warp of 16 rows when Sq <= 16,
    else four warps of 16 rows."""
    return 16 if Sq <= 16 else 16 * MAX_WARPS


def plan(B: int, H: int, Sq: int, Sk: int, n_sms: int, per_sm: int,
         D: int, Dv: int) -> tuple:
    """(rows, n_split) for a bf16 call at head dims (D, Dv).  The mma.sync
    tile's: rows = :func:`tile_rows`, and
    n_split, how many ranges of whole ``BLOCK_K``-key tiles the keys are
    split into, the most that keeps every block of the call in one wave
    of ``per_sm`` blocks of that tile on each of ``n_sms`` SMs (see
    :func:`blocks_per_sm`), none empty, and for 64-row tiles at most
    ``MAX_SPLITS_64``; 1 when the (b, h, query tile) blocks alone fill half
    a wave, or there is one tile.  A second wave of split blocks, or a
    64-row tile's fifth split, costs more than the shorter key ranges save
    (``tools/kernel_ab.py``'s plan sweep; PERF.md).  A call of 64-row
    tiles that needs no split at a pair of :data:`WGMMA_DIMS` runs the
    wgmma body instead: (``WGMMA_ROWS``, 1).  Decode rows (Sq <= 16) and
    split grids keep the tile.  The threshold is the tile's, though the
    body runs half as many blocks: just past it the body still beats the
    unsplit tile at each pair (``kernel_ab.py --widths``,
    ``flash_fwd_threshold`` rows; PERF.md)."""
    rows = tile_rows(Sq)
    blocks = B * H * -(-Sq // rows)
    tiles = -(-Sk // BLOCK_K)
    most = min(tiles, n_sms * per_sm // max(blocks, 1))
    if rows == 64:
        most = min(most, MAX_SPLITS_64)
    if most <= 1:
        wide = rows == 64 and (D, Dv) in WGMMA_DIMS
        return (WGMMA_ROWS, 1) if wide else (rows, 1)
    per = -(-tiles // most)
    return rows, -(-tiles // per)


def wgmma_walk(q0: int, Sq: int, Sk: int, causal: bool, window: int,
               kv_offset: int) -> list:
    """The ``BLOCK_K``-key tiles that the forward's wgmma block of query
    rows [q0, q0 + ``WGMMA_ROWS``) walks, in order, each as (k0, (kind of
    warpgroup 0's 64 rows, kind of warpgroup 1's)): :func:`key_tiles` over
    the block's rows, and :func:`tile_kind` of each warpgroup's rows and
    the tile (an "empty" tile the warpgroup skips, an "edge" one it
    masks), as ``csrc/flash_attention.cu``'s kernel walks them."""
    begin, end = key_tiles(q0, min(WGMMA_ROWS, Sq - q0), Sk, BLOCK_K,
                           causal, window, kv_offset)
    half = WGMMA_ROWS // 2
    return [(kt * BLOCK_K,
             tuple(tile_kind(q0 + w * half, half, kt * BLOCK_K, BLOCK_K, Sq,
                             Sk, causal, window, kv_offset)
                   for w in (0, 1)))
            for kt in range(begin, end)]


@functools.lru_cache(maxsize=None)
def blocks_per_sm(rows: int, D: int, Dv: int | None = None) -> int:
    """Blocks of the bf16 kernel's ``rows``-row tile at head dims (D, Dv)
    (Dv = D when not given) that one SM holds at once (the CUDA occupancy
    calculator; asked once per process)."""
    n = ct.c_int()
    fn = _build.function("flash_attention", "flash_blocks_per_sm",
                         [_I, _I, _I, _P])
    K.check_launch(fn(rows, D, D if Dv is None else Dv, ct.byref(n)),
                   "flash_attention occupancy")
    return n.value


def split_plan(B: int, H: int, Sq: int, Sk: int, D: int, index: int,
               Dv: int | None = None) -> tuple:
    """:func:`plan` on CUDA device ``index``: its SMs, and the blocks of
    the mma.sync tile at head dims (D, Dv) that one of them holds."""
    Dv = D if Dv is None else Dv
    return plan(B, H, Sq, Sk, K.n_sms(index),
                blocks_per_sm(tile_rows(Sq), D, Dv), D, Dv)


def tile_kind(q0: int, nq: int, k0: int, nk: int, Sq: int, Sk: int,
              causal: bool, window: int, kv_offset: int) -> str:
    """How the mask meets the tile of query rows [q0, q0 + nq) and keys
    [k0, k0 + nk), as the bf16 backward classifies it
    (``csrc/flash_attention.cu``, ``bwd::tile_kind``): "empty" when no pair
    is visible (rows at or past Sq and keys at or past Sk are no pair),
    "full" when every pair of the whole tile is (none past an edge), so
    the kernel skips the mask, else "edge".  Query row i sits at position
    ``kv_offset + i``; the rule is :func:`flash_attention_ref`'s."""
    rq, rk = min(nq, Sq - q0), min(nk, Sk - k0)
    if rq <= 0 or rk <= 0:
        return "empty"
    q_lo = kv_offset + q0
    q_hi, k_hi = q_lo + rq - 1, k0 + rk - 1
    if (causal and k0 > q_hi) or (window > 0 and k_hi <= q_lo - window):
        return "empty"
    full = (rq == nq and rk == nk and (not causal or k_hi <= q_lo)
            and (window <= 0 or k0 > q_hi - window))
    return "full" if full else "edge"


def query_range(k0: int, n: int, Sq: int, causal: bool, window: int,
                kv_offset: int) -> tuple:
    """The query rows [lo, hi) that can see a key of [k0, k0 + n) (none
    when hi <= lo): the rows a dK/dV block walks, as the kernel's
    ``query_range``."""
    lo = max(0, k0 - kv_offset) if causal else 0
    hi = min(Sq, k0 + n - 1 + window - kv_offset) if window > 0 else Sq
    return lo, hi


def key_tiles(q0: int, rows: int, Sk: int, bk: int, causal: bool,
              window: int, kv_offset: int) -> tuple:
    """The key tiles [begin, end) of ``bk`` keys that query rows [q0, q0 +
    rows) can see: the tiles a dQ block walks, as the kernel's
    ``key_tiles``."""
    q_lo, q_hi = kv_offset + q0, kv_offset + q0 + rows - 1
    k_end = min(Sk, q_hi + 1) if causal else Sk
    k_begin = max(0, q_lo - window + 1) if window > 0 else 0
    begin = k_begin // bk
    return begin, (-(-k_end // bk) if k_end > k_begin else begin)


def _conditions(q, k, v):
    """(holds, message) for each condition on the kernels' inputs, in an
    order where each may assume the ones before it; a message is a lambda,
    formatted only for a condition that fails."""
    yield (q.ndim == 4 and k.ndim == 4 and v.ndim == 4
           and k.shape[:3] == v.shape[:3],
           lambda: f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                   f"{tuple(v.shape)} must be [B, H, Sq, D] / [B, Kh, Sk, D] "
                   f"/ [B, Kh, Sk, Dv]")
    yield (k.shape[0] == q.shape[0] and k.shape[3] == q.shape[3],
           lambda: f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    yield ((q.shape[3], v.shape[3]) in HEAD_DIMS,
           lambda: f"head dims (D, Dv) = {(q.shape[3], v.shape[3])} not in "
                   f"{HEAD_DIMS}")
    yield (k.shape[1] > 0 and q.shape[1] % k.shape[1] == 0,
           lambda: f"{q.shape[1]} query heads over {k.shape[1]} KV heads")
    yield (q.dtype in K.DTYPE_CODES and k.dtype == v.dtype == q.dtype,
           lambda: f"q/k/v must share one type of f32/bf16, got "
                   f"{q.dtype}/{k.dtype}/{v.dtype}")
    yield (q.stride(-1) == k.stride(-1) == v.stride(-1) == 1,
           lambda: "flash attention needs the head dim contiguous")
    yield (q.device == k.device == v.device,
           lambda: "flash attention inputs must share one device")
    # bf16 rows are copied 16 bytes at a time
    yield (q.dtype != torch.bfloat16
           or ((q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
               and not any(s % 8 for t in (q, k, v) for s in t.stride()[:3])),
           lambda: "bf16 flash attention needs 16-byte aligned rows (base "
                   "and batch/head/sequence strides multiples of 8)")


def _check(q, k, v):
    """(B, H, Kh, Sq, Sk, D, Dv) of inputs the kernels take; raises
    otherwise."""
    for holds, message in _conditions(q, k, v):
        if not holds:
            raise ValueError(message())
    return q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], \
        q.shape[3], v.shape[3]


def _check_like(t, q):
    """Raises unless t shares q's type and device and the layout the
    kernels read: head dim contiguous, bf16 rows 16-byte aligned."""
    K.require(t.dtype == q.dtype and t.device == q.device
              and t.stride(-1) == 1,
              "out/dout must share q's type and device, head dim contiguous")
    K.require(t.dtype != torch.bfloat16
              or (t.data_ptr() % 16 == 0
                  and not any(s % 8 for s in t.stride()[:3])),
              "bf16 flash attention needs 16-byte aligned rows (base and "
              "batch/head/sequence strides multiples of 8)")


def _strides(*tensors):
    return (ct.c_int64 * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))


def _parts(n_split, B, H, Sq, D, device):
    """The split kernel's f32 scratch, one buffer (the C side's Parts): m
    [n, B, H, Sq], then l (the same shape), then acc [n, B, H, Sq, D]."""
    return torch.empty(n_split * B * H * Sq * (D + 2), dtype=torch.float32,
                       device=device)


def merge_partials(m, l, acc, out, *, kernel: str = "flash_attention"):
    """Merge split partials m/l [n_split, B, H, Sq] and acc [n_split, B, H,
    Sq, D] (f32, contiguous) into out [B, H, Sq, D] (f32 or bf16, any
    strides, head dim contiguous) by log-sum-exp; see
    :func:`merge_partials_ref`.  The split kernels' merge
    (``csrc/attn_merge.cuh``) as a kernel of its own, to check it, from the library
    of ``kernel``: "flash_attention" or "paged_attention" (decode), whose
    launch counter ``<kernel>_merge`` it moves.  Returns out."""
    if K.on_cpu(m, l, acc, out):
        return out.copy_(merge_partials_ref(m, l, acc))
    n_split, B, H, Sq = m.shape
    D = acc.shape[-1]
    K.require(m.dtype == l.dtype == acc.dtype == torch.float32
              and all(t.is_contiguous() for t in (m, l, acc))
              and l.shape == m.shape and acc.shape == (*m.shape, D)
              and out.shape == (B, H, Sq, D) and out.stride(-1) == 1,
              "merge takes contiguous f32 partials [n, B, H, Sq(, D)] and "
              "an out [B, H, Sq, D] with the head dim contiguous")
    K.require(D in MERGE_HEAD_DIMS and out.dtype in K.DTYPE_CODES,
              f"merge: head dim {D} / out type {out.dtype}")
    K.require(kernel in ("flash_attention", "paged_attention"),
              f"merge: no split kernel {kernel!r}")
    fn = _build.function(kernel, "attn_merge", _MERGE_ARGS)
    err = fn(m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
             K.DTYPE_CODES[out.dtype], n_split, B, H, Sq, D, _strides(out),
             K.stream_ptr(out))
    K.check_launch(err, f"{kernel}_merge")
    K.launches[f"{kernel}_merge"] += 1
    return out


def _forward(q, k, v, causal, window, kv_offset, with_lse: bool):
    """The kernel on CUDA tensors: (out, lse or None)."""
    B, H, Kh, Sq, Sk, D, Dv = _check(q, k, v)
    K.require(window >= 0, f"window {window} < 0")
    out = q.new_empty((B, H, Sq, Dv)) if Dv != D else torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    rows, n_split, buf = 0, 1, None
    if q.dtype == torch.bfloat16:
        rows, n_split = split_plan(B, H, Sq, Sk, D, q.device.index or 0, Dv)
        if n_split > 1:
            buf = _parts(n_split, B, H, Sq, Dv, q.device)
    fn = _build.function("flash_attention", "flash_attention", _ARGS)
    stream = K.stream_ptr(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             K.DTYPE_CODES[q.dtype], B, H, Kh, Sq, Sk, D, Dv, int(causal),
             int(window), int(kv_offset), _strides(q, k, v, out), rows,
             n_split, None if buf is None else buf.data_ptr(),
             K.tile_counters(q, stream, B * H * -(-Sq // rows),
                             "flash_attention") if n_split > 1 else None,
             None if lse is None else lse.data_ptr(), stream)
    K.check_launch(err, "flash_attention")
    K.launches["flash_attention"] += 1
    if n_split > 1:
        K.launches["flash_attention_split"] += 1
    if rows == WGMMA_ROWS:
        K.launches["flash_attention_wgmma"] += 1
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_offset: int = 0):
    """(out, lse): :func:`flash_attention`'s output and the f32 log-sum-exp
    [B, H, Sq] of each row's scaled, masked scores (``+inf`` for a row
    that sees no key), which the backward reads; see
    :func:`flash_attention_fwd_ref`.  Never builds an autograd graph."""
    if K.on_cpu(q, k, v):
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       kv_offset=kv_offset)
    return _forward(q, k, v, causal, window, kv_offset, True)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, kv_offset: int = 0):
    """(dq, dk, dv) of flash attention, each contiguous in its input's
    type: q [B, H, Sq, D], out/dout [B, H, Sq, Dv], k [B, Kh, Sk, D] and v
    [B, Kh, Sk, Dv] (any strides, head dim contiguous), lse [B, H, Sq] f32
    from
    :func:`flash_attention_fwd`; see :func:`flash_attention_bwd_ref`.
    bf16 runs on ``wgmma`` tiles fed by TMA (the head-split views read
    in place), f32 on CUDA cores; both give the same bits on every call.
    Rows that see no key get zero gradients."""
    if K.on_cpu(q, k, v, out, lse, dout):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       kv_offset=kv_offset)
    B, H, Kh, Sq, Sk, D, Dv = _check(q, k, v)
    K.require(window >= 0, f"window {window} < 0")
    if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]):
        dout = dout.contiguous()
    K.require(out.shape == dout.shape == (B, H, Sq, Dv),
              f"out/dout must be [B, H, Sq, Dv] = {(B, H, Sq, Dv)}")
    _check_like(out, q)
    _check_like(dout, q)
    K.require(lse.dtype == torch.float32 and lse.is_contiguous()
              and lse.shape == (B, H, Sq), "lse must be contiguous f32 "
              "[B, H, Sq]")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention", "flash_attention_bwd",
                         _BWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             K.DTYPE_CODES[q.dtype], B, H, Kh, Sq, Sk, D, Dv, int(causal),
             int(window), int(kv_offset),
             _strides(q, k, v, out, dout, dq, dk, dv), K.stream_ptr(q))
    K.check_launch(err, "flash_attention_bwd")
    K.launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel writes each
    row's log-sum-exp beside the output, and the backward kernel
    recomputes P from q, k and it (nothing of size Sq x Sk is kept)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_offset):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       window=window, kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, kv_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, kv_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         kv_offset=kv_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_offset: int = 0):
    """q: [B, H, Sq, D]; k: [B, Kh, Sk, D]; v: [B, Kh, Sk, Dv] (any
    strides, head dim contiguous; (D, Dv) in :data:`HEAD_DIMS` on the
    card).  Query row i sits at position ``kv_offset + i``; see
    :func:`flash_attention_ref` for the mask.  Returns [B, H, Sq, Dv] in
    q's type, laid out in memory as q is when Dv = D (else contiguous).  bf16 with a split (see
    :func:`plan`) merges the splits in the kernel's last blocks.  With
    grad on and an input that requires it, runs :class:`FlashAttentionFn`
    (the same forward, plus its log-sum-exp, and the backward kernel)."""
    cpu = K.on_cpu(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, kv_offset)
    if cpu:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_offset=kv_offset)
    return _forward(q, k, v, causal, window, kv_offset, False)[0]
