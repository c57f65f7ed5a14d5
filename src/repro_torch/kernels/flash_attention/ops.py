"""Wrappers for full-sequence flash attention.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_tpu``
and the block padding of its wrapper.  It launches
``csrc/flash_attention.cu``: one block per (batch, head, tile of query
rows) loops over tiles of 64 keys and carries an online softmax in f32;
ragged Sq and Sk are bounded inside the kernel, and q/k/v/out are
addressed through their strides, so head-split views of a projection are
read and written without a copy.

bf16 runs on the tensor-core tile of ``csrc/attn_mma.cuh``.  When the grid
of query tiles is too small to fill the card (decode rows, short prefill
chunks), :func:`plan` splits the keys: the kernel writes per-split f32
partials and the last block of each (b, h, query tile) to finish merges
them in the same launch (``launches`` counts such calls as
``flash_attention_split``).  f32 runs on CUDA-core f32 products, which
keep the f32 model checks' tolerances.
"""
from __future__ import annotations

import ctypes as ct
import functools

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    BLOCK_K, flash_attention_ref, merge_partials_ref)

_P, _I = ct.c_void_p, ct.c_int
_STRIDES = ct.POINTER(ct.c_int64)
# q k v out, dtype B H Kh Sq Sk D causal window kv_offset, strides,
# rows n_split, parts, counters, stream
_ARGS = [_P] * 4 + [_I] * 10 + [_STRIDES] + [_I] * 2 + [_P] * 3
# part_m part_l part_acc out, dtype n_split B H Sq D, strides, stream
_MERGE_ARGS = [_P] * 4 + [_I] * 6 + [_STRIDES, _P]
HEAD_DIMS = (64, 128)                   # D the kernel is built for
MERGE_HEAD_DIMS = (32, 64, 128, 256)    # D the merge is built for
MAX_WARPS = 4                           # warps of a block
MAX_SPLITS_64 = 4   # splits of a 64-row tile, whose last block folds in the
#                     others' partials one round trip to L2 each


def tile_rows(Sq: int) -> int:
    """The bf16 kernel's query tile: one warp of 16 rows when Sq <= 16,
    else four warps of 16 rows."""
    return 16 if Sq <= 16 else 16 * MAX_WARPS


def plan(B: int, H: int, Sq: int, Sk: int, n_sms: int, per_sm: int) -> tuple:
    """(rows, n_split) for the bf16 kernel: rows = :func:`tile_rows`, and
    n_split, how many ranges of whole ``BLOCK_K``-key tiles the keys are
    split into, the most that keeps every block of the call in one wave
    of ``per_sm`` blocks of that tile on each of ``n_sms`` SMs (see
    :func:`blocks_per_sm`), none empty, and for 64-row tiles at most
    ``MAX_SPLITS_64``; 1 when the (b, h, query tile) blocks alone fill half
    a wave, or there is one tile.  A second wave of split blocks, or a
    64-row tile's fifth split, costs more than the shorter key ranges save
    (``tools/kernel_ab.py``'s plan sweep; PERF.md)."""
    rows = tile_rows(Sq)
    blocks = B * H * -(-Sq // rows)
    tiles = -(-Sk // BLOCK_K)
    most = min(tiles, n_sms * per_sm // max(blocks, 1))
    if rows == 64:
        most = min(most, MAX_SPLITS_64)
    if most <= 1:
        return rows, 1
    per = -(-tiles // most)
    return rows, -(-tiles // per)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(rows: int, D: int) -> int:
    """Blocks of the bf16 kernel's ``rows``-row tile at head dim D that one
    SM holds at once (the CUDA occupancy calculator; asked once per
    process)."""
    n = ct.c_int()
    fn = _build.function("flash_attention", "flash_blocks_per_sm",
                         [_I, _I, _P])
    K.check_launch(fn(rows, D, ct.byref(n)), "flash_attention occupancy")
    return n.value


def split_plan(B: int, H: int, Sq: int, Sk: int, D: int, index: int) -> tuple:
    """:func:`plan` on CUDA device ``index``: its SMs, and the blocks of
    the tile that one of them holds."""
    return plan(B, H, Sq, Sk, K.n_sms(index), blocks_per_sm(tile_rows(Sq), D))


def _conditions(q, k, v):
    """(holds, message) for each condition on the kernels' inputs, in an
    order where each may assume the ones before it; a message is a lambda,
    formatted only for a condition that fails."""
    yield (q.ndim == 4 and k.ndim == 4 and k.shape == v.shape,
           lambda: f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                   f"{tuple(v.shape)} must be [B, H, Sq, D] / [B, Kh, Sk, D]")
    yield (k.shape[0] == q.shape[0] and k.shape[3] == q.shape[3],
           lambda: f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    yield q.shape[3] in HEAD_DIMS, lambda: (f"head dim {q.shape[3]} not in "
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
    """(B, H, Kh, Sq, Sk, D) of inputs the kernels take; raises otherwise."""
    for holds, message in _conditions(q, k, v):
        if not holds:
            raise ValueError(message())
    return q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], \
        q.shape[3]


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_offset: int = 0):
    """q: [B, H, Sq, D]; k/v: [B, Kh, Sk, D] (any strides, head dim
    contiguous).  Query row i sits at position ``kv_offset + i``; see
    :func:`flash_attention_ref` for the mask.  Returns [B, H, Sq, D] in
    q's type, laid out in memory as q is.  bf16 with a split (see
    :func:`plan`) merges the splits in the kernel's last blocks."""
    if K.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_offset=kv_offset)
    B, H, Kh, Sq, Sk, D = _check(q, k, v)
    K.require(window >= 0, f"window {window} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rows, n_split, buf = 0, 1, None
    if q.dtype == torch.bfloat16:
        rows, n_split = split_plan(B, H, Sq, Sk, D, q.device.index or 0)
        if n_split > 1:
            buf = _parts(n_split, B, H, Sq, D, q.device)
    fn = _build.function("flash_attention", "flash_attention", _ARGS)
    stream = K.stream_ptr(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             K.DTYPE_CODES[q.dtype], B, H, Kh, Sq, Sk, D, int(causal),
             int(window), int(kv_offset), _strides(q, k, v, out), rows,
             n_split, None if buf is None else buf.data_ptr(),
             K.tile_counters(q, stream, B * H * -(-Sq // rows),
                             "flash_attention") if n_split > 1 else None,
             stream)
    K.check_launch(err, "flash_attention")
    K.launches["flash_attention"] += 1
    if n_split > 1:
        K.launches["flash_attention_split"] += 1
    return out
