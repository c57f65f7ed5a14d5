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
partials and a second kernel merges them (``launches`` counts it as
``flash_attention_merge``).  f32 runs on CUDA-core f32 products, which
keep the f32 model checks' tolerances.
"""
from __future__ import annotations

import ctypes as ct

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    BLOCK_K, flash_attention_ref, merge_partials_ref)

_P, _I = ct.c_void_p, ct.c_int
_STRIDES = ct.POINTER(ct.c_int64)
# q k v out, dtype B H Kh Sq Sk D causal window kv_offset, strides,
# rows n_split, parts, stream
_ARGS = [_P] * 4 + [_I] * 10 + [_STRIDES] + [_I] * 2 + [_P] * 2
# part_m part_l part_acc out, dtype n_split B H Sq D, strides, stream
_MERGE_ARGS = [_P] * 4 + [_I] * 6 + [_STRIDES, _P]
HEAD_DIMS = (64, 128)                   # D the kernel is built for
MERGE_HEAD_DIMS = (32, 64, 128, 256)    # D the merge is built for
MAX_WARPS = 4                           # warps of a block
WAVE_WARPS = 2 * 4                      # two waves of 4-warp blocks per SM


def plan(B: int, H: int, Sq: int, Sk: int, n_sms: int) -> tuple:
    """(rows, n_split) for the bf16 kernel.  rows is the query tile: one
    warp of 16 rows when Sq <= 16, else four warps of 16 rows.  n_split is
    how many ranges of whole ``BLOCK_K``-key tiles the keys are split
    into: 1, unless the grid of (b, h, query tile) blocks holds fewer
    16-row warp tiles than two waves of 4-warp blocks on ``n_sms`` SMs;
    then the fewest splits that reach that many, each of ceil(tiles /
    n_split) tiles and none empty (or one tile per split, if there are too
    few tiles)."""
    rows = 16 if Sq <= 16 else 16 * MAX_WARPS
    grid_warps = B * H * -(-Sq // rows) * (rows // 16)
    tiles = -(-Sk // BLOCK_K)
    target = WAVE_WARPS * n_sms
    if grid_warps >= target or tiles <= 1:
        return rows, 1
    n_split = min(tiles, -(-target // grid_warps))
    while -(-tiles // -(-tiles // n_split)) != n_split:   # no empty split
        n_split += 1
    return rows, n_split


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
    :func:`merge_partials_ref`.  The second kernel of a split path
    (``csrc/attn_merge.cuh``), launched alone to check it, from the library
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
    :func:`plan`) launches the split kernel and then the merge."""
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
        rows, n_split = plan(B, H, Sq, Sk, K.n_sms(q.device.index or 0))
        if n_split > 1:
            buf = _parts(n_split, B, H, Sq, D, q.device)
    fn = _build.function("flash_attention", "flash_attention", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             K.DTYPE_CODES[q.dtype], B, H, Kh, Sq, Sk, D, int(causal),
             int(window), int(kv_offset), _strides(q, k, v, out), rows,
             n_split, None if buf is None else buf.data_ptr(),
             K.stream_ptr(q))
    K.check_launch(err, "flash_attention")
    K.launches["flash_attention"] += 1
    if n_split > 1:
        K.launches["flash_attention_merge"] += 1
    return out
