"""Wrappers for the fused cache write (KV cache AND image cache — they share
the paged block layout, so one kernel serves both).

Replaces ``repro/kernels/cache_write/kernel.py::cache_write_tpu``.  The
kernel (``csrc/cache_write.cu``) is bound by bytes: it reads each new row
once, from the T source planes where they lie (K and V as the projections
left them, no stacked copy), and writes it once into the pool, in place,
in 1 KB pieces of a row per warp.  Rows aimed at the scratch block (padded
lanes and chunk positions) are skipped when the caller names it.  The pool
tensor is written in place; there is no donation to imitate.
"""
from __future__ import annotations

import ctypes as ct

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.cache_write.ref import cache_write_ref

_P, _I, _L = ct.c_void_p, ct.c_int, ct.c_longlong
# pool dtype src dtype plane_stride row_stride slots n_rows n_slots
# tensor_stride base_row skip_lo skip_n w vec stream
_ARGTYPES = [_P, _I, _P, _I, _L, _L, _P, _L, _I, _L, _L, _I, _I, _I, _I, _P]


def _source(planes):
    """(first plane, plane stride, row stride) in elements of T source
    planes [n, w] of one type and shape, read where they lie: row r of
    plane t at first + t * plane stride + r * row stride.  That takes K and
    V as the projections leave them (any two planes of one type step by
    one stride) and one stacked [T, ...] tensor.  Raises for planes it
    cannot address so: the kernel never copies its input."""
    first = planes[0]
    n, w = first.shape
    row_stride = first.stride(0) if n > 1 else w
    esz, base = first.element_size(), first.data_ptr()
    step = planes[1].data_ptr() - base if len(planes) > 1 else 0
    for t, p in enumerate(planes):
        if p.shape != first.shape or p.dtype != first.dtype:
            raise ValueError(f"cache_write source planes differ: "
                             f"{[(tuple(q.shape), q.dtype) for q in planes]}")
        if p.stride(1) != 1 or (n > 1 and p.stride(0) != row_stride) \
                or p.data_ptr() != base + t * step or step % esz:
            raise ValueError(
                f"cache_write reads its {len(planes)} source planes [n, w] "
                f"where they lie: rows contiguous, one row stride for all "
                f"planes, and plane t's base at the first's plus t times one "
                f"stride; got strides {[q.stride() for q in planes]}, bases "
                f"{[q.data_ptr() - base for q in planes]} bytes from the "
                f"first")
    return first, step // esz, row_stride


def _launch(data, layer: int, planes, slots, scratch):
    """Row r of plane t (``planes``: T tensors [n, w]) lands in within-plane
    row slot ``slots[r]`` of tensor t, layer ``layer`` of the paged store
    ``data`` [T, L, NB, bs, w], cast to its type; with ``scratch`` (a
    slot), rows aimed at the block from that slot on are left alone."""
    T, L, NB, bs, w = data.shape
    src, plane_stride, row_stride = _source(planes)
    codes = K.DTYPE_CODES
    if not (len(planes) == T and src.shape[1] == w
            and src.shape[0] == slots.shape[0] > 0 and slots.ndim == 1
            and slots.dtype == torch.int32 and data.dtype in codes
            and src.dtype in codes and data.is_contiguous()
            and slots.is_contiguous()
            and data.device == src.device == slots.device):
        raise ValueError(
            f"cache_write takes {T} f32/bf16 source planes [n, {w}] and n "
            f"int32 slots on the device of a contiguous f32/bf16 pool; got "
            f"{[(tuple(p.shape), p.dtype, p.device) for p in planes]}, "
            f"slots {tuple(slots.shape)} {slots.dtype} {slots.device}, pool "
            f"{data.dtype} {data.device} contiguous={data.is_contiguous()}")
    esz = src.element_size()
    vec = int(data.dtype == src.dtype and (w * esz) % 16 == 0
              and (data.data_ptr() | src.data_ptr()) % 16 == 0
              and (plane_stride * esz) % 16 == 0
              and (row_stride * esz) % 16 == 0)
    fn = _build.function("cache_write", "cache_write", _ARGTYPES)
    n = slots.shape[0]
    err = fn(data.data_ptr(), codes[data.dtype], src.data_ptr(),
             codes[src.dtype], plane_stride, row_stride, slots.data_ptr(),
             T * n, n, L * NB * bs, layer * NB * bs,
             0 if scratch is None else int(scratch),
             0 if scratch is None else bs, w, vec, K.stream_ptr(data))
    K.check_launch(err, "cache_write")
    K.launches["cache_write"] += 1


def _write_ref(data, layer: int, rows, slots):
    """The plain version: rows [T, ..., w] at slots [...] of one layer of
    every tensor, every row written (the scratch rows too)."""
    T, L, NB, bs, w = data.shape
    if rows.shape[0] != T:
        raise ValueError(f"{rows.shape[0]} source planes for {T} pool "
                         f"tensors")
    plane = (torch.arange(T, dtype=torch.int64) * L + layer) * (NB * bs)
    slot_vec = plane[:, None] + slots.reshape(-1)[None, :].long()
    cache_write_ref(data.view(T * L * NB, bs, w), rows.reshape(-1, w),
                    slot_vec.reshape(-1))
    return data


def paged_token_write(data, layer: int, rows, slots, *, scratch=None):
    """Append one token per request into every tensor of one layer of a
    ``[T, L, num_blocks, bs, width]`` paged store with ONE fused kernel
    launch (paper §4.5: batch the many small per-token cache writes).

    rows: [T, B, width], or T tensors [B, width] (K and V as projected);
    slots: [B] within-plane row slots (``block * bs + offset``).
    ``scratch``: as for :func:`paged_chunk_write`.  Writes in place;
    returns ``data``.

    Exactly the C == 1 case of :func:`paged_chunk_write`.
    """
    split = isinstance(rows, (tuple, list))
    if K.on_cpu(data, slots, *(rows if split else (rows,))):
        return _write_ref(data, layer, torch.stack(rows) if split else rows,
                          slots)
    _launch(data, layer, list(rows), slots, scratch)
    return data


def paged_chunk_write(data, layer: int, rows, slots, *, scratch=None):
    """Append a whole prefill *chunk* per request — C tokens each — into
    every tensor of one layer of a ``[T, L, num_blocks, bs, width]`` paged
    store with ONE fused kernel launch.

    rows: [T, B, C, width], or T tensors [B, C, width] (K and V as
    projected: each is read where it lies); slots: [B, C] within-plane row
    slots (``block * bs + offset``; padded chunk positions point at the
    scratch block).  ``scratch``: the scratch block's first within-plane
    slot (``DevicePagedCache.scratch_block * bs``) or None.  With it, the
    kernel neither reads nor writes the rows aimed at that block, whose
    contents are undefined; the plain version writes every row.  Writes in
    place; returns ``data``.
    """
    split = isinstance(rows, (tuple, list))
    if K.on_cpu(data, slots, *(rows if split else (rows,))):
        return _write_ref(data, layer, torch.stack(rows) if split else rows,
                          slots)
    w = data.shape[-1]
    _launch(data, layer, [r.reshape(-1, w) for r in rows], slots.reshape(-1),
            scratch)
    return data
