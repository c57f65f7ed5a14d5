"""Wrappers for the fused cache write (KV cache AND image cache — they share
the paged block layout, so one kernel serves both).

Replaces ``repro/kernels/cache_write/kernel.py::cache_write_tpu``.  The
kernel (``csrc/cache_write.cu``) is bound by bytes: it reads each new row
once and writes it once into the pool, in place, with one block per row
and 16-byte accesses where the types and alignment allow.  The pool tensor
is written in place; there is no donation to imitate.
"""
from __future__ import annotations

import ctypes as ct

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.cache_write.ref import cache_write_ref

_ARGTYPES = [ct.c_void_p, ct.c_int, ct.c_void_p, ct.c_int, ct.c_void_p,
             ct.c_int, ct.c_int, ct.c_longlong, ct.c_longlong, ct.c_int,
             ct.c_int, ct.c_void_p]


def _launch(pool, rows, slots, *, n_slots: int, tensor_stride: int,
            base_row: int):
    """Row i of ``rows`` [n, w] lands in pool row ``base_row + (i //
    n_slots) * tensor_stride + slots[i % n_slots]``, cast to the pool
    type.  ``pool`` is any contiguous tensor whose last dim is w."""
    w = pool.shape[-1]
    K.require(pool.dtype in K.DTYPE_CODES and rows.dtype in K.DTYPE_CODES,
              f"cache_write takes f32/bf16, got {pool.dtype}/{rows.dtype}")
    K.require(slots.dtype == torch.int32, "cache_write slots must be int32")
    K.require(pool.is_contiguous() and rows.is_contiguous()
              and slots.is_contiguous(), "cache_write needs contiguous inputs")
    K.require(rows.ndim == 2 and rows.shape[1] == w,
              f"rows {tuple(rows.shape)} do not match pool width {w}")
    K.require(slots.numel() == n_slots and n_slots > 0
              and rows.shape[0] % n_slots == 0,
              "rows must be a whole number of slot vectors")
    K.require(pool.device == rows.device == slots.device,
              "cache_write inputs must share one device")
    vec = int(pool.dtype == rows.dtype
              and (w * pool.element_size()) % 16 == 0
              and pool.data_ptr() % 16 == 0 and rows.data_ptr() % 16 == 0)
    fn = _build.function("cache_write", "cache_write", _ARGTYPES)
    err = fn(pool.data_ptr(), K.DTYPE_CODES[pool.dtype], rows.data_ptr(),
             K.DTYPE_CODES[rows.dtype], slots.data_ptr(), rows.shape[0],
             n_slots, tensor_stride, base_row, w, vec, K.stream_ptr(pool))
    K.check_launch(err, "cache_write")
    K.launches["cache_write"] += 1


def paged_token_write(data, layer: int, rows, slots):
    """Append one token per request into every tensor of one layer of a
    ``[T, L, num_blocks, bs, width]`` paged store with ONE fused kernel
    launch (paper §4.5: batch the many small per-token cache writes).

    rows: [T, B, width] new per-tensor rows; slots: [B] within-plane row
    slots (``block * bs + offset``).  Writes in place; returns ``data``.

    Exactly the C == 1 case of :func:`paged_chunk_write`.
    """
    return paged_chunk_write(data, layer, rows[:, :, None, :], slots[:, None])


def paged_chunk_write(data, layer: int, rows, slots):
    """Append a whole prefill *chunk* per request — C tokens each — into
    every tensor of one layer of a ``[T, L, num_blocks, bs, width]`` paged
    store with ONE fused kernel launch.

    rows: [T, B, C, width] new per-tensor chunk rows; slots: [B, C]
    within-plane row slots (``block * bs + offset``; padded chunk positions
    point at the scratch block).  Writes in place; returns ``data``.
    """
    T, L, NB, bs, w = data.shape
    B, C = slots.shape
    cpu = K.on_cpu(data, rows, slots)
    new = rows.reshape(T * B * C, w)
    if cpu:
        plane = (torch.arange(T, dtype=torch.int64) * L + layer) * (NB * bs)
        slot_vec = plane[:, None] + slots.reshape(-1)[None, :].long()
        cache_write_ref(data.view(T * L * NB, bs, w), new,
                        slot_vec.reshape(-1))
        return data
    _launch(data, new, slots.reshape(-1), n_slots=B * C,
            tensor_stride=L * NB * bs, base_row=layer * NB * bs)
    return data
