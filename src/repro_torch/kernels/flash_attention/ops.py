"""Wrapper for full-sequence flash attention.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_tpu``
and the block padding of its wrapper.  It launches
``csrc/flash_attention.cu``: one block per (batch, head, tile of query
rows) loops over tiles of 64 keys staged in shared memory and carries an
online softmax in f32; ragged Sq and Sk are bounded inside the kernel, and
q/k/v/out are addressed through their strides, so head-split views of a
projection are read and written without a copy.  Long sequences are bound
by the score and value products (on CUDA cores in this first version),
a single query row by the bytes of K/V.
"""
from __future__ import annotations

import ctypes as ct

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I = ct.c_void_p, ct.c_int
# q k v out, dtype B H Kh Sq Sk D causal window kv_offset, strides, stream
_ARGS = [_P] * 4 + [_I] * 10 + [ct.POINTER(ct.c_int64), _P]
HEAD_DIMS = (64, 128)                   # D the kernel is built for


def _check(q, k, v):
    K.require(q.ndim == 4 and k.ndim == 4 and k.shape == v.shape,
              f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
              f"{tuple(v.shape)} must be [B, H, Sq, D] / [B, Kh, Sk, D]")
    B, H, Sq, D = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    K.require(k.shape[0] == B and k.shape[3] == D,
              f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    K.require(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    K.require(Kh > 0 and H % Kh == 0, f"{H} query heads over {Kh} KV heads")
    K.require(q.dtype in K.DTYPE_CODES and k.dtype == v.dtype == q.dtype,
              f"q/k/v must share one type of f32/bf16, got "
              f"{q.dtype}/{k.dtype}/{v.dtype}")
    K.require(all(t.stride(-1) == 1 for t in (q, k, v)),
              "flash attention needs the head dim contiguous")
    K.require(len({t.device for t in (q, k, v)}) == 1,
              "flash attention inputs must share one device")
    return B, H, Kh, Sq, Sk, D


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_offset: int = 0):
    """q: [B, H, Sq, D]; k/v: [B, Kh, Sk, D] (any strides, head dim
    contiguous).  Query row i sits at position ``kv_offset + i``; see
    :func:`flash_attention_ref` for the mask.  Returns [B, H, Sq, D] in
    q's type, laid out in memory as q is."""
    if K.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_offset=kv_offset)
    B, H, Kh, Sq, Sk, D = _check(q, k, v)
    K.require(window >= 0, f"window {window} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ct.c_int64 * 12)(*(s for t in (q, k, v, out)
                                  for s in t.stride()[:3]))
    fn = _build.function("flash_attention", "flash_attention", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             K.DTYPE_CODES[q.dtype], B, H, Kh, Sq, Sk, D, int(causal),
             int(window), int(kv_offset), strides, K.stream_ptr(q))
    K.check_launch(err, "flash_attention")
    K.launches["flash_attention"] += 1
    return out
