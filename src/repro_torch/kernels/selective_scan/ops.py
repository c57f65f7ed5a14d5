"""Wrapper for the Mamba-1 selective scan.

Replaces ``repro/kernels/selective_scan/kernel.py::selective_scan_tpu``.
It launches ``csrc/selective_scan.cu``: each channel's N states are spread
over N / 4 adjacent lanes of 4 states each, in registers, which walk the
sequence together and sum y_t by shuffles; blocks of 32 channels take the
sequence in chunks, each thread loading its share of the next chunk into
registers while the current one runs from shared memory.  The scan is
bound by its exponentials (one per step, channel and state, each one
special-function-unit operation); the inputs and ``y`` are read and
written once.
"""
from __future__ import annotations

import ctypes as ct

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

_P, _I = ct.c_void_p, ct.c_int
_ARGS = [_P] * 8 + [_I] * 5 + [_P]      # dt x A B C h0 y h, dtype B S d N
STATE_SIZES = (4, 8, 16)                # N the kernel is built for


def _check(dt, x, A, Bmat, Cmat, h0):
    K.require(x.ndim == 3 and dt.shape == x.shape,
              f"dt {tuple(dt.shape)} / x {tuple(x.shape)} must be [B, S, d]")
    Bsz, S, d = x.shape
    K.require(A.ndim == 2 and A.shape[0] == d and A.dtype == torch.float32,
              f"A must be [d, N] f32, got {tuple(A.shape)} {A.dtype}")
    N = A.shape[1]
    K.require(N in STATE_SIZES, f"state size N={N} not in {STATE_SIZES}")
    K.require(Bmat.shape == Cmat.shape == (Bsz, S, N),
              f"B/C {tuple(Bmat.shape)}/{tuple(Cmat.shape)} must be "
              f"[{Bsz}, {S}, {N}]")
    K.require(x.dtype in K.DTYPE_CODES
              and dt.dtype == Bmat.dtype == Cmat.dtype == x.dtype,
              f"dt/x/B/C must share one type of f32/bf16, got "
              f"{dt.dtype}/{x.dtype}/{Bmat.dtype}/{Cmat.dtype}")
    K.require(S > 0 and Bsz > 0, "empty scan")
    ins = [dt, x, A, Bmat, Cmat]
    if h0 is not None:
        K.require(h0.shape == (Bsz, d, N) and h0.dtype == torch.float32,
                  f"h0 must be [B, d, N] f32, got {tuple(h0.shape)} "
                  f"{h0.dtype}")
        ins.append(h0)
    K.require(all(t.is_contiguous() for t in ins),
              "selective scan needs contiguous inputs")
    return Bsz, S, d, N


def selective_scan(dt, x, A, Bmat, Cmat, h0=None):
    """dt/x: [B, S, d]; A: [d, N] f32; Bmat/Cmat: [B, S, N]; h0: [B, d, N]
    f32 or None (zeros).  Returns (y [B, S, d] f32, h_final [B, d, N] f32).
    A position with dt = 0 leaves h exactly as it was."""
    ins = (dt, x, A, Bmat, Cmat) + (() if h0 is None else (h0,))
    if K.on_cpu(*ins):
        return selective_scan_ref(dt, x, A, Bmat, Cmat, h0)
    Bsz, S, d, N = _check(dt, x, A, Bmat, Cmat, h0)
    y = torch.empty((Bsz, S, d), dtype=torch.float32, device=x.device)
    h = torch.empty((Bsz, d, N), dtype=torch.float32, device=x.device)
    fn = _build.function("selective_scan", "selective_scan", _ARGS)
    err = fn(dt.data_ptr(), x.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
             Cmat.data_ptr(), 0 if h0 is None else h0.data_ptr(),
             y.data_ptr(), h.data_ptr(), K.DTYPE_CODES[x.dtype], Bsz, S, d,
             N, K.stream_ptr(x))
    K.check_launch(err, "selective_scan")
    K.launches["selective_scan"] += 1
    return y, h
