"""Wrappers for the selective scan: Mamba-1's, and Mamba-2's per-head mode.

Replaces ``repro/kernels/selective_scan/kernel.py::selective_scan_tpu``
(Mamba-1), and runs the same recurrence for the Mamba-2 blocks whose
reference is ``repro/models/mamba.py``'s ``lax.scan`` over
``_ssm2_step``: one dt and one scalar A per head of P channels, one B/C
group.  Both launch ``csrc/selective_scan.cu``, whose blocks of 32
channels take the sequence in chunks, each thread loading its share of
the next chunk into registers while the current one runs from shared
memory, the states never leaving registers.  Mamba-1 spreads each
channel's N states over N / 4 adjacent lanes of 4 states each, which sum
y_t by shuffles; it is bound by its exponentials (one per step, channel
and state, each one special-function-unit operation).  The per-head mode
takes one exponential per (step, head) when the chunk is staged, and a
lane holds 4 channels by 4 states, so its bound is the three f32
instructions per (step, channel, state) of the recurrence and y.  The
inputs and ``y`` are read and written once.
"""
from __future__ import annotations

import ctypes as ct

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.ref import (selective_scan_heads_ref,
                                                    selective_scan_ref)

_P, _I = ct.c_void_p, ct.c_int
_ARGS = [_P] * 8 + [_I] * 5 + [_P]      # dt x A B C h0 y h, dtype B S d N
_HEAD_ARGS = [_P] * 8 + [_I] * 6 + [_P]  # ..., dtype B S H P N
STATE_SIZES = (4, 8, 16)                # N the Mamba-1 kernel is built for
HEAD_STATE_SIZES = (64,)                # N the per-head mode is built for
HEAD_CHANNELS = 32                      # P must be a multiple of this


def _check_types(dt, x, Bmat, Cmat, h0, h0_shape, ins):
    K.require(x.dtype in K.DTYPE_CODES
              and dt.dtype == Bmat.dtype == Cmat.dtype == x.dtype,
              f"dt/x/B/C must share one type of f32/bf16, got "
              f"{dt.dtype}/{x.dtype}/{Bmat.dtype}/{Cmat.dtype}")
    if h0 is not None:
        K.require(tuple(h0.shape) == h0_shape and h0.dtype == torch.float32,
                  f"h0 must be {list(h0_shape)} f32, got "
                  f"{tuple(h0.shape)} {h0.dtype}")
        ins = ins + [h0]
    K.require(all(t.is_contiguous() for t in ins),
              "selective scan needs contiguous inputs")


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
    K.require(S > 0 and Bsz > 0, "empty scan")
    _check_types(dt, x, Bmat, Cmat, h0, (Bsz, d, N), [dt, x, A, Bmat, Cmat])
    return Bsz, S, d, N


def _check_heads(dt, x, A, Bmat, Cmat, h0):
    K.require(x.ndim == 3 and dt.ndim == 3 and dt.shape[:2] == x.shape[:2],
              f"dt {tuple(dt.shape)} / x {tuple(x.shape)} must be [B, S, H] "
              f"/ [B, S, H*P]")
    Bsz, S, Hh = dt.shape
    K.require(Hh > 0 and x.shape[2] % Hh == 0,
              f"x width {x.shape[2]} is not a multiple of H={Hh}")
    P = x.shape[2] // Hh
    K.require(P % HEAD_CHANNELS == 0,
              f"head width P={P} is not a multiple of {HEAD_CHANNELS}")
    K.require(A.shape == (Hh,) and A.dtype == torch.float32,
              f"A must be [{Hh}] f32, got {tuple(A.shape)} {A.dtype}")
    K.require(Bmat.ndim == 3 and Bmat.shape[:2] == (Bsz, S)
              and Bmat.shape == Cmat.shape,
              f"B/C {tuple(Bmat.shape)}/{tuple(Cmat.shape)} must be "
              f"[{Bsz}, {S}, N]")
    N = Bmat.shape[2]
    K.require(N in HEAD_STATE_SIZES,
              f"state size N={N} not in {HEAD_STATE_SIZES}")
    K.require(S > 0 and Bsz > 0, "empty scan")
    _check_types(dt, x, Bmat, Cmat, h0, (Bsz, Hh, P, N),
                 [dt, x, A, Bmat, Cmat])
    return Bsz, S, Hh, P, N


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


def selective_scan_heads(dt, x, A, Bmat, Cmat, h0=None):
    """Mamba-2's scan.  dt: [B, S, H]; x: [B, S, H*P]; A: [H] f32;
    Bmat/Cmat: [B, S, N] (one group); h0: [B, H, P, N] f32 or None
    (zeros).  Returns (y [B, S, H*P] f32, h_final [B, H, P, N] f32).  A
    position with dt = 0 leaves h exactly as it was."""
    ins = (dt, x, A, Bmat, Cmat) + (() if h0 is None else (h0,))
    if K.on_cpu(*ins):
        return selective_scan_heads_ref(dt, x, A, Bmat, Cmat, h0)
    Bsz, S, Hh, P, N = _check_heads(dt, x, A, Bmat, Cmat, h0)
    y = torch.empty((Bsz, S, Hh * P), dtype=torch.float32, device=x.device)
    h = torch.empty((Bsz, Hh, P, N), dtype=torch.float32, device=x.device)
    fn = _build.function("selective_scan", "selective_scan_heads",
                         _HEAD_ARGS)
    err = fn(dt.data_ptr(), x.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
             Cmat.data_ptr(), 0 if h0 is None else h0.data_ptr(),
             y.data_ptr(), h.data_ptr(), K.DTYPE_CODES[x.dtype], Bsz, S, Hh,
             P, N, K.stream_ptr(x))
    K.check_launch(err, "selective_scan_heads")
    K.launches["selective_scan_heads"] += 1
    return y, h
