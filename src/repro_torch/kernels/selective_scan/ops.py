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

Training: ``selective_scan_bwd`` / ``selective_scan_heads_bwd`` launch the
same file's backward kernels (the gradient the JAX package takes with
``jax.grad`` through its ``lax.scan``): blocks of 64 channels stage the
sequence in shared memory 16 steps at a time by ``cp.async``, rerun the
recurrence forward to save the state every 8 (Mamba-1) or 16 (per-head)
steps, then walk backward, rebuilding each interval's states in
registers and running the reverse recurrence over them, each exponential
taken at most twice; sums across lanes are transposed shuffle reductions,
across warps and blocks fixed-order sums (f32 partials folded by a second
kernel), so every call gives the same bits.  :func:`bwd_plan` is the
host's side of that layout: grid and scratch.
With grad on and an input that requires it, ``selective_scan`` and
``selective_scan_heads`` run :class:`SelectiveScanFn` /
:class:`SelectiveScanHeadsFn`, which save only the inputs.
"""
from __future__ import annotations

import ctypes as ct

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.ref import (
    selective_scan_bwd_ref, selective_scan_heads_bwd_ref,
    selective_scan_heads_ref, selective_scan_ref)

_P, _I = ct.c_void_p, ct.c_int
_ARGS = [_P] * 8 + [_I] * 5 + [_P]      # dt x A B C h0 y h, dtype B S d N
_HEAD_ARGS = [_P] * 8 + [_I] * 6 + [_P]  # ..., dtype B S H P N
STATE_SIZES = (4, 8, 16)                # N the Mamba-1 kernel is built for
HEAD_STATE_SIZES = (64,)                # N the per-head mode is built for
HEAD_CHANNELS = 32                      # P must be a multiple of this
_BWD_ARGS = [_P] * 18 + [_I] * 5 + [_P]       # ... hs pB pC pA, dtype B S d N
_HEAD_BWD_ARGS = [_P] * 19 + [_I] * 6 + [_P]  # ... pdt pA, dtype B S H P N
BWD_CHUNK = 8          # Mamba-1's backward saves the state every this many steps
HEAD_BWD_CHUNK = 16    # the per-head backward's (its staged chunk)
BWD_CHANNELS = 64      # channels a backward block holds and sums dB, dC over
BWD_MULTIPLE = 32      # d (Mamba-1) must be a multiple of this: a tail block's
                       # dead channels are whole warps


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


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def selective_scan(dt, x, A, Bmat, Cmat, h0=None):
    """dt/x: [B, S, d]; A: [d, N] f32; Bmat/Cmat: [B, S, N]; h0: [B, d, N]
    f32 or None (zeros).  Returns (y [B, S, d] f32, h_final [B, d, N] f32).
    A position with dt = 0 leaves h exactly as it was.  With grad on and
    an input that requires it, runs :class:`SelectiveScanFn`."""
    _inputs_on_cpu(dt, x, A, Bmat, Cmat, h0)   # raises: CUDA without a card
    if _wants_grad(dt, x, A, Bmat, Cmat, h0):
        return SelectiveScanFn.apply(dt, x, A, Bmat, Cmat, h0)
    return _scan(dt, x, A, Bmat, Cmat, h0)


def _inputs_on_cpu(*ts) -> bool:
    return K.on_cpu(*(t for t in ts if t is not None))


def _scan(dt, x, A, Bmat, Cmat, h0):
    if _inputs_on_cpu(dt, x, A, Bmat, Cmat, h0):
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
    position with dt = 0 leaves h exactly as it was.  With grad on and an
    input that requires it, runs :class:`SelectiveScanHeadsFn`."""
    _inputs_on_cpu(dt, x, A, Bmat, Cmat, h0)   # raises: CUDA without a card
    if _wants_grad(dt, x, A, Bmat, Cmat, h0):
        return SelectiveScanHeadsFn.apply(dt, x, A, Bmat, Cmat, h0)
    return _scan_heads(dt, x, A, Bmat, Cmat, h0)


def _scan_heads(dt, x, A, Bmat, Cmat, h0):
    if _inputs_on_cpu(dt, x, A, Bmat, Cmat, h0):
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


# ---------------------------------------------------------------------------
# backward (training)
# ---------------------------------------------------------------------------
def _check_grads(dy, dh_final, y_shape, h_shape):
    K.require(dy.dtype == torch.float32 and dy.is_contiguous()
              and tuple(dy.shape) == y_shape,
              f"dy must be contiguous f32 {list(y_shape)}, got "
              f"{tuple(dy.shape)} {dy.dtype}")
    if dh_final is not None:
        K.require(dh_final.dtype == torch.float32 and dh_final.is_contiguous()
                  and tuple(dh_final.shape) == h_shape,
                  f"dh_final must be contiguous f32 {list(h_shape)}, got "
                  f"{tuple(dh_final.shape)} {dh_final.dtype}")


def _typed(grads, dt, x, Bmat):
    """The plain backward's f32 gradients in the kernels' types: ddt, dx,
    dB and dC in their inputs' type, dA and dh0 f32."""
    ddt, dx, dA, dB, dC, dh0 = grads
    return (ddt.to(dt.dtype), dx.to(x.dtype), dA, dB.to(Bmat.dtype),
            dC.to(Bmat.dtype), dh0)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _aligned(t):
    """``t``, copied when its data does not start on 16 bytes: the
    backward kernels stage their inputs by 16-byte ``cp.async``."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bwd_plan(Bsz: int, S: int, d: int, N: int, heads: int | None = None
             ) -> dict:
    """The backward kernels' grid and f32 scratch for a call: ``grid``
    (blocks over channels, lanes b; the last block of a row (Mamba-1) or
    of each head masks the channels past its end); ``saved``, the states
    hs keeps a lane; and the scratch shapes ``hs``, ``pB`` (= ``pC``),
    ``pA`` and, per head, ``pdt``."""
    if heads is None:
        blocks, width, chunk = -(-d // BWD_CHANNELS), d, BWD_CHUNK
    else:
        width, chunk = d // heads, HEAD_BWD_CHUNK
        blocks = heads * -(-width // BWD_CHANNELS)
    per = -(-width // BWD_CHANNELS)            # blocks a row or head
    saved = -(-S // chunk)
    plan = dict(grid=(blocks, Bsz), saved=saved, hs=(Bsz, saved, d, N),
                pB=(blocks, Bsz, S, N),
                pA=(Bsz, d, N) if heads is None else (heads, Bsz, per))
    if heads is not None:
        plan["pdt"] = (Bsz, S, heads, per)
    return plan


def _scratch(plan, device) -> dict:
    """Empty f32 scratch of a :func:`bwd_plan`, by name."""
    f32 = dict(dtype=torch.float32, device=device)
    out = {k: torch.empty(plan[k], **f32)
           for k in ("hs", "pB", "pdt", "pA") if k in plan}
    out["pC"] = torch.empty_like(out["pB"])
    return out


def selective_scan_bwd(dt, x, A, Bmat, Cmat, h0, dy, dh_final=None):
    """Gradient of :func:`selective_scan`: dy [B, S, d] f32 (of y),
    dh_final [B, d, N] f32 (of h_final) or None (zeros).  Returns (ddt, dx
    [B, S, d], dA [d, N], dB, dC [B, S, N], dh0 [B, d, N]): ddt, dx, dB and
    dC in the inputs' type (summed in f32, rounded once), dA and dh0 f32.
    d must be a multiple of 32.  The same bits on every call."""
    if _inputs_on_cpu(dt, x, A, Bmat, Cmat, h0, dy, dh_final):
        return _typed(selective_scan_bwd_ref(dt, x, A, Bmat, Cmat, h0, dy,
                                             dh_final), dt, x, Bmat)
    Bsz, S, d, N = _check(dt, x, A, Bmat, Cmat, h0)
    K.require(d % BWD_MULTIPLE == 0,
              f"the backward needs d={d} a multiple of {BWD_MULTIPLE}")
    _check_grads(dy, dh_final, (Bsz, S, d), (Bsz, d, N))
    dt, x, Bmat, Cmat, dy = map(_aligned, (dt, x, Bmat, Cmat, dy))
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC = torch.empty_like(Bmat), torch.empty_like(Cmat)
    dA = torch.empty((d, N), dtype=torch.float32, device=x.device)
    dh0 = torch.empty((Bsz, d, N), dtype=torch.float32, device=x.device)
    ws = _scratch(bwd_plan(Bsz, S, d, N), x.device)
    fn = _build.function("selective_scan", "selective_scan_bwd", _BWD_ARGS)
    err = fn(dt.data_ptr(), x.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
             Cmat.data_ptr(), _ptr(h0), dy.data_ptr(), _ptr(dh_final),
             ddt.data_ptr(), dx.data_ptr(), dA.data_ptr(), dB.data_ptr(),
             dC.data_ptr(), dh0.data_ptr(), ws["hs"].data_ptr(),
             ws["pB"].data_ptr(), ws["pC"].data_ptr(), ws["pA"].data_ptr(),
             K.DTYPE_CODES[x.dtype], Bsz, S, d, N, K.stream_ptr(x))
    K.check_launch(err, "selective_scan_bwd")
    K.launches["selective_scan_bwd"] += 1
    return ddt, dx, dA, dB, dC, dh0


def selective_scan_heads_bwd(dt, x, A, Bmat, Cmat, h0, dy, dh_final=None):
    """Gradient of :func:`selective_scan_heads`: dy [B, S, H*P] f32,
    dh_final [B, H, P, N] f32 or None (zeros).  Returns (ddt [B, S, H], dx
    [B, S, H*P], dA [H], dB, dC [B, S, N], dh0 [B, H, P, N]), typed as
    :func:`selective_scan_bwd`'s.  The same bits on every call."""
    if _inputs_on_cpu(dt, x, A, Bmat, Cmat, h0, dy, dh_final):
        return _typed(selective_scan_heads_bwd_ref(dt, x, A, Bmat, Cmat, h0,
                                                   dy, dh_final),
                      dt, x, Bmat)
    Bsz, S, Hh, P, N = _check_heads(dt, x, A, Bmat, Cmat, h0)
    d = Hh * P
    _check_grads(dy, dh_final, (Bsz, S, d), (Bsz, Hh, P, N))
    x, Bmat, Cmat, dy = map(_aligned, (x, Bmat, Cmat, dy))
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC = torch.empty_like(Bmat), torch.empty_like(Cmat)
    dA = torch.empty((Hh,), dtype=torch.float32, device=x.device)
    dh0 = torch.empty((Bsz, Hh, P, N), dtype=torch.float32, device=x.device)
    ws = _scratch(bwd_plan(Bsz, S, d, N, Hh), x.device)
    fn = _build.function("selective_scan", "selective_scan_heads_bwd",
                         _HEAD_BWD_ARGS)
    err = fn(dt.data_ptr(), x.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
             Cmat.data_ptr(), _ptr(h0), dy.data_ptr(), _ptr(dh_final),
             ddt.data_ptr(), dx.data_ptr(), dA.data_ptr(), dB.data_ptr(),
             dC.data_ptr(), dh0.data_ptr(), ws["hs"].data_ptr(),
             ws["pB"].data_ptr(), ws["pC"].data_ptr(), ws["pdt"].data_ptr(),
             ws["pA"].data_ptr(), K.DTYPE_CODES[x.dtype], Bsz, S, Hh, P, N,
             K.stream_ptr(x))
    K.check_launch(err, "selective_scan_heads_bwd")
    K.launches["selective_scan_heads_bwd"] += 1
    return ddt, dx, dA, dB, dC, dh0


class _ScanFn(torch.autograd.Function):
    """The scan with its gradient.  Saves only the inputs (under remat
    ``torch.utils.checkpoint`` keeps none of them across layers); the
    backward kernel rebuilds the states itself."""
    fwd = bwd = None

    @classmethod
    def forward(cls, ctx, dt, x, A, Bmat, Cmat, h0):
        ctx.save_for_backward(dt, x, A, Bmat, Cmat, h0)
        return cls.fwd(dt, x, A, Bmat, Cmat, h0)

    @classmethod
    def backward(cls, ctx, dy, dh):
        dt, x, A, Bmat, Cmat, h0 = ctx.saved_tensors
        ddt, dx, dA, dB, dC, dh0 = cls.bwd(
            dt, x, A, Bmat, Cmat, h0, dy.float().contiguous(),
            None if dh is None else dh.float().contiguous())
        return ddt, dx, dA, dB, dC, None if h0 is None else dh0


class SelectiveScanFn(_ScanFn):
    """:func:`selective_scan` with :func:`selective_scan_bwd`."""
    fwd, bwd = staticmethod(_scan), staticmethod(selective_scan_bwd)


class SelectiveScanHeadsFn(_ScanFn):
    """:func:`selective_scan_heads` with :func:`selective_scan_heads_bwd`."""
    fwd = staticmethod(_scan_heads)
    bwd = staticmethod(selective_scan_heads_bwd)
