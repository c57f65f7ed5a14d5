"""Mamba-2's per-head scan on the CPU: the port's wrapper
``selective_scan_heads`` (which takes CPU tensors to the plain version,
launching nothing) held against ``jax.lax.scan`` over
``repro.models.mamba._ssm2_step``, at small H and P and lengths around the
32-step pieces the card's kernel stages; a dt = 0 tail, inside a piece or
on its edge, that must leave the final state bit-equal to the head-only
call's; and the premises of the bar the card holds scans past 512 steps
to (``chip_smoke.py::long_scan_check``): the plain version on |x|, |B|,
|C| and |h0| bounds |h| and the magnitudes each y sums, and TF32-rounded
operands fail the bar.

Tolerance against the JAX oracle: element-wise 1e-5 plus 2^-16 of the
magnitude scale (the plain version on |x|, |B|, |C|, |h0|).  Both are f32
in another order, and each y sums 64 products that cancel, so their
rounding grows with the magnitudes summed, not with |y|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import _ssm2_step
from repro_torch import kernels as K
from repro_torch.kernels.selective_scan.ops import selective_scan_heads
from repro_torch.kernels.selective_scan.ref import selective_scan_heads_ref

from _hyp import given, settings, st

PIECE = 32           # steps the card's kernel stages at a time
N = 64
TOL = 1e-5
LONG_SCAN_RTOL = 2.0 ** -16     # chip_smoke.py's bar past 512 steps


def jax_scan(dt, x, A, Bm, Cm, h0):
    """lax.scan over _ssm2_step, as repro.models.mamba.mamba2_seq runs it."""
    Bsz, S, Hh = dt.shape
    P = x.shape[2] // Hh
    seq = (jnp.moveaxis(jnp.asarray(dt), 1, 0),
           jnp.moveaxis(jnp.asarray(x).reshape(Bsz, S, Hh, P), 1, 0),
           jnp.moveaxis(jnp.asarray(Bm), 1, 0),
           jnp.moveaxis(jnp.asarray(Cm), 1, 0))
    A = jnp.asarray(A)
    h, ys = jax.lax.scan(lambda h, s: _ssm2_step(h, s, A), jnp.asarray(h0),
                         seq)
    return (np.asarray(jnp.moveaxis(ys, 0, 1)).reshape(Bsz, S, Hh * P),
            np.asarray(h))


def inputs(seed, Bsz, S, Hh, P, with_h0=True):
    """dt = 0.1 |z| per head, x, B, C ~ z, A = -|z| per head, h0 ~ z or
    zeros (the smoke's and the card tests' draw), as f32 numpy."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(np.float32)
    h0 = z(Bsz, Hh, P, N) if with_h0 else np.zeros((Bsz, Hh, P, N),
                                                    np.float32)
    return (np.abs(z(Bsz, S, Hh)) * np.float32(0.1), z(Bsz, S, Hh * P),
            -np.abs(z(Hh)), z(Bsz, S, N), z(Bsz, S, N), h0)


def as_torch(ins):
    return [torch.from_numpy(a) for a in ins]


def _matches_jax(ins, with_h0):
    dt, x, A, Bm, Cm, h0 = as_torch(ins)
    before = dict(K.launches)
    y, h = selective_scan_heads(dt, x, A, Bm, Cm, h0 if with_h0 else None)
    assert K.launches == before
    y_ref, h_ref = jax_scan(*ins)
    scale = selective_scan_heads_ref(dt, x.abs(), A, Bm.abs(), Cm.abs(),
                                     h0.abs())
    assert y.dtype == h.dtype == torch.float32
    for got, want, sc in zip((y, h), (y_ref, h_ref), scale):
        assert (np.abs(got.numpy() - want)
                - LONG_SCAN_RTOL * sc.numpy()).max() <= TOL


@pytest.mark.parametrize("Bsz,S,Hh,P,with_h0", [
    (1, 1, 2, 32, True), (2, PIECE - 1, 2, 32, False), (1, PIECE, 3, 32, True),
    (2, PIECE + 1, 1, 64, True), (1, 3 * PIECE + 5, 2, 32, False),
    (3, 2 * PIECE, 1, 32, True), (1, 300, 1, 32, True),
    (1, 4 * PIECE + 1, 1, 64, False), (2, 4 * PIECE, 2, 32, True),
    (1, 7, 4, 32, False), (2, 2 * PIECE + 1, 2, 32, True)])
def test_cpu_route_matches_jax(Bsz, S, Hh, P, with_h0):
    _matches_jax(inputs(S + Bsz + Hh, Bsz, S, Hh, P, with_h0), with_h0)


def _freezes(S, n, seed, Bsz=2, with_h0=True):
    dt, x, A, Bm, Cm, h0 = as_torch(inputs(seed, Bsz, S, 2, 32, with_h0))
    _, h_head = selective_scan_heads(
        dt[:, :n].contiguous(), x[:, :n].contiguous(), A,
        Bm[:, :n].contiguous(), Cm[:, :n].contiguous(), h0)
    dt[:, n:] = 0
    _, h = selective_scan_heads(dt, x, A, Bm, Cm, h0)
    return torch.equal(h, h_head)


@pytest.mark.parametrize("S,n", [(80, 45), (2 * PIECE + 40, PIECE + 30),
                                 (2 * PIECE + 40, 2 * PIECE),
                                 (3 * PIECE, PIECE), (PIECE + 2, 1)])
def test_zero_dt_tail_keeps_state_bits(S, n):
    """Tails inside a piece, on a piece's edge (twice), and after a
    one-step head."""
    assert _freezes(S, n, S + n)


@settings(max_examples=12, deadline=None, derandomize=True)
@given(S=st.integers(2, 3 * PIECE + 3), Bsz=st.integers(1, 3),
       with_h0=st.booleans(), frac=st.floats(0.0, 1.0),
       seed=st.integers(0, 10_000))
def test_zero_dt_tail_keeps_state_bits_drawn(S, Bsz, with_h0, frac, seed):
    n = max(1, min(S - 1, int(frac * S)))
    assert _freezes(S, n, seed, Bsz, with_h0)


@settings(max_examples=6, deadline=None, derandomize=True)
@given(S=st.integers(1, 3 * PIECE + 9), Bsz=st.integers(1, 2),
       with_h0=st.booleans(), seed=st.integers(0, 10_000))
def test_cpu_route_matches_jax_drawn(S, Bsz, with_h0, seed):
    _matches_jax(inputs(seed, Bsz, S, 1, 32, with_h0), with_h0)


def _states(dt, x, A, Bm, h0):
    """Every state of the recurrence, [S, B, H, P, N]."""
    Bsz, S, Hh = dt.shape
    xs = x.reshape(Bsz, S, Hh, -1)
    h, hs = h0, []
    for t in range(S):
        h = torch.exp(dt[:, t] * A)[..., None, None] * h + \
            (dt[:, t, :, None] * xs[:, t])[..., None] * Bm[:, t, None, None]
        hs.append(h)
    return torch.stack(hs)


@pytest.mark.parametrize("S,with_h0", [(40, True), (PIECE * 3, False)])
def test_magnitude_scale_bounds_what_y_sums(S, with_h0):
    """The plain version on |x|, |B|, |C|, |h0| is at least |h_t| and at
    least sum_n |h_t,n C_t,n| for each y_t, element-wise."""
    dt, x, A, Bm, Cm, h0 = as_torch(inputs(S, 2, S, 2, 32, with_h0))
    ys, hs = selective_scan_heads_ref(dt, x.abs(), A, Bm.abs(), Cm.abs(),
                                      h0.abs())
    states = _states(dt, x, A, Bm, h0)                 # [S, B, H, P, N]
    sums = (states * Cm.permute(1, 0, 2)[:, :, None, None]).abs().sum(-1)
    slack = 1e-5 * (1 + ys)                            # rounding of both
    assert (ys - sums.permute(1, 0, 2, 3).reshape(ys.shape)
            >= -slack).all()
    assert (hs - states[-1].abs() >= -1e-5 * (1 + hs)).all()


def test_tf32_operands_fail_the_long_scan_bar():
    """At 600 steps of a small width, the plain version on x, B and C cut
    to TF32's 10-bit mantissa lies past 1e-4 + LONG_SCAN_RTOL of the
    magnitude scale from the f32 one, so the bar would catch a kernel that
    multiplied in TF32."""
    dt, x, A, Bm, Cm, h0 = as_torch(inputs(7, 2, 600, 2, 32))
    want, _ = selective_scan_heads_ref(dt, x, A, Bm, Cm, h0)
    scale, _ = selective_scan_heads_ref(dt, x.abs(), A, Bm.abs(), Cm.abs(),
                                        h0.abs())
    tf32 = lambda t: (t.view(torch.int32) & -(1 << 13)).view(torch.float32)
    ctrl, _ = selective_scan_heads_ref(dt, tf32(x), A, tf32(Bm), tf32(Cm), h0)
    assert ((ctrl - want).abs() - LONG_SCAN_RTOL * scale).max() > 1e-4
