"""The selective scan's plain backwards (``selective_scan_bwd_ref``,
``selective_scan_heads_bwd_ref``: the reverse recurrence, the CPU path of
the backward kernels) against autograd through the plain forwards and
against ``jax.grad`` through the reference's ``lax.scan`` over
``repro.models.mamba._ssm1_step`` / ``_ssm2_step``; and the wrappers and
autograd Functions on CPU tensors.

Tolerance: f32, each gradient within 1e-5 of that output's largest
magnitude (the same sums in another order: autograd's and XLA's).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro_torch import kernels as K
from repro_torch.kernels.selective_scan import ops
from repro_torch.kernels.selective_scan.ref import (
    selective_scan_bwd_ref, selective_scan_heads_bwd_ref,
    selective_scan_heads_ref, selective_scan_ref)

from _hyp import given, settings, st

REL = 1e-5
NAMES = ("ddt", "dx", "dA", "dB", "dC", "dh0")


def _inputs(seed, B, S, d, N, heads=None, zero_dt=()):
    """dt, x, A, B, C, h0, dy, dh_final as numpy f32 (Mamba-1, or the
    per-head mode with ``heads`` H: dt [B, S, H], A [H]); dt = 0 at the
    positions in ``zero_dt``."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = d if heads is None else heads
    dt = (np.abs(f(B, S, w)) * 0.3).astype(np.float32)
    for t in zero_dt:
        dt[:, t] = 0.0
    A = -np.abs(f(d, N) if heads is None else f(heads)) * 2.0
    h_shape = (B, d, N) if heads is None else (B, heads, d // heads, N)
    return dict(dt=dt, x=f(B, S, d), A=A.astype(np.float32), B=f(B, S, N),
                C=f(B, S, N), h0=f(*h_shape), dy=f(B, S, d),
                dhf=f(*h_shape))


def _torch(a, *names):
    return [torch.from_numpy(a[n]) for n in names]


def _close(got, want, names=NAMES):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= REL * max(np.abs(w).max(), 1e-30), (name, err)


def _jax_grads(a, heads, with_h0, with_dhf):
    """jax.vjp of the reference's lax.scan over _ssm1_step / _ssm2_step:
    (ddt, dx, dA, dB, dC, dh0)."""
    B, S, d = a["x"].shape
    step = jmamba._ssm1_step if heads is None else jmamba._ssm2_step

    def run(dt, x, A, Bm, Cm, h0):
        if heads is not None:
            x = x.reshape(B, S, heads, d // heads)
        seq = tuple(jnp.moveaxis(v, 1, 0) for v in (dt, x, Bm, Cm))
        h, ys = jax.lax.scan(lambda h, s: step(h, s, A), h0, seq)
        return jnp.moveaxis(ys, 0, 1).reshape(B, S, d), h
    h0 = a["h0"] if with_h0 else np.zeros_like(a["h0"])
    dhf = a["dhf"] if with_dhf else np.zeros_like(a["dhf"])
    _, vjp = jax.vjp(run, *(jnp.asarray(a[n]) for n in
                            ("dt", "x", "A", "B", "C")), jnp.asarray(h0))
    return [np.asarray(g) for g in vjp((jnp.asarray(a["dy"]),
                                        jnp.asarray(dhf)))]


def _plain_bwd(a, heads, with_h0, with_dhf):
    fn = selective_scan_bwd_ref if heads is None \
        else selective_scan_heads_bwd_ref
    dt, x, A, Bm, Cm, dy = _torch(a, "dt", "x", "A", "B", "C", "dy")
    h0 = torch.from_numpy(a["h0"]) if with_h0 else None
    dhf = torch.from_numpy(a["dhf"]) if with_dhf else None
    return fn(dt, x, A, Bm, Cm, h0, dy, dhf)


CASES = [(None, False, False), (None, True, False), (None, True, True),
         (None, False, True), (4, False, False), (4, True, True),
         (2, True, False)]
CASE_IDS = ["m1", "m1-h0", "m1-h0-dhf", "m1-dhf", "heads", "heads-h0-dhf",
            "heads-h0"]


@pytest.mark.parametrize("heads,with_h0,with_dhf", CASES, ids=CASE_IDS)
def test_plain_bwd_matches_jax_grad(heads, with_h0, with_dhf):
    """Both modes, h0 and dh_final given or not, dt = 0 at two positions
    (the prefill mask's padded steps)."""
    N = 4 if heads is None else 8
    a = _inputs(1, 2, 11, 8, N, heads, zero_dt=(3, 10))
    got = _plain_bwd(a, heads, with_h0, with_dhf)
    want = _jax_grads(a, heads, with_h0, with_dhf)
    _close(got, want)


@pytest.mark.parametrize("heads,with_h0,with_dhf", CASES, ids=CASE_IDS)
def test_plain_bwd_matches_autograd_of_plain_forward(heads, with_h0,
                                                     with_dhf):
    N = 4 if heads is None else 8
    a = _inputs(2, 3, 9, 8, N, heads, zero_dt=(0,))
    fwd = selective_scan_ref if heads is None else selective_scan_heads_ref
    ins = [t.requires_grad_() for t in _torch(a, "dt", "x", "A", "B", "C",
                                              "h0")]
    y, h = fwd(*ins[:5], ins[5] if with_h0 else None)
    loss = (y * torch.from_numpy(a["dy"])).sum()
    if with_dhf:
        loss = loss + (h * torch.from_numpy(a["dhf"])).sum()
    want = torch.autograd.grad(loss, ins, allow_unused=True,
                               materialize_grads=True)
    got = _plain_bwd(a, heads, with_h0, with_dhf)
    if not with_h0:          # no h0 to differentiate: drop dh0
        got, want = got[:5], want[:5]
    _close(got, [w.numpy() for w in want])


@settings(max_examples=12, deadline=None)
@given(heads=st.sampled_from([None, 1, 2, 4]), B=st.integers(1, 3),
       S=st.integers(1, 13), N=st.sampled_from([4, 8, 16]),
       seed=st.integers(0, 2 ** 16))
def test_plain_bwd_matches_jax_grad_drawn(heads, B, S, N, seed):
    d = 8 if heads is None else 4 * heads
    a = _inputs(seed, B, S, d, N, heads, zero_dt=range(0, S, 5))
    _close(_plain_bwd(a, heads, True, True), _jax_grads(a, heads, True, True))


def test_plain_bwd_keeps_finite_where_dA_underflows():
    """dt A far below the exponential's range: dA_t is exactly 0, and an
    inverted recurrence would divide by it; the states rebuilt forward
    keep every gradient finite, and still equal jax.grad's."""
    a = _inputs(3, 1, 6, 8, 4)
    a["dt"][:] = 40.0
    a["A"][:] = -16.0
    got = _plain_bwd(a, None, True, True)
    assert all(torch.isfinite(g).all() for g in got)
    _close(got, _jax_grads(a, None, True, True))


@pytest.mark.parametrize("heads", [None, 4], ids=["m1", "heads"])
def test_functions_route_cpu_tensors_to_plain_bwd_and_count_no_launch(heads):
    """selective_scan / selective_scan_heads with grad on run the autograd
    Functions, whose gradients (of y and h_final) equal the plain backward
    cast to the inputs' types; CPU tensors never count a launch; without
    grad the plain forward runs and builds no graph."""
    N = 16 if heads is None else 64
    a = _inputs(4, 2, 7, 32 if heads is None else 128, N, heads)
    fn = ops.selective_scan if heads is None else ops.selective_scan_heads
    bwd = ops.selective_scan_bwd if heads is None \
        else ops.selective_scan_heads_bwd
    K.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        ins = [t.to(dtype) for t in _torch(a, "dt", "x")] + \
            _torch(a, "A") + [t.to(dtype) for t in _torch(a, "B", "C")] + \
            _torch(a, "h0")
        ins = [t.requires_grad_() for t in ins]
        y, h = fn(*ins)
        assert y.grad_fn is not None and y.dtype == torch.float32
        dy, dhf = _torch(a, "dy", "dhf")
        got = torch.autograd.grad((y * dy).sum() + (h * dhf).sum(), ins)
        want = bwd(*(t.detach() for t in ins), dy, dhf)
        for g, w, t in zip(got, want, ins):
            assert g.dtype == t.dtype
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        with torch.no_grad():
            y2, h2 = fn(*ins)
        assert y2.grad_fn is None
        torch.testing.assert_close(y2, y.detach(), rtol=0, atol=0)
    assert K.launches["selective_scan_bwd"] == 0
    assert K.launches["selective_scan_heads_bwd"] == 0
    assert K.launches["selective_scan"] == 0
    assert K.launches["selective_scan_heads"] == 0


def test_function_without_h0_returns_no_dh0():
    a = _inputs(5, 1, 5, 32, 4)
    dt, x, A, Bm, Cm = [t.requires_grad_() for t in
                        _torch(a, "dt", "x", "A", "B", "C")]
    y, _ = ops.selective_scan(dt, x, A, Bm, Cm)
    got = torch.autograd.grad(y.sum(), (dt, x, A, Bm, Cm))
    want = selective_scan_bwd_ref(dt.detach(), x.detach(), A.detach(),
                                  Bm.detach(), Cm.detach(), None,
                                  torch.ones_like(y))
    _close(got, [w.numpy() for w in want[:5]], NAMES[:5])


# ---------------------------------------------------------------------------
# what the backward kernels lean on
# ---------------------------------------------------------------------------
def _factored_heads_ddt_dA(dt, x, A, Bm, Cm, h0, dy, dhf):
    """The per-head mode's ddt and dA as its kernel computes them: through
    s_t = sum_{c,n} g_t h_{t-1} (A and dA_t are one a head), ddt_t = A dA_t
    s_t + sum_c x_c sum_n g_t B_n and dA = sum_t dt_t dA_t s_t; plain f32
    PyTorch, the states rebuilt forward.  Also returns each sum's condition
    scale, the sum of its elementary terms' absolute values: |A dA_t|
    sum_{c,n} |g_t h_{t-1}| + sum_{c,n} |x_c g_t B_n| for ddt, the sum
    over (b, t) of |dt_t dA_t| sum_{c,n} |g_t h_{t-1}| for dA."""
    Bsz, S, H = dt.shape
    P, N = x.shape[2] // H, Bm.shape[2]
    x, dy = x.reshape(Bsz, S, H, P), dy.reshape(Bsz, S, H, P)
    dA_t = torch.exp(dt * A)                                   # [B, S, H]
    h = torch.zeros((Bsz, H, P, N)) if h0 is None else h0.clone()
    hs = [h]
    for t in range(S):
        h = dA_t[:, t, :, None, None] * h + \
            (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None]
        hs.append(h)
    g = torch.zeros_like(h) if dhf is None else dhf.clone()
    ddt, dA = torch.empty_like(dt), torch.zeros_like(A)
    ddt_scale, dA_scale = torch.empty_like(dt), torch.zeros_like(A)
    for t in range(S - 1, -1, -1):
        g = g + dy[:, t, ..., None] * Cm[:, t, None, None]
        s = (g * hs[t]).sum((2, 3))                            # [B, H]
        gB = (g * Bm[:, t, None, None]).sum(-1)                # [B, H, P]
        ddt[:, t] = A * dA_t[:, t] * s + (x[:, t] * gB).sum(-1)
        s_abs = (g * hs[t]).abs().sum((2, 3))
        ddt_scale[:, t] = (A * dA_t[:, t]).abs() * s_abs + \
            (x[:, t, ..., None] * g * Bm[:, t, None, None]).abs().sum((2, 3))
        dA += (dt[:, t] * dA_t[:, t] * s).sum(0)
        dA_scale += ((dt[:, t] * dA_t[:, t]).abs() * s_abs).sum(0)
        g = g * dA_t[:, t, :, None, None]
    return (ddt, dA), (ddt_scale, dA_scale)


def _close_to_scale(got, want, scales, names):
    """Each element of got within REL of want, relative to its sum's
    condition scale: the two are the same sums in another order, and a
    sum whose terms cancel keeps only REL of its terms' magnitudes."""
    for name, g, w, sc in zip(names, got, want, scales):
        g, w = g.detach().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        err = np.abs(g - w)
        bar = REL * np.maximum(sc.numpy(), 1e-30)
        assert (err <= bar).all(), (name, err.max(), (err / bar).max())


def _factored_close(a, heads, with_h0, with_dhf):
    dt, x, A, Bm, Cm, dy = _torch(a, "dt", "x", "A", "B", "C", "dy")
    h0 = torch.from_numpy(a["h0"]) if with_h0 else None
    dhf = torch.from_numpy(a["dhf"]) if with_dhf else None
    got, scales = _factored_heads_ddt_dA(dt, x, A, Bm, Cm, h0, dy, dhf)
    plain = selective_scan_heads_bwd_ref(dt, x, A, Bm, Cm, h0, dy, dhf)
    _close_to_scale(got, (plain[0].numpy(), plain[2].numpy()), scales,
                    ("ddt", "dA"))
    want = _jax_grads(a, heads, with_h0, with_dhf)
    _close_to_scale(got, (want[0], want[2]), scales, ("ddt", "dA"))


@pytest.mark.parametrize("heads,with_h0,with_dhf",
                         [c for c in CASES if c[0] is not None],
                         ids=[i for c, i in zip(CASES, CASE_IDS)
                              if c[0] is not None])
def test_factored_heads_ddt_dA_matches_plain_and_jax(heads, with_h0,
                                                     with_dhf):
    """The per-head kernel's algebra: ddt and dA through s_t equal the
    plain backward's per-element sums and jax.grad's."""
    a = _inputs(6, 2, 11, 8, 8, heads, zero_dt=(3, 10))
    _factored_close(a, heads, with_h0, with_dhf)


@settings(max_examples=10, deadline=None)
@given(heads=st.sampled_from([1, 2, 4]), B=st.integers(1, 3),
       S=st.integers(1, 13), P=st.sampled_from([2, 4, 8]),
       seed=st.integers(0, 2 ** 16))
def test_factored_heads_ddt_dA_matches_drawn(heads, B, S, P, seed):
    _factored_drawn(heads, B, S, P, seed)


@pytest.mark.parametrize("heads,B,S,P,seed", [(1, 2, 10, 2, 42067)])
def test_factored_heads_ddt_dA_matches_pinned_draw(heads, B, S, P, seed):
    """A draw whose dA sums cancel: its three f32 computations differ by
    1e-4 of the result, within REL of the terms' magnitudes."""
    _factored_drawn(heads, B, S, P, seed)


def _factored_drawn(heads, B, S, P, seed):
    a = _inputs(seed, B, S, heads * P, 8, heads, zero_dt=range(0, S, 5))
    _factored_close(a, heads, True, True)


def _scratch_bytes(plan):
    """What a plan's f32 scratch moves: each byte written once, read once."""
    return 8 * sum(math.prod(plan[k]) for k in ("hs", "pA", "pdt")
                   if k in plan) + 16 * math.prod(plan["pB"])


def _old_scratch_bytes(B, S, d, N, heads=None):
    """The scratch of the first backward kernels (states every 8 steps,
    32-channel blocks): hs, pB, pC, pA and the per-head pdt, f32, written
    and read once."""
    blocks = d // 32
    elems = B * -(-S // 8) * d * N + 2 * blocks * B * S * N
    elems += B * d * N if heads is None else \
        heads * B * (blocks // heads) + B * S * heads * (blocks // heads)
    return 2 * 4 * elems


@pytest.mark.parametrize("B,S,d,N,heads", [
    (2, 2048, 8192, 16, None), (1, 512, 8192, 16, None),
    (2, 83, 96, 4, None), (2, 1, 96, 8, None), (2, 37, 64, 16, None),
    (1, 2048, 7168, 64, 112), (2, 9, 64, 64, 2), (2, 64, 384, 64, 4),
    (1, 203, 7168, 64, 112), (2, 40, 192, 64, 3)],
    ids=["falcon-train", "falcon-512", "d96-N4", "S1", "one-block",
         "zamba2-train", "P32", "P96", "zamba2-ragged", "P64-H3"])
def test_bwd_plan_matches_its_formula(B, S, d, N, heads):
    """The wrapper's plan: 64-channel blocks over each row (Mamba-1) or
    head, the last one masking its tail (d = 96, P = 32 or 96 leave 32
    live), states saved every 8 (Mamba-1) or 16 (per-head) steps, the
    scratch shapes the kernels index, and scratch bytes no more than the
    first kernels' (states every 8 steps, 32-channel blocks)."""
    plan = ops.bwd_plan(B, S, d, N, heads)
    width = d if heads is None else d // heads
    per = -(-width // 64)
    assert plan["grid"] == (per * (1 if heads is None else heads), B)
    chunk = 8 if heads is None else 16
    assert plan["saved"] == -(-S // chunk)
    assert plan["hs"] == (B, plan["saved"], d, N)
    assert plan["pB"] == (plan["grid"][0], B, S, N)
    if heads is None:
        assert plan["pA"] == (B, d, N) and "pdt" not in plan
    else:
        assert plan["pA"] == (heads, B, per)
        assert plan["pdt"] == (B, S, heads, per)
    assert _scratch_bytes(plan) <= _old_scratch_bytes(B, S, d, N, heads)


def test_bwd_plan_reckons_the_timed_shapes():
    """The scratch the source comment reckons: 0.67 GB at falcon-mamba's
    training shape, 0.71 GB at zamba2's widths (0.81 and 1.41 GB before)."""
    falcon = ops.bwd_plan(2, 2048, 8192, 16)
    zamba = ops.bwd_plan(1, 2048, 7168, 64, 112)
    assert falcon["grid"] == (128, 2) and zamba["grid"] == (112, 1)
    assert round(_scratch_bytes(falcon) / 1e9, 2) == 0.67
    assert round(_scratch_bytes(zamba) / 1e9, 2) == 0.71
    assert round(_old_scratch_bytes(2, 2048, 8192, 16) / 1e9, 2) == 0.81
    assert round(_old_scratch_bytes(1, 2048, 7168, 64, 112) / 1e9, 2) == 1.41


def test_aligned_copies_only_an_unaligned_start():
    t = torch.arange(40, dtype=torch.bfloat16)
    assert ops._aligned(t) is t
    view = t[1:33]
    assert view.data_ptr() % 16 != 0
    got = ops._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
