"""Flash attention's gradient in the port, on the CPU (the plain versions):
``flash_attention_bwd_ref``'s explicit formulas against autograd through
``flash_attention_ref`` and against ``jax.grad`` of the JAX package's jnp
oracle (``repro.kernels.flash_attention.ref``) and of its
``blockwise_attention``, which its ``forward`` differentiates;
``flash_attention_fwd_ref``'s log-sum-exp; and the autograd Function the
wrapper takes when grad is on.  The Pallas kernel has no backward, so the
jnp oracles are the JAX side here.

Tolerance: 1e-5 absolute in f32 (the same arithmetic, summed in another
order) on inputs of unit scale.  ``blockwise_attention`` scales q before
the product (the port, as the TPU kernel, after it), an f32 ulp apart:
held to 1e-5 as well.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro.models import layers as JL
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_fwd_ref, flash_attention_ref)
from repro_torch.models import layers as TL

ATOL = 1e-5

# (tag, G, D, Sq, Sk, causal, window, kv_offset)
CASES = [("causal-g1-d64", 1, 64, 24, 24, True, 0, 0),
         ("causal-g4-d128", 4, 128, 24, 24, True, 0, 0),
         ("full-g1-d128", 1, 128, 17, 29, False, 0, 0),
         ("full-g4-d64", 4, 64, 9, 33, False, 0, 0),
         ("window-g1-d64", 1, 64, 31, 31, True, 7, 0),
         ("window-g4-d128", 4, 128, 20, 20, True, 5, 0),
         ("ragged-offset-g4-d64", 4, 64, 11, 27, True, 0, 16),
         ("ragged-window-offset-g1-d128", 1, 128, 13, 30, True, 9, 17)]


def _inputs(seed, B, H, Kh, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Kh, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Kh, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, do


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bwd_ref_equals_autograd_and_jax_grad(case):
    _, G, D, Sq, Sk, causal, window, off = case
    Kh = 2
    q, k, v, do = _inputs(0, 2, Kh * G, Kh, Sq, Sk, D)
    kw = dict(causal=causal, window=window, kv_offset=off)
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    flash_attention_ref(tq, tk, tv, **kw).backward(torch.from_numpy(do))
    out, lse = flash_attention_fwd_ref(*map(torch.from_numpy, (q, k, v)),
                                       **kw)
    got = flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v)), out,
                                  lse, torch.from_numpy(do), **kw)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_jax = vjp(jnp.asarray(do))
    for g, auto, jx in zip(got, (tq.grad, tk.grad, tv.grad), want_jax):
        assert g.shape == auto.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), auto.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(jx), atol=ATOL,
                                   rtol=0)


def test_fwd_ref_lse_and_rows_without_keys():
    """lse is the log-sum-exp of the scaled, masked scores; a row that sees
    no key (window 2 at an offset past every key) gets lse = +inf, output
    0 and zero gradients."""
    B, H, Kh, Sq, Sk, D = 1, 2, 1, 6, 5, 64
    q, k, v, do = _inputs(1, B, H, Kh, Sq, Sk, D)
    q, k, v, do = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=True, window=2, kv_offset=3)   # rows 3.. see no key
    out, lse = flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, **kw),
                               atol=ATOL, rtol=0)
    s = torch.einsum("bhqd,bkd->bhqk", q, k[:, 0]) / math.sqrt(D)
    qpos = 3 + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    vis = (kpos <= qpos) & (kpos > qpos - 2)
    want = torch.logsumexp(s.masked_fill(~vis, float("-inf")), dim=-1)
    seen = vis.any(-1)
    torch.testing.assert_close(lse[..., seen], want[..., seen], atol=ATOL,
                               rtol=0)
    assert torch.isposinf(lse[..., ~seen]).all() and (~seen).any()
    assert (out[:, :, ~seen] == 0).all()
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    assert (dq[:, :, ~seen] == 0).all()
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("case", CASES[:2] + CASES[4:5] + CASES[6:7],
                         ids=[c[0] for c in CASES[:2] + CASES[4:5]
                              + CASES[6:7]])
def test_wrapper_function_gradients_on_cpu(case):
    """flash_attention with grad on takes FlashAttentionFn, whose backward
    is flash_attention_bwd (the plain version on CPU tensors); the same
    gradients as autograd through the plain forward, and no kernel
    launch counted."""
    _, G, D, Sq, Sk, causal, window, off = case
    q, k, v, do = _inputs(2, 2, 2 * G, 2, Sq, Sk, D)
    kw = dict(causal=causal, window=window, kv_offset=off)
    before = dict(K.launches)
    a = [_leaf(x) for x in (q, k, v)]
    out = tfa.flash_attention(*a, **kw)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.backward(torch.from_numpy(do))
    b = [_leaf(x) for x in (q, k, v)]
    flash_attention_ref(*b, **kw).backward(torch.from_numpy(do))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=ATOL,
                                   rtol=0)
    assert K.launches == before


def test_wrapper_without_grad_is_unchanged():
    """No input requires grad, or grad is off: the plain forward, no
    autograd graph (serving's path)."""
    q, k, v, _ = _inputs(3, 1, 4, 2, 9, 9, 64)
    q, k, v = map(torch.from_numpy, (q, k, v))
    out = tfa.flash_attention(q, k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, flash_attention_ref(q, k, v))
    with torch.no_grad():
        out = tfa.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None


@pytest.mark.parametrize("causal,window,G", [(True, 0, 1), (True, 6, 2),
                                            (False, 0, 4)])
def test_blockwise_attention_grad_matches_jax(causal, window, G):
    """The port's blockwise_attention ([B, S, H, D] layout, the model's)
    against jax.grad of the JAX package's blockwise_attention (the
    attention its training forward differentiates), on a loss sum(o * w)."""
    B, S, Kh, D = 2, 20, 2, 64
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, S, Kh * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Kh, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Kh, D)).astype(np.float32)
    w = rng.standard_normal((B, S, Kh * G, D)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    want = jax.grad(lambda a, b, c: jnp.sum(
        JL.blockwise_attention(a, b, c, q_chunk=8, **kw) * w),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    a = [_leaf(x) for x in (q, k, v)]
    (TL.blockwise_attention(*a, **kw) * torch.from_numpy(w)).sum().backward()
    for x, y in zip(a, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(y), atol=ATOL,
                                   rtol=0)


# The bf16 backward's host-side copies (``ops.tile_kind``, ``query_range``,
# ``key_tiles``): exact integer logic, held to the mask that
# flash_attention_ref applies.
TILES = ((64, 64), (64, 128), (128, 64), (128, 128))


def _jax_mask(Sq, Sk, causal, window, kv_offset):
    """[Sq, Sk] bool: the pairs the JAX oracle's flash_attention_ref lets
    through, read from its output: q = 0 gives every visible key the same
    weight, and v = one-hot key rows make out[i, j] > 0 exactly where row
    i sees key j."""
    q = jnp.zeros((1, 1, Sq, Sk), jnp.float32)
    k = jnp.zeros((1, 1, Sk, Sk), jnp.float32)
    v = jnp.eye(Sk, dtype=jnp.float32)[None, None]
    out = jax_flash_ref(q, k, v, causal=causal, window=window,
                        kv_offset=kv_offset)
    return torch.from_numpy(np.asarray(out[0, 0]) > 0)


def _tile_kinds_hold(Sq, Sk, causal, window, kv_offset, nq, nk, mask):
    """Every (query tile, key tile) of nq x nk over a grid that runs one
    tile past each edge: "full" has every pair inside Sq x Sk and visible,
    "empty" none visible, "edge" the rest."""
    for q0 in range(0, Sq + nq, nq):
        for k0 in range(0, Sk + nk, nk):
            kind = tfa.tile_kind(q0, nq, k0, nk, Sq, Sk, causal, window,
                                 kv_offset)
            sub = mask[q0:q0 + nq, k0:k0 + nk]
            inside = q0 + nq <= Sq and k0 + nk <= Sk
            want = ("empty" if not sub.any() else
                    "full" if inside and sub.all() else "edge")
            assert kind == want, (q0, k0, nq, nk, kind, want)


def _visits_cover(Sq, Sk, causal, window, kv_offset, mask):
    """Every visible pair lies in a (query tile, warpgroup's keys) a dK/dV
    block walks and a (warpgroup's rows, key tile) a dQ block walks, and
    neither kernel calls such a tile empty."""
    blk, t = tfa.BWD_BLOCK, tfa.BWD_TILE
    seen_kv = torch.zeros_like(mask)
    for k0 in range(0, Sk, blk):
        lo, hi = tfa.query_range(k0, blk, Sq, causal, window, kv_offset)
        if hi <= lo:
            continue
        for q0 in range(lo // t * t, -(-hi // t) * t, t):
            for kw in (k0, k0 + t):
                if tfa.tile_kind(q0, t, kw, t, Sq, Sk, causal, window,
                                 kv_offset) != "empty":
                    seen_kv[q0:q0 + t, kw:kw + t] = True
    seen_q = torch.zeros_like(mask)
    for q0 in range(0, Sq, blk):
        begin, end = tfa.key_tiles(q0, min(blk, Sq - q0), Sk, t, causal,
                                   window, kv_offset)
        for kt in range(begin, end):
            for qw in (q0, q0 + t):
                if tfa.tile_kind(qw, t, kt * t, t, Sq, Sk, causal, window,
                                 kv_offset) != "empty":
                    seen_q[qw:qw + t, kt * t:kt * t + t] = True
    assert not (mask & ~seen_kv).any() and not (mask & ~seen_q).any()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bwd_tile_kinds_and_visits_match_the_mask(case):
    """The backward's tile classification and the tiles its blocks walk,
    against the mask of the JAX oracle (which the port's plain version
    applies too), at every tile size of 64 and 128, for each shape of
    CASES."""
    _, _, _, Sq, Sk, causal, window, off = case
    mask = _jax_mask(Sq, Sk, causal, window, off)
    from repro_torch.kernels.flash_attention.ref import _visible
    assert torch.equal(mask, _visible(Sq, Sk, causal, window, off, "cpu"))
    for nq, nk in TILES:
        _tile_kinds_hold(Sq, Sk, causal, window, off, nq, nk, mask)
    _visits_cover(Sq, Sk, causal, window, off, mask)


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 300), Sk=st.integers(1, 300), causal=st.booleans(),
       window=st.sampled_from([0, 1, 5, 64, 100, 200]),
       kv_offset=st.integers(-80, 200), tiles=st.sampled_from(TILES))
def test_bwd_tile_kinds_property(Sq, Sk, causal, window, kv_offset, tiles):
    """Drawn shapes, masks and tile sizes: the classification against the
    brute-force mask of the plain version (flash_attention_ref's), and
    every visible pair in a tile both kernels walk."""
    from repro_torch.kernels.flash_attention.ref import _visible
    mask = _visible(Sq, Sk, causal, window, kv_offset, "cpu")
    _tile_kinds_hold(Sq, Sk, causal, window, kv_offset, *tiles, mask)
    _visits_cover(Sq, Sk, causal, window, kv_offset, mask)


@pytest.mark.parametrize("Sq,Sk,causal,window,off", [
    (320, 320, True, 0, 0), (300, 330, True, 100, 30), (200, 130, False, 0, 0),
    (77, 200, True, 0, 123), (70, 100, True, 8, -20)])
def test_bwd_tile_kinds_at_larger_shapes(Sq, Sk, causal, window, off):
    """Shapes of several tiles each (the card tests' ragged and offset
    ones among them): the classification and the walks hold against the
    JAX oracle's mask, and a causal square grid meets all three kinds."""
    mask = _jax_mask(Sq, Sk, causal, window, off)
    kinds = set()
    for nq, nk in TILES:
        _tile_kinds_hold(Sq, Sk, causal, window, off, nq, nk, mask)
        kinds |= {tfa.tile_kind(q0, nq, k0, nk, Sq, Sk, causal, window, off)
                  for q0 in range(0, Sq, nq) for k0 in range(0, Sk, nk)}
    _visits_cover(Sq, Sk, causal, window, off, mask)
    if (Sq, causal, window) == (320, True, 0):
        assert kinds == {"full", "edge", "empty"}
