"""The bf16 flash forward's wgmma body (``flash_fwd_wgmma_kernel`` in
``csrc/flash_attention.cu``) on the CPU, where it cannot run: which calls
``plan`` and the wrapper send to it, the host copy of the key tiles its
128-row blocks walk (``ops.wgmma_walk``) against the JAX oracle's mask, and
a host emulation of its arithmetic against the JAX oracle.

The emulation repeats what each 64-row warpgroup of the kernel computes:
the 64-key tiles its block walks, f32 scores scaled after the product, an
online softmax in log2 units (a masked key at the finite NEG_INF for the
max, exactly 0 after it; the mask only on "edge" tiles, "empty" tiles
skipped), P rounded to bf16 before P V with l summing the rounded P, and
the output rounded once to bf16.  Held against
the JAX oracle (``repro.kernels.flash_attention.ref.flash_attention_ref``,
f32) on the same bf16-valued inputs at the card's bf16 bars, as
``chip_smoke.py`` holds the kernel: output 2e-2 absolute (one bf16
rounding of outputs up to ~4 in the first rows, which see few keys, is
1.6e-2; P's rounding, 2^-9 relative, weighs numerator and denominator
alike), lse 4e-3 (l sums P rounded to bf16, so lse moves by under 2e-3),
the lse against the port's plain version (itself held to JAX in
test_torch_flash_bwd.py).  The walk is exact integer logic.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import (
    BLOCK_K, NEG_INF, _visible, flash_attention_fwd_ref)

OUT_TOL, LSE_TOL = 2e-2, 4e-3
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
WIDE = list(tfa.WGMMA_DIMS)
IDS = [f"{a}x{b}" for a, b in WIDE]


# ---------------------------------------------------------------------------
# plan and the wrapper's dispatch
# ---------------------------------------------------------------------------
# the smoke's training shapes (B, H, Kh, S, D, Dv): zamba2-7b, stablelm-12b,
# gemma3-4b, DeepSeek-V2's MLA
TRAIN = [(2, 32, 32, 2048, 112, 112), (2, 32, 8, 2048, 160, 160),
         (2, 8, 4, 2048, 256, 256), (2, 128, 128, 2048, 192, 128)]


@pytest.mark.parametrize("B,H,Kh,S,D,Dv", TRAIN,
                         ids=["d112", "d160", "d256", "mla"])
@pytest.mark.parametrize("n_sms,per_sm", [(132, 1), (132, 2), (132, 3)])
def test_plan_sends_training_shapes_to_the_wgmma_body(B, H, Kh, S, D, Dv,
                                                      n_sms, per_sm):
    assert tfa.plan(B, H, S, S, n_sms, per_sm, D, Dv) == (tfa.WGMMA_ROWS, 1)


# (B, H, Sq, Sk): GQA's query heads count, not its KV heads; a ragged
# chunk after cached keys (Sq < Sk); a query side past the keys
@pytest.mark.parametrize("B,H,Sq,Sk", [(2, 64, 200, 200), (1, 128, 77, 200),
                                       (2, 64, 321, 100), (1, 256, 17, 4096)])
@pytest.mark.parametrize("D,Dv", WIDE, ids=IDS)
def test_plan_takes_gqa_ragged_and_offset_calls_that_need_no_split(
        B, H, Sq, Sk, D, Dv):
    assert tfa.plan(B, H, Sq, Sk, 132, 2, D, Dv) == (tfa.WGMMA_ROWS, 1)


@pytest.mark.parametrize("D,Dv", WIDE, ids=IDS)
def test_plan_keeps_the_tile_for_decode_rows_and_split_grids(D, Dv):
    # decode rows: the one-warp tile, split
    rows, n_split = tfa.plan(8, 8, 1, 1500, 132, 2, D, Dv)
    assert rows == 16 and n_split > 1
    assert tfa.plan(4, 32, 16, 64, 132, 2, D, Dv)[0] == 16
    # the smoke's 64-row chunk over 1,500 keys, and a short grid of 200
    # rows: split 64-row tiles
    for B, H, Sq, Sk in ((4, 8, 64, 1500), (1, 4, 200, 200)):
        rows, n_split = tfa.plan(B, H, Sq, Sk, 132, 2, D, Dv)
        assert rows == 64 and n_split > 1


@pytest.mark.parametrize("D", [64, 128])
def test_plan_keeps_the_tile_at_d64_and_d128(D):
    for B, H, S in ((2, 32, 2048), (2, 32, 2624), (4, 12, 1500)):
        assert tfa.plan(B, H, S, S, 132, 2, D, D) == (64, 1)


def _dispatch(monkeypatch, q, k, v):
    """(rows, n_split) that ``ops._forward`` hands the C entry for CPU
    tensors standing in for the card's (132 SMs, 2 tiles an SM), and the
    launch counters it moved."""
    seen = []

    def entry(*args):
        seen.append((args[16], args[17]))
        return 0
    monkeypatch.setattr(K, "n_sms", lambda index: 132)
    monkeypatch.setattr(K, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(K, "tile_counters", lambda *a: 0)
    monkeypatch.setattr(tfa, "blocks_per_sm", lambda rows, D, Dv=None: 2)
    monkeypatch.setattr(tfa._build, "function", lambda *a: entry)
    K.reset_launches()
    tfa._forward(q, k, v, True, 0, 0, True)
    return seen[0], dict(K.launches)


@pytest.mark.parametrize("D,Dv", WIDE, ids=IDS)
def test_wrapper_runs_bf16_wide_calls_on_the_wgmma_body(monkeypatch, D, Dv):
    """bf16 at a wide pair with enough heads: rows = 128, one range,
    counted as a wgmma call; f32 at the same shape hands no plan (the
    f32 body ignores it); a split grid stays on the tile."""
    def qkv(dtype, B, H, Kh, Sq, Sk):
        return (torch.zeros((B, H, Sq, D), dtype=dtype),
                torch.zeros((B, Kh, Sk, D), dtype=dtype),
                torch.zeros((B, Kh, Sk, Dv), dtype=dtype))
    plan, n = _dispatch(monkeypatch, *qkv(torch.bfloat16, 2, 64, 16, 256,
                                          256))
    assert plan == (tfa.WGMMA_ROWS, 1)
    assert n["flash_attention"] == n["flash_attention_wgmma"] == 1
    plan, n = _dispatch(monkeypatch, *qkv(torch.float32, 2, 64, 16, 256, 256))
    assert plan == (0, 1) and n["flash_attention_wgmma"] == 0
    plan, n = _dispatch(monkeypatch, *qkv(torch.bfloat16, 1, 4, 2, 64, 1500))
    assert plan[0] == 64 and plan[1] > 1
    assert n["flash_attention_split"] == 1 and n["flash_attention_wgmma"] == 0
    K.reset_launches()


# ---------------------------------------------------------------------------
# the walk against the JAX oracle's mask
# ---------------------------------------------------------------------------
def _jax_mask(Sq, Sk, causal, window, kv_offset):
    """[Sq, Sk] bool: the pairs the JAX oracle lets through, read from its
    output: q = 0 weighs every visible key alike, and one-hot key rows as
    v make out[i, j] > 0 exactly where row i sees key j."""
    q = jnp.zeros((1, 1, Sq, Sk), jnp.float32)
    k = jnp.zeros((1, 1, Sk, Sk), jnp.float32)
    v = jnp.eye(Sk, dtype=jnp.float32)[None, None]
    out = jax_flash_ref(q, k, v, causal=causal, window=window,
                        kv_offset=kv_offset)
    return torch.from_numpy(np.asarray(out[0, 0]) > 0)


def _walk_holds(Sq, Sk, causal, window, kv_offset, mask):
    """Every 128-row block's walk: whole tiles of 64 keys in order, inside
    the keys; each visible pair of the block's rows in a tile its
    warpgroup does not skip; "full" for a warpgroup only where every pair
    of its 64 rows and the tile's keys is inside Sq x Sk and visible,
    "empty" where none is visible, "edge" else."""
    seen, bk = torch.zeros_like(mask), BLOCK_K
    for q0 in range(0, Sq, tfa.WGMMA_ROWS):
        walk = tfa.wgmma_walk(q0, Sq, Sk, causal, window, kv_offset)
        starts = [k0 for k0, _ in walk]
        assert starts == list(range(starts[0], starts[0] + bk * len(walk),
                                    bk)) if walk else True
        for k0, kinds in walk:
            assert 0 <= k0 < Sk
            for w, kind in enumerate(kinds):
                r0 = q0 + 64 * w
                sub = mask[r0:r0 + 64, k0:k0 + bk]
                inside = r0 + 64 <= Sq and k0 + bk <= Sk
                want = ("empty" if not sub.any() else
                        "full" if inside and sub.all() else "edge")
                assert kind == want, (q0, k0, w, kind, want)
                if kind != "empty":
                    seen[r0:r0 + 64, k0:k0 + bk] = True
    assert not (mask & ~seen).any()


# (Sq, Sk, causal, window, kv_offset): square causal grids of several
# blocks, a window crossing blocks, a ragged chunk after cached keys, a
# non-causal ragged grid, rows that see no key
WALK_CASES = [(320, 320, True, 0, 0), (300, 330, True, 100, 30),
              (200, 130, False, 0, 0), (77, 200, True, 0, 123),
              (70, 100, True, 8, -20), (257, 257, True, 1, 0)]


@pytest.mark.parametrize("case", WALK_CASES)
def test_wgmma_walk_matches_the_jax_mask(case):
    Sq, Sk, causal, window, off = case
    mask = _jax_mask(Sq, Sk, causal, window, off)
    assert torch.equal(mask, _visible(Sq, Sk, causal, window, off, "cpu"))
    _walk_holds(Sq, Sk, causal, window, off, mask)


@settings(max_examples=100, deadline=None)
@given(Sq=st.integers(1, 400), Sk=st.integers(1, 400), causal=st.booleans(),
       window=st.sampled_from([0, 1, 5, 64, 100, 200]),
       kv_offset=st.integers(-80, 250))
def test_wgmma_walk_property(Sq, Sk, causal, window, kv_offset):
    """Drawn shapes and masks: the walk against the brute-force mask of the
    plain version (flash_attention_ref's)."""
    mask = _visible(Sq, Sk, causal, window, kv_offset, "cpu")
    _walk_holds(Sq, Sk, causal, window, kv_offset, mask)


# ---------------------------------------------------------------------------
# the arithmetic against the JAX oracle
# ---------------------------------------------------------------------------
def wgmma_tiles_ref(q, k, v, *, causal, window, kv_offset):
    """(out in bf16, lse in f32) as ``flash_fwd_wgmma_kernel`` computes
    them: q [B, H, Sq, D], k [B, Kh, Sk, D], v [B, Kh, Sk, Dv], f32 tensors
    holding bf16 values."""
    B, H, Sq, D = q.shape
    Kh, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    bk, G = BLOCK_K, H // Kh
    scale_log2 = LOG2E / math.sqrt(D)
    mask = _visible(Sq, Sk, causal, window, kv_offset, "cpu")
    out = torch.zeros((B, H, Sq, Dv))
    lse = torch.zeros((B, H, Sq))
    for b in range(B):
        for h in range(H):
            for q0 in range(0, Sq, tfa.WGMMA_ROWS):
                walk = tfa.wgmma_walk(q0, Sq, Sk, causal, window, kv_offset)
                for w in (0, 1):
                    r0 = q0 + 64 * w
                    r1 = min(r0 + 64, Sq)
                    if r0 >= Sq:
                        continue
                    m = torch.full((r1 - r0,), NEG_INF)
                    l = torch.zeros(r1 - r0)
                    acc = torch.zeros((r1 - r0, Dv))
                    for k0, kinds in walk:
                        if kinds[w] == "empty":
                            continue
                        kt = k[b, h // G, k0:k0 + bk]
                        vis = mask[r0:r1, k0:k0 + kt.shape[0]]
                        s = q[b, h, r0:r1] @ kt.T
                        mx = torch.where(vis, s, NEG_INF).amax(1)
                        m_new = torch.maximum(m, torch.where(
                            mx == NEG_INF, NEG_INF, mx * scale_log2))
                        alpha = torch.exp2(m - m_new)
                        p = torch.where(vis, torch.exp2(
                            s * scale_log2 - m_new[:, None]), 0.0)
                        p = p.bfloat16().float()
                        l = alpha * l + p.sum(1)
                        acc = alpha[:, None] * acc + p @ v[b, h // G,
                                                           k0:k0 + bk]
                        m = m_new
                    out[b, h, r0:r1] = acc / l.clamp_min(1e-30)[:, None]
                    lse[b, h, r0:r1] = torch.where(
                        l > 0, m * LN2 + torch.log(l), math.inf)
    return out.bfloat16(), lse


# (B, H, Kh, Sq, Sk, causal, window, kv_offset)
ARITH_CASES = [(1, 4, 2, 200, 200, True, 0, 0), (1, 2, 2, 150, 150, True, 40, 0),
               (1, 2, 1, 77, 200, True, 0, 123), (1, 2, 2, 140, 140, False, 0, 0),
               (1, 2, 2, 70, 100, True, 8, -20)]


@pytest.mark.parametrize("case", ARITH_CASES,
                         ids=["gqa", "window", "offset", "full", "empty-rows"])
@pytest.mark.parametrize("D,Dv", WIDE, ids=IDS)
def test_wgmma_arithmetic_matches_the_jax_oracle(case, D, Dv):
    B, H, Kh, Sq, Sk, causal, window, off = case
    rng = np.random.default_rng(D + 3 * Dv + Sq)

    def bf16(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.bfloat16().float()
    q, k, v = bf16(B, H, Sq, D), bf16(B, Kh, Sk, D), bf16(B, Kh, Sk, Dv)
    kw = dict(causal=causal, window=window, kv_offset=off)
    got, lse = wgmma_tiles_ref(q, k, v, **kw)
    # the oracle takes V as wide as Q: MLA's values padded with zero columns
    vp = torch.nn.functional.pad(v, (0, D - Dv))
    want = np.asarray(jax_flash_ref(jnp.asarray(q.numpy()),
                                    jnp.asarray(k.numpy()),
                                    jnp.asarray(vp.numpy()), **kw))[..., :Dv]
    assert got.shape == (B, H, Sq, Dv) and torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), want, atol=OUT_TOL,
                               rtol=0)
    _, want_lse = flash_attention_fwd_ref(q, k, v, **kw)
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isposinf(lse), ~seen)
    assert (lse[seen] - want_lse[seen]).abs().max().item() <= LSE_TOL
    if off < 0:
        assert not got[:, :, :-off].float().any()
