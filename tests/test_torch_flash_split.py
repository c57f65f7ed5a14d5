"""Split-KV flash attention on CPU: the plain versions of the split kernel
(per-split partials) and of the merge kernel, chained, against the port's
flash_attention_ref and the JAX package's oracle through numpy; the merge's
rule for splits that see no key; and ``plan``, which picks the query tile
and the number of splits for the bf16 kernel.

Tolerance: 1e-6 of the output's scale (max(1, max |out|)) in f32.
Splitting changes only the order in which the softmax sums are taken and
adds the merge's rescaling: a few f32 roundings of outputs that reach ~4
where a row sees few keys (one ulp there is 4.8e-7).
"""
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jflash_ref
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import (
    BLOCK_K, NEG_INF, flash_attention_partials_ref, flash_attention_ref,
    merge_partials_ref, split_ranges)

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want):
    want = np.asarray(want)
    atol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# (B, H, Kh, Sq, Sk, causal, window, kv_offset, n_split); comments name the
# splits that see no key
SPLIT_CASES = [
    (2, 3, 3, 1, 1500, False, 0, 0, 8),       # whisper decode rows
    (1, 4, 4, 37, 333, False, 0, 0, 3),       # ragged last split
    (1, 4, 2, 64, 300, True, 0, 0, 5),        # causal: splits 1-4 empty
    (2, 4, 1, 40, 400, True, 48, 200, 4),     # window: 0, 2, 3 empty
    (1, 2, 2, 30, 256, True, 0, -100, 4),     # negative offset: all empty,
    #                                           rows 0-99 see no key at all
    (1, 8, 2, 17, 129, True, 16, 120, 3),     # GQA, window over split edges
]


@pytest.mark.parametrize("B,H,Kh,Sq,Sk,causal,window,off,n_split",
                         SPLIT_CASES)
def test_split_then_merge_matches_flash_attention(B, H, Kh, Sq, Sk, causal,
                                                  window, off, n_split):
    D = 64
    rng = np.random.default_rng([B, H, Kh, Sq, Sk, n_split])
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Kh, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Kh, Sk, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, kv_offset=off)
    m, l, acc = flash_attention_partials_ref(_t(q), _t(k), _t(v), n_split,
                                             **kw)
    assert m.shape == l.shape == (n_split, B, H, Sq)
    assert acc.shape == (n_split, B, H, Sq, D)
    got = tfa.merge_partials(m, l, acc, torch.empty((B, H, Sq, D))).numpy()
    _close(got, flash_attention_ref(_t(q), _t(k), _t(v), **kw).numpy())
    _close(got, jflash_ref(q, k, v, **kw))


def test_splits_that_see_no_key_hold_zero_and_weigh_nothing(rng):
    """Causal 64 rows over 300 keys in 5 splits of 64: only split 0 sees a
    key.  The others have l = 0, acc = 0, m = NEG_INF exactly, and the
    merge ignores them even when their m is garbage."""
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 2, 64, 64), (1, 2, 300, 64), (1, 2, 300, 64)))
    m, l, acc = flash_attention_partials_ref(q, k, v, 5, causal=True)
    assert (l[0] > 0).all()
    assert not l[1:].any() and not acc[1:].any()
    assert (m[1:] == NEG_INF).all()
    want = merge_partials_ref(m, l, acc)
    m[1:] = 1e4                                   # would dominate if used
    np.testing.assert_array_equal(merge_partials_ref(m, l, acc).numpy(),
                                  want.numpy())
    _close(want.numpy(), flash_attention_ref(q, k, v).numpy())


def test_rows_no_split_saw_merge_to_zero(rng):
    q, k = (_t(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 1, 6, 64), (1, 1, 130, 64)))
    parts = flash_attention_partials_ref(q, k, k, 3, causal=True,
                                         kv_offset=-3)
    out = merge_partials_ref(*parts)
    assert not out[:, :, :3].any() and out[:, :, 3:].abs().min() > 0


def test_split_ranges_hold_whole_tiles():
    assert split_ranges(1500, 8) == [(s * 192, min(s * 192 + 192, 1500))
                                     for s in range(8)]
    assert split_ranges(100, 1) == [(0, 100)]
    for lo, hi in split_ranges(1000, 6):          # 16 tiles, 3 a split
        assert lo % BLOCK_K == 0 and hi > lo
    assert split_ranges(1000, 6)[-1] == (960, 1000)


def test_cpu_split_wrappers_count_no_launch(rng):
    K.reset_launches()
    x = _t(rng.standard_normal((1, 2, 3, 64)).astype(np.float32))
    parts = flash_attention_partials_ref(x, x, x, 1, causal=False)
    tfa.merge_partials(*parts, torch.empty_like(x))
    tfa.flash_attention(x, x, x, causal=False)
    assert K.launches["flash_attention"] == 0
    assert K.launches["flash_attention_merge"] == 0
    assert K.launches["flash_attention_split"] == 0


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------
# whisper-small's shapes (H = 12, 1500 frames) and others, on 132 SMs
PLAN_CASES = [(4, 12, 1500, 1500), (1, 12, 1500, 1500), (8, 12, 1, 1500),
              (4, 12, 1, 1500), (1, 12, 1, 1500), (1, 1, 1, 1500),
              (4, 12, 64, 1500), (8, 12, 40, 1500), (1, 32, 1024, 1024),
              (2, 32, 256, 1024), (3, 4, 9, 65), (1, 1, 1, 1),
              (1, 1, 1, 64), (1, 1, 100, 0)]


@pytest.mark.parametrize("B,H,Sq,Sk", PLAN_CASES)
@pytest.mark.parametrize("n_sms,per_sm", [(132, 3), (114, 2)])
def test_plan_fills_the_card_with_whole_tile_splits(B, H, Sq, Sk, n_sms,
                                                    per_sm):
    rows, n_split = tfa.plan(B, H, Sq, Sk, n_sms, per_sm)
    assert rows == (16 if Sq <= 16 else 64)     # one warp or four
    tiles = -(-Sk // BLOCK_K)
    cap = tiles if rows == 16 else min(tiles, tfa.MAX_SPLITS_64)
    assert 1 <= n_split <= max(cap, 1)
    per = -(-tiles // n_split)
    assert (n_split - 1) * per < tiles or tiles == 0   # no empty split
    assert split_ranges(Sk, n_split) == [
        (s * per * BLOCK_K, min((s + 1) * per * BLOCK_K, Sk))
        for s in range(n_split)]
    blocks = B * H * -(-Sq // rows)
    wave = per_sm * n_sms
    if n_split > 1:
        assert blocks * n_split <= wave       # every block in one wave
    # the next split count of whole tiles would leave the wave, the tiles
    # or the 64-row tile's cap behind
    more = -(-tiles // (per - 1)) if per > 1 else tiles + 1
    assert blocks * more > wave or more > cap


def test_plan_splits_short_tiles_and_not_the_encoder():
    # whisper-small on an H100: 3 blocks of either tile per SM
    assert tfa.plan(4, 12, 1500, 1500, 132, 3) == (64, 1)
    assert tfa.plan(1, 12, 1500, 1500, 132, 3) == (64, 1)
    rows, n_split = tfa.plan(8, 12, 1, 1500, 132, 3)    # decode rows
    assert rows == 16 and n_split > 1
    rows, n_split = tfa.plan(4, 12, 64, 1500, 132, 3)   # a 64-row chunk
    assert rows == 64 and n_split > 1
