"""Split-KV decode attention on CPU: the plain version of the decode
kernel's split (per-split partials over ranges of table columns, then the
log-sum-exp merge) against the port's paged_attention_ref and against the
JAX package's paged-attention ops (the Pallas kernel in interpret mode and
its jnp oracle); and ``decode_plan``, which picks the number of splits
from shapes alone.

Tolerance: 1e-5 absolute in f32.  Splitting changes only the order in
which the softmax sums are taken and adds the merge's rescaling: a few f32
roundings of outputs that stay below ~4.
"""
import inspect
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention import ops as jpa
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                    merge_partials_ref)
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_partials_ref, paged_attention_ref,
    paged_attention_split_ref, split_columns)

ATOL = 1e-5
PAGE = 4


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(seed, *, lens, H, Kh, D, max_pages, n_pages=40):
    """Random pages with scratch page n_pages - 1; each lane owns distinct
    pages covering its length, the rest of its table row points at
    scratch; a lane of length None is a padded lane (length 1 on
    scratch)."""
    rng = np.random.default_rng(seed)
    scratch = n_pages - 1
    kp = rng.standard_normal((n_pages, PAGE, Kh, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PAGE, Kh, D)).astype(np.float32)
    tables = np.full((len(lens), max_pages), scratch, np.int32)
    free = list(rng.permutation(scratch))
    for b, n in enumerate(lens):
        for j in range(-(-(n or 0) // PAGE)):
            tables[b, j] = free.pop()
    lengths = np.asarray([n or 1 for n in lens], np.int32)
    q = rng.standard_normal((len(lens), H, D)).astype(np.float32)
    return q, kp, vp, tables, lengths


# (lens, H, Kh, D, window, max_pages, n_split); None = padded lane
SPLIT_CASES = {
    "mha": ([5, 13, 30, None], 4, 4, 16, 0, 8, 3),
    "gqa": ([9, 32, 17, None], 8, 2, 16, 0, 8, 4),
    "window": ([5, 13, 30, 27], 4, 2, 16, 6, 8, 4),     # splits before the
    #                                                     window see nothing
    "whisper": ([3, 40, 41, 48], 12, 12, 64, 0, 16, 5),
    "empty-split": ([3, 5, 9, None], 4, 4, 16, 0, 8, 4),  # splits 2-3 lie
    #                                                       past every lane
    "more-splits-than-pages": ([7, 2, 11, None], 4, 2, 16, 0, 4, 6),
}


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_then_merge_matches_paged_attention(case):
    lens, H, Kh, D, window, max_pages, n_split = SPLIT_CASES[case]
    q, kp, vp, tables, lengths = _inputs(
        sum(map(ord, case)), lens=lens, H=H, Kh=Kh, D=D, max_pages=max_pages)
    args = (_t(q), _t(kp), _t(vp), _t(tables), _t(lengths))
    got = paged_attention_split_ref(*args, n_split, window=window).numpy()
    assert got.shape == q.shape and np.isfinite(got).all()
    want = paged_attention_ref(*args, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    valid = [b for b, n in enumerate(lens) if n is not None]
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    for use_kernel in (True, False):
        jwant = np.asarray(jpa.paged_attention(
            *jargs, interpret=True, use_kernel=use_kernel, window=window))
        np.testing.assert_allclose(got[valid], jwant[valid], atol=ATOL,
                                   rtol=0)


def test_splits_past_a_lane_hold_nothing_and_weigh_nothing():
    """Lane lengths 3, 5 and 9 over 8 columns of 4 keys in 4 splits of 2
    columns: only split 0 (and split 1 for the lane of 9) sees a key.  The
    others have l = 0, acc = 0 and m = NEG_INF exactly, and the merge
    ignores them even when their m is garbage."""
    q, kp, vp, tables, lengths = _inputs(3, lens=[3, 5, 9], H=2, Kh=2,
                                         D=8, max_pages=8)
    args = (_t(q), _t(kp), _t(vp), _t(tables), _t(lengths))
    m, l, acc = paged_attention_partials_ref(*args, 4)
    assert m.shape == l.shape == (4, 3, 2) and acc.shape == (4, 3, 2, 8)
    assert (l[0] > 0).all() and (l[1, 2] > 0).all()
    assert not l[1, :2].any() and not l[2:].any() and not acc[2:].any()
    assert (m[2:] == NEG_INF).all()
    want = merge_partials_ref(m, l, acc)
    m[2:] = 1e4                                   # would dominate if used
    np.testing.assert_array_equal(merge_partials_ref(m, l, acc).numpy(),
                                  want.numpy())


def test_split_columns_cover_the_table_in_whole_pages():
    assert split_columns(64, 5) == [(0, 13), (13, 26), (26, 39), (39, 52),
                                    (52, 64)]
    assert split_columns(4, 6) == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 4),
                                   (4, 4)]
    assert split_columns(7, 1) == [(0, 7)]


def test_cpu_decode_counts_no_launch():
    K.reset_launches()
    q, kp, vp, tables, lengths = _inputs(0, lens=[5, 9], H=2, Kh=2, D=8,
                                         max_pages=4)
    tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lengths))
    assert K.launches["paged_attention"] == 0
    assert K.launches["paged_attention_merge"] == 0
    assert K.launches["paged_attention_split"] == 0


# ---------------------------------------------------------------------------
# decode_plan
# ---------------------------------------------------------------------------
# (B, H, Kh, max_pages): LLaVA's decode batches, whisper's decoder, GQA,
# long contexts, and tables too short to split
PLAN_CASES = [(8, 32, 32, 64), (4, 32, 32, 64), (5, 32, 32, 64),
              (1, 32, 32, 256), (1, 32, 32, 64), (4, 32, 8, 64),
              (4, 12, 12, 4), (4, 12, 12, 64), (1, 12, 12, 1),
              (64, 32, 32, 64), (2, 16, 1, 128), (3, 6, 3, 8)]


@pytest.mark.parametrize("B,H,Kh,P", PLAN_CASES)
@pytest.mark.parametrize("n_sms", [132, 114])
def test_decode_plan_splits_whole_pages_and_fills_the_card(B, H, Kh, P,
                                                           n_sms):
    n_split = tpa.decode_plan(B, H, Kh, 128, P, 16, n_sms)
    assert isinstance(n_split, int) and 1 <= n_split <= P
    per = -(-P // n_split)
    assert (n_split - 1) * per < P                     # no empty split
    assert all(hi > lo for lo, hi in split_columns(P, n_split))
    assert per * 16 >= tpa.MIN_SPLIT_KEYS or n_split == 1
    blocks = B * H // tpa.heads_per_block(H // Kh, 128)
    target = tpa.WAVE_BLOCKS * n_sms
    if n_split > 1:
        assert blocks < target
    else:
        assert blocks >= target or P * 16 < 2 * tpa.MIN_SPLIT_KEYS \
            or -(-target // blocks) == 1


def test_decode_plan_splits_small_batches_more():
    big = tpa.decode_plan(8, 32, 32, 128, 64, 16, 132)
    one = tpa.decode_plan(1, 32, 32, 128, 64, 16, 132)
    assert 1 <= big < one
    # whisper's 12 KV heads split more than LLaVA's 32 at the same table
    assert tpa.decode_plan(4, 12, 12, 128, 64, 16, 132) > \
        tpa.decode_plan(4, 32, 32, 128, 64, 16, 132)
    # a long context splits more than a short one, a 4-page table not at all
    assert tpa.decode_plan(1, 32, 32, 128, 256, 16, 132) >= one
    assert tpa.decode_plan(4, 12, 12, 128, 4, 16, 132) == 1


def test_decode_plan_takes_shapes_only():
    """The plan is a function of shapes (no lengths), and the CUDA path of
    the wrapper reads no device value on the host, so a decode call can be
    captured in a CUDA graph."""
    params = list(inspect.signature(tpa.decode_plan).parameters)
    assert params == ["B", "H", "Kh", "D", "max_pages", "page", "n_sms"]
    src = inspect.getsource(tpa.paged_attention)
    assert not re.search(r"\.(item|tolist|cpu|numpy)\(|\bint\(lengths", src)
    assert tpa.decode_plan(8, 32, 32, 128, 64, 16, 132) == \
        tpa.decode_plan(8, 32, 32, 128, 64, 16, 132)


def test_heads_per_block_keeps_q_and_acc_in_registers():
    """Above D = 256 (MLA's 576-wide latent rows in f32; bf16 runs on the
    latent-row kernels) a decode block holds 2 query heads, as the
    kernel's ``DecCfg::MAX_GT`` does, and the plan counts its blocks so."""
    assert tpa.heads_per_block(128, 576) == 2
    assert tpa.heads_per_block(1, 576) == 1
    assert tpa.heads_per_block(128, 80) == tpa.heads_per_block(128, 256) == 8
    # B = 8 at G = 128: 512 blocks of 2 heads want 2 splits, 128 of 8 want 5
    assert tpa.decode_plan(8, 128, 1, 576, 64, 16, 132) == 2
    assert tpa.decode_plan(8, 128, 1, 112, 64, 16, 132) == 5
