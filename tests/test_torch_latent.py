"""MLA's latent-row kernels (``csrc/attn_latent.cuh``) off the card: the
split plan of their decode, their contract checks, and a plain PyTorch
emulation of their decomposition (``latent_tiles_ref``: 64-row query
tiles, 32-key latent tiles, an online softmax in log2 units, split
partials merged by log-sum-exp as the kernel's cluster merges them)
against the port's plain versions and the JAX package's paged attention.

Tolerances: 1e-5 absolute in f32, where tiling and splitting change only
the order of the softmax sums (a few f32 roundings of outputs below ~4).
In bf16 at D = 576, G = 128 the emulation weighs P V as the wgmma tiles
do (prefill rounds P to bf16; decode takes P as hi + lo, two bf16 parts;
l sums the P that is weighed) and rounds the output once, and is held to
the card's bars against the plain version's f32 output on the same
inputs: decode 4e-3 (outputs of lanes of 40-300 keys stay below 1, where
one rounding is at most 2^-9), prefill 2e-2 (the chunk's first rows see a
few keys and keep values near 4, where one rounding is 1.6e-2).  The
decode bar was set for a P that is not rounded: one rounding of P alone
takes a lane of 17 keys past it (held below), hence hi + lo.
"""
import inspect
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention import ops as jpa
from repro_torch import kernels as K
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.paged_attention.ref import (
    latent_tiles_ref, paged_attention_ref, paged_prefill_attention_ref,
    split_columns)

ATOL = 1e-5
BARS = {"decode": 4e-3, "prefill": 2e-2}
PAGE = 16


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _latent(seed, *, lens, H, D, max_pages, C=None, n_pages=None,
            dtype=np.float32):
    """Random latent pages (one KV head; the last page is scratch), block
    tables whose unused columns point at scratch, and queries: decode
    [B, H, D] (C None) or a chunk [B, C, H, D].  A lane whose length is
    None is padded: its table is all scratch and its length 1 (decode) or
    0 (prefill)."""
    rng = np.random.default_rng(seed)
    n_pages = n_pages or len(lens) * max_pages + 1
    scratch = n_pages - 1
    pages = rng.standard_normal((n_pages, PAGE, 1, D)).astype(dtype)
    tables = np.full((len(lens), max_pages), scratch, np.int32)
    free = list(rng.permutation(scratch))
    for b, n in enumerate(lens):
        for j in range(-(-(n or 0) // PAGE)):
            tables[b, j] = free.pop()
    shape = (len(lens), H, D) if C is None else (len(lens), C, H, D)
    q = rng.standard_normal(shape).astype(dtype)
    return q, pages, tables


# ---------------------------------------------------------------------------
# latent_decode_plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B", [1, 2, 3, 8, 16, 33, 64])
@pytest.mark.parametrize("P", [1, 4, 8, 44, 64, 256])
@pytest.mark.parametrize("n_sms", [132, 114])
def test_latent_plan_cuts_whole_tiles_and_fills_the_card(B, P, n_sms):
    n_split, per = tpa.latent_decode_plan(B, 128, P, PAGE, n_sms)
    assert isinstance(n_split, int) and isinstance(per, int)
    assert 1 <= n_split <= P
    assert per * PAGE % tpa.LATENT_KEYS == 0          # whole 32-key tiles
    assert (n_split - 1) * per < P <= n_split * per    # no empty split
    assert per * PAGE >= tpa.LATENT_MIN_SPLIT_KEYS or n_split == 1
    blocks = B * 2 * n_split                           # 2 head tiles of 64
    if n_split > 1:
        assert blocks <= n_sms                         # one wave
    assert n_split <= tpa.LATENT_MAX_SPLIT             # one cluster
    # the card is at least half full, unless the table has no room for
    # more splits of the least size or the cluster holds no more
    assert blocks > n_sms // 2 or n_split == tpa.LATENT_MAX_SPLIT or \
        P * PAGE // tpa.LATENT_MIN_SPLIT_KEYS < 2 * n_split


def test_latent_plan_at_the_smoke_shapes():
    # B = 8 at ctx 600-700 (64 table columns): 16 (request, head tile)
    # pairs x 8 splits of 8 pages = 128 blocks on 132 SMs
    assert tpa.latent_decode_plan(8, 128, 64, 16, 132) == (8, 8)
    assert tpa.latent_decode_plan(64, 128, 64, 16, 132) == (1, 64)
    # a short table is not split below 128 keys a split
    assert tpa.latent_decode_plan(1, 128, 8, 16, 132) == (1, 8)
    # 4 heads fit one tile: more splits for the same card
    assert tpa.latent_decode_plan(16, 4, 256, 16, 132)[0] > \
        tpa.latent_decode_plan(16, 128, 256, 16, 132)[0]
    # a long lane alone: the splits of a cluster at most
    assert tpa.latent_decode_plan(1, 128, 256, 16, 132) == (8, 32)


# clusters of n latent decode blocks an H100 (132 SMs) runs at once
# (cudaOccupancyMaxActiveClusters of the kernel, read on the card)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("B,want", [(1, 8), (4, 8), (8, 6), (16, 3),
                                    (33, 2), (64, 1)])
def test_latent_plan_keeps_every_cluster_on_the_card(B, want):
    """The splits of each (request, head tile) pair form one cluster: the
    plan takes the most splits for which the card runs all the pairs'
    clusters at once (B = 8: 16 pairs fit 17 clusters of 6, not 15 of
    8)."""
    n_split, per = tpa.latent_decode_plan(B, 128, 64, 16, 132,
                                          H100_CLUSTERS.get)
    assert n_split == want
    assert B * 2 <= H100_CLUSTERS[n_split]
    assert (n_split - 1) * per < 64 <= n_split * per


def test_latent_plan_takes_shapes_only():
    """The plan reads no lengths (only shapes and the card's cluster
    capacity), and the latent decode path reads no device value on the
    host, so a decode call can be captured in a CUDA graph."""
    params = list(inspect.signature(tpa.latent_decode_plan).parameters)
    assert params == ["B", "H", "max_pages", "page", "n_sms", "max_clusters"]
    src = inspect.getsource(tpa._latent_decode)
    assert not re.search(r"\.(item|tolist|cpu|numpy)\(|\bint\(lengths", src)


# ---------------------------------------------------------------------------
# the contract the wrapper checks before a bf16 call at D = 576 launches
# ---------------------------------------------------------------------------
def _contract_inputs(Kh=1, distinct=False):
    q = torch.zeros((2, 8, 576), dtype=torch.bfloat16)
    kp = torch.zeros((4, PAGE, Kh, 576), dtype=torch.bfloat16)
    return q, kp, kp.clone() if distinct else kp


@pytest.mark.parametrize("case,match", [
    ("distinct", "same pages"), ("kh2", "one KV head"),
    ("window", "no window"), ("page12", "page of 8, 16, 32")])
def test_latent_contract_names_what_it_refuses(case, match):
    q, kp, vp = _contract_inputs(Kh=2 if case == "kh2" else 1,
                                 distinct=case == "distinct")
    window = 64 if case == "window" else 0
    page = 12 if case == "page12" else PAGE
    with pytest.raises(ValueError, match=match):
        tpa._latent_require(q, kp, vp, kp.shape[2], page, window)


def test_latent_contract_takes_the_mla_call():
    q, kp, vp = _contract_inputs()
    for page in (8, 16, 32, 64):
        tpa._latent_require(q, kp, vp, 1, page, 0)


def test_cpu_latent_calls_take_the_plain_version_and_count_no_launch():
    q, pages, tables = _latent(1, lens=[20, 37], H=8, D=576, max_pages=4)
    K.reset_launches()
    lens = _t(np.asarray([20, 37], np.int32))
    args = (_t(q).bfloat16(), _t(pages).bfloat16())
    got = tpa.paged_attention(args[0], args[1], args[1], _t(tables), lens)
    want = paged_attention_ref(args[0], args[1], args[1], _t(tables), lens)
    assert torch.equal(got, want)
    tpa.paged_prefill_attention(args[0][:, None], args[1], args[1],
                                _t(tables), lens - 1)
    assert K.launches["paged_attention_latent"] == 0
    assert K.launches["paged_prefill_attention_latent"] == 0
    assert not any(K.launches.values())


# ---------------------------------------------------------------------------
# the kernels' decomposition against the plain versions, f32
# ---------------------------------------------------------------------------
# (lens, H, D, max_pages, n_split): a lane of one key, lanes that end
# mid-page and at a page edge, a padded lane (None), splits past every
# lane, more head rows than one tile (H = 128) and fewer (H = 4)
DECODE_CASES = {
    "g4-one-split": ([1, 17, 64, None], 4, 80, 8, 1),
    "g4-splits": ([1, 17, 64, None], 4, 80, 8, 3),
    "g128-splits": ([1, 40, 150, None], 128, 80, 16, 4),
    "g128-d576": ([1, 33, 100], 128, 576, 8, 2),
    "g128-empty-splits": ([5, 30, None], 128, 80, 16, 6),
}


@pytest.mark.parametrize("case", DECODE_CASES)
def test_latent_decode_tiles_match_the_plain_version(case):
    lens, H, D, P, n_split = DECODE_CASES[case]
    q, pages, tables = _latent(sum(map(ord, case)), lens=lens, H=H, D=D,
                               max_pages=P)
    lengths = _t(np.asarray([n or 1 for n in lens], np.int32))
    args = (_t(q), _t(pages), _t(tables))
    per = split_columns(P, n_split)[0][1]
    got = latent_tiles_ref(*args, lengths, decode=True, n_split=n_split,
                           split_pages=per)
    assert got.shape == q.shape and torch.isfinite(got).all()
    want = paged_attention_ref(args[0], args[1], args[1], args[2], lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    # a lane of one key returns the key's row
    if lens[0] == 1:
        np.testing.assert_allclose(
            got[0].numpy(), np.broadcast_to(pages[tables[0, 0], 0, 0],
                                            (H, D)), atol=ATOL, rtol=0)


# (ctx, C, H, D, max_pages): a first chunk, later chunks, a padded lane
# (None: ctx 0 over scratch), C not a multiple of the 64-row tile
PREFILL_CASES = {
    "g4": ([0, 13, 60, None], 37, 4, 80, 8),
    "g128": ([0, 13, 60, None], 5, 128, 80, 8),
    "g128-d576": ([0, 40], 3, 128, 576, 4),
}


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_latent_prefill_tiles_match_the_plain_version(case):
    ctx, C, H, D, P = PREFILL_CASES[case]
    lens = [None if c is None else c + C for c in ctx]
    q, pages, tables = _latent(sum(map(ord, case)), lens=lens, H=H, D=D,
                               max_pages=P, C=C)
    ctx_t = _t(np.asarray([c or 0 for c in ctx], np.int32))
    args = (_t(q), _t(pages), _t(tables))
    got = latent_tiles_ref(*args, ctx_t, decode=False)
    assert got.shape == q.shape and torch.isfinite(got).all()
    want = paged_prefill_attention_ref(args[0], args[1], args[1], args[2],
                                       ctx_t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_latent_tiles_match_the_jax_package():
    """Decode and a chunk at D = 576, G = 128 through the emulation and
    through the JAX package's paged attention (its jnp oracle)."""
    lens = [40, 150]
    q, pages, tables = _latent(5, lens=lens, H=128, D=576, max_pages=16)
    lengths = np.asarray(lens, np.int32)
    got = latent_tiles_ref(_t(q), _t(pages), _t(tables), _t(lengths),
                           decode=True, n_split=3)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(pages),
        jnp.asarray(tables), jnp.asarray(lengths), use_kernel=False))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ctx = np.asarray([0, 30], np.int32)
    qc = np.random.default_rng(6).standard_normal(
        (2, 4, 128, 576)).astype(np.float32)
    got = latent_tiles_ref(_t(qc), _t(pages), _t(tables), _t(ctx),
                           decode=False)
    want = np.asarray(jpa.paged_prefill_attention(
        jnp.asarray(qc), jnp.asarray(pages), jnp.asarray(pages),
        jnp.asarray(tables), jnp.asarray(ctx), use_kernel=False))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# bf16 at full width: rounding P for the tensor cores stays inside the bars
# ---------------------------------------------------------------------------
def test_latent_decode_bf16_rounding_stays_inside_the_bar():
    lens = [40, 150, 300]
    q, pages, tables = _latent(7, lens=lens, H=128, D=576, max_pages=32)
    qb, pb = _t(q).bfloat16(), _t(pages).bfloat16()
    lengths = _t(np.asarray(lens, np.int32))
    n_split, per = tpa.latent_decode_plan(len(lens), 128, 32, PAGE, 132)
    assert n_split > 1
    got = latent_tiles_ref(qb, pb, _t(tables), lengths, decode=True,
                           n_split=n_split, split_pages=per, round_bf16=True)
    want = paged_attention_ref(qb.float(), pb.float(), pb.float(),
                               _t(tables), lengths)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max().item()
    assert err <= BARS["decode"]


def test_latent_prefill_bf16_rounding_stays_inside_the_bar():
    ctx, C = [0, 45], 6
    q, pages, tables = _latent(8, lens=[c + C for c in ctx], H=128, D=576,
                               max_pages=4, C=C)
    qb, pb = _t(q).bfloat16(), _t(pages).bfloat16()
    ctx_t = _t(np.asarray(ctx, np.int32))
    got = latent_tiles_ref(qb, pb, _t(tables), ctx_t, decode=False,
                           round_bf16=True)
    want = paged_prefill_attention_ref(qb.float(), pb.float(), pb.float(),
                                       _t(tables), ctx_t)
    err = (got.float() - want).abs().max().item()
    assert err <= BARS["prefill"]


def test_latent_decode_p_split_keeps_the_card_tests_bar():
    """The card test's inputs (tests/test_torch_cuda.py
    test_decode_latent_head_dims_match_plain at bf16, D = 576, G = 128:
    lanes of 1, 17, 200 and 650 keys), held as it holds the kernel, against
    the plain version's bf16 output: P as hi + lo stays within 4e-3, while
    one rounding of P would not (the lane of 17 keys, outputs near 2)."""
    D, G = 576, 128
    gen = torch.Generator().manual_seed(D + G)
    lens, max_pages = [1, 17, 200, 650], 48
    n_pages = len(lens) * max_pages + 1
    kp = torch.randn((n_pages, PAGE, 1, D), generator=gen).bfloat16()
    torch.randn((n_pages, PAGE, 1, D), generator=gen)     # the card's V draw
    tables = np.full((len(lens), max_pages), n_pages - 1, np.int32)
    order = list(np.random.default_rng(0).permutation(n_pages - 1))
    for b, n in enumerate(lens):
        for j in range(-(-n // PAGE)):
            tables[b, j] = order.pop()
    q = torch.randn((len(lens), G, D), generator=gen).bfloat16()
    lengths = _t(np.asarray(lens, np.int32))
    want = paged_attention_ref(q, kp, kp, _t(tables), lengths).float()
    n_split, per = tpa.latent_decode_plan(len(lens), G, max_pages, PAGE, 132)
    errs = {}
    for hi_lo in (True, False):
        got = latent_tiles_ref(q, kp, _t(tables), lengths, decode=True,
                               n_split=n_split, split_pages=per,
                               round_bf16=True, p_hi_lo=hi_lo)
        errs[hi_lo] = (got.float() - want).abs().max().item()
    assert errs[True] <= BARS["decode"] < errs[False]
