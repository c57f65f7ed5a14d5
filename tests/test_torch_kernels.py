"""The port's cache-write and paged-attention wrappers on CPU (their plain
PyTorch versions) against the JAX ops, run both as Pallas kernels in
interpret mode and through their jnp oracles, on identical numpy inputs.

Tolerance: 1e-5 absolute in f32 (same arithmetic, different summation
order).  Only valid rows are compared; rows whose mask is empty (padded
chunk positions) must still be finite.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.cache_write import ops as jcw
from repro.kernels.paged_attention import ops as jpa
from repro_torch import kernels as K
from repro_torch.kernels.cache_write import ops as tcw
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.selective_scan import ops as tss

ATOL = 1e-5
PAGE = 4


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _paged_inputs(rng, *, B, lens, H, Kh, D, n_pages=24, max_pages=6):
    """Random pages with scratch page ``n_pages - 1``; each request owns
    distinct pages covering its length, the rest of its table row points
    at scratch.  Lanes with length None are padded lanes (all scratch)."""
    scratch = n_pages - 1
    kp = rng.standard_normal((n_pages, PAGE, Kh, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PAGE, Kh, D)).astype(np.float32)
    tables = np.full((B, max_pages), scratch, np.int32)
    free = list(rng.permutation(scratch))
    for b, n in enumerate(lens):
        if n is None:
            continue
        for j in range(-(-n // PAGE)):
            tables[b, j] = free.pop()
    return kp, vp, tables


# ---------------------------------------------------------------------------
# cache write
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [True, False], ids=["interpret", "ref"])
def test_cache_write_matches_jax(rng, use_kernel):
    cache = rng.standard_normal((6, 4, 16)).astype(np.float32)
    new = rng.standard_normal((9, 16)).astype(np.float32)
    slots = rng.permutation(24)[:9].astype(np.int32)   # distinct rows
    want = np.asarray(jcw.cache_write(jnp.asarray(cache), jnp.asarray(new),
                                      jnp.asarray(slots), interpret=True,
                                      use_kernel=use_kernel))
    # the flat cache is a one-tensor, one-layer paged store
    got = _t(cache)
    out = tcw.paged_chunk_write(got[None, None], 0, _t(new)[None, None],
                                _t(slots)[None])
    assert out.data_ptr() == got.data_ptr()              # in place
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("C", [1, 5], ids=["token", "chunk"])
def test_paged_chunk_write_matches_jax(rng, C):
    """Both tensors of one layer of a [T, L, NB+1, bs, w] pool in one call;
    padded lanes and padded chunk positions land on the scratch block,
    which is left out of the comparison (duplicate writes there have no
    defined order)."""
    T, L, NB, bs, w, B, layer = 2, 3, 8, 4, 16, 3, 1
    scratch = NB
    data = rng.standard_normal((T, L, NB + 1, bs, w)).astype(np.float32)
    rows = rng.standard_normal((T, B, C, w)).astype(np.float32)
    slots = np.full((B, C), scratch * bs, np.int32)
    valid = rng.permutation(NB * bs)[:2 * C].reshape(2, C)
    slots[:2] = valid
    slots[1, C - 1:] = scratch * bs                      # a padded position
    for use_kernel in (True, False):
        if C == 1:
            want = jcw.paged_token_write(jnp.asarray(data), layer,
                                         jnp.asarray(rows[:, :, 0]),
                                         jnp.asarray(slots[:, 0]),
                                         interpret=True, use_kernel=use_kernel)
        else:
            want = jcw.paged_chunk_write(jnp.asarray(data), layer,
                                         jnp.asarray(rows), jnp.asarray(slots),
                                         interpret=True, use_kernel=use_kernel)
        got = _t(data)
        if C == 1:
            tcw.paged_token_write(got, layer, _t(rows[:, :, 0]),
                                  _t(slots[:, 0]))
        else:
            tcw.paged_chunk_write(got, layer, _t(rows), _t(slots))
        np.testing.assert_allclose(got.numpy()[:, :, :NB],
                                   np.asarray(want)[:, :, :NB], atol=ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# paged attention (decode)
# ---------------------------------------------------------------------------
ATTN_CASES = [(4, 4, 0), (4, 2, 0), (4, 4, 6), (4, 2, 6)]   # (H, Kh, window)


@pytest.mark.parametrize("H,Kh,window", ATTN_CASES,
                         ids=[f"H{h}-Kh{k}-w{w}" for h, k, w in ATTN_CASES])
def test_paged_attention_matches_jax(rng, H, Kh, window):
    D, B = 16, 4
    lens = [1, 7, 13, None]          # straddles page boundaries; lane 3 pad
    kp, vp, tables = _paged_inputs(rng, B=B, lens=lens, H=H, Kh=Kh, D=D)
    lengths = np.asarray([n if n is not None else 1 for n in lens], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    got = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lengths),
                              window=window).numpy()
    assert np.isfinite(got).all()
    for use_kernel in (True, False):
        want = np.asarray(jpa.paged_attention(*args, interpret=True,
                                              use_kernel=use_kernel,
                                              window=window))
        np.testing.assert_allclose(got[:3], want[:3], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# paged attention (chunked prefill)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("H,Kh,window", ATTN_CASES,
                         ids=[f"H{h}-Kh{k}-w{w}" for h, k, w in ATTN_CASES])
def test_paged_prefill_attention_matches_jax(rng, H, Kh, window):
    D, B, C = 16, 3, 8
    ctx = np.asarray([0, 5, 9], np.int32)
    n_new = [8, 6, 3]                # lanes 1, 2 carry padded positions
    kp, vp, tables = _paged_inputs(
        rng, B=B, lens=[int(c) + n for c, n in zip(ctx, n_new)], H=H, Kh=Kh,
        D=D)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, ctx)]
    got = tpa.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                      _t(ctx), window=window).numpy()
    assert np.isfinite(got).all()    # empty-mask rows come out finite
    for use_kernel in (True, False):
        want = np.asarray(jpa.paged_prefill_attention(
            *args, interpret=True, use_kernel=use_kernel, window=window))
        for b, n in enumerate(n_new):
            np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL,
                                       rtol=0)


def test_cpu_calls_take_plain_versions_and_count_no_launch(rng):
    """CPU tensors go to the plain versions; the launch counters only move
    when a kernel really launches."""
    K.reset_launches()
    kp, vp, tables = _paged_inputs(rng, B=1, lens=[5], H=2, Kh=2, D=8)
    q = _t(rng.standard_normal((1, 2, 8)).astype(np.float32))
    lens = torch.tensor([5], dtype=torch.int32)
    tpa.paged_attention(q, _t(kp), _t(vp), _t(tables), lens)
    tpa.paged_prefill_attention(q[:, None], _t(kp), _t(vp), _t(tables),
                                lens - 1)
    tcw.paged_token_write(_t(kp).view(1, 1, -1, PAGE, 16), 0,
                          q.reshape(1, 1, 16), torch.tensor([3], dtype=torch.int32))
    tss.selective_scan(q, q, -q[0].abs().T, q[:, :, :2], q[:, :, :2])
    xh = _t(rng.standard_normal((1, 2, 64)).astype(np.float32))
    tss.selective_scan_heads(xh[:, :, :2].abs(), xh, -xh[0, 0, :2].abs(),
                             xh, xh)
    tss.selective_scan_bwd(q, q, -q[0].abs().T, q[:, :, :2], q[:, :, :2],
                           None, q)
    tss.selective_scan_heads_bwd(xh[:, :, :2].abs(), xh, -xh[0, 0, :2].abs(),
                                 xh, xh, None, xh)
    x = _t(rng.standard_normal((1, 2, 3, 64)).astype(np.float32))
    tfa.flash_attention(x, x, x, causal=False)
    out, lse = tfa.flash_attention_fwd(x, x, x, causal=False)
    tfa.flash_attention_bwd(x, x, x, out, lse, x, causal=False)
    assert K.launches == {"cache_write": 0, "paged_attention": 0,
                          "paged_attention_split": 0,
                          "paged_attention_merge": 0,
                          "paged_prefill_attention": 0,
                          "paged_prefill_attention_wgmma": 0,
                          "paged_attention_latent": 0,
                          "paged_prefill_attention_latent": 0,
                          "selective_scan": 0, "selective_scan_heads": 0,
                          "selective_scan_bwd": 0,
                          "selective_scan_heads_bwd": 0,
                          "flash_attention": 0, "flash_attention_split": 0,
                          "flash_attention_merge": 0,
                          "flash_attention_wgmma": 0,
                          "flash_attention_bwd": 0}
