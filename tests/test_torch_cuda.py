"""The CUDA kernels against their plain PyTorch versions on the card, at
small and odd shapes (GQA, windows, chunks that are not a multiple of the
kernel's row tile, widths that rule out 16-byte copies).  Skipped without
a card; on the machine with one: ``PYTHONPATH=src python -m pytest
tests/test_torch_cuda.py``.

Tolerances: f32 1e-4 absolute (summation order only), bf16 2e-2 absolute
(one bf16 rounding of outputs near 1, and of P before P V on the bf16
tensor-core tile); the cache write is exact.  Decode rounds only its output
(no tensor cores, P stays f32), so its bf16 bar is 4e-3, as in
chip_smoke.py: a lane of 16+ keys averages values to well under 1, where
one rounding is at most 2^-9; a lane of one key returns the key's value
exactly.  The
selective scan computes in f32 from the same inputs on both sides and
returns f32, so bf16 inputs keep the f32 bar of 1e-4.  Flash attention
keeps the attention bars (f32 1e-4, bf16 2e-2).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.cache_write import ops as tcw
from repro_torch.kernels.cache_write.ref import cache_write_ref
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_partials_ref, flash_attention_ref, merge_partials_ref)
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_ref)
from repro_torch.kernels.selective_scan import ops as tss
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DECODE_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pages(gen, dev, *, lens, Kh, D, page=16, n_pages=64, max_pages=8,
           dtype=torch.float32):
    scratch = n_pages - 1
    kp = torch.randn((n_pages, page, Kh, D), generator=gen).to(dev, dtype)
    vp = torch.randn((n_pages, page, Kh, D), generator=gen).to(dev, dtype)
    tables = np.full((len(lens), max_pages), scratch, np.int32)
    order = list(np.random.default_rng(0).permutation(scratch))
    for b, n in enumerate(lens):
        for j in range(-(-n // page)):
            tables[b, j] = order.pop()
    return kp, vp, torch.from_numpy(tables).to(dev)


# (lengths, max_pages, n_split > 1): lengths that end mid-page (17, 33,
# 100, 201) and at a page edge (16, 48, 64, 256); with 4 table columns
# (64 keys) the plan never splits, with 16 or 64 it does, and the B = 1
# lane leaves most of its 64 columns' splits past its length
DECODE_LENS = [([1, 16, 33, 64], 4, False),
               ([1, 17, 48, 100, 256], 16, True),
               ([201], 64, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lens,max_pages,split", DECODE_LENS,
                         ids=["short", "long", "b1"])
@pytest.mark.parametrize("H,Kh,D,window", [(4, 4, 64, 0), (8, 2, 64, 0),
                                           (4, 4, 128, 20), (6, 3, 32, 7),
                                           (16, 2, 128, 40), (12, 12, 64, 0),
                                           (4, 4, 256, 0)])
def test_decode_kernel_matches_plain(cuda, dtype, lens, max_pages, split, H,
                                     Kh, D, window):
    gen = torch.Generator().manual_seed(H * 100 + D + window + max_pages)
    kp, vp, tables = _pages(gen, cuda, lens=lens, Kh=Kh, D=D, dtype=dtype,
                            n_pages=2 * max_pages * len(lens) + 1,
                            max_pages=max_pages)
    q = torch.randn((len(lens), H, D), generator=gen).to(cuda, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_split = tpa.decode_plan(len(lens), H, Kh, max_pages, 16, n_sms)
    assert (n_split > 1) == split
    before = dict(K.launches)
    got = tpa.paged_attention(q, kp, vp, tables, lengths, window=window)
    want = paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    assert K.launches["paged_attention"] == before["paged_attention"] + 1
    assert K.launches["paged_attention_merge"] == \
        before["paged_attention_merge"] + int(split)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= \
        DECODE_TOL[dtype]


def test_decode_kernel_replays_in_a_cuda_graph(cuda):
    """The decode call reads no device value on the host: it captures in a
    CUDA graph, and a replay after the lengths change on the device gives
    the new lengths' answer."""
    gen = torch.Generator().manual_seed(11)
    kp, vp, tables = _pages(gen, cuda, lens=[100, 256], Kh=4, D=128,
                            n_pages=40, max_pages=16, dtype=torch.bfloat16)
    q = torch.randn((2, 4, 128), generator=gen).to(cuda, torch.bfloat16)
    lengths = torch.tensor([100, 256], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_attention(q, kp, vp, tables, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_attention(q, kp, vp, tables, lengths)
    lengths.copy_(torch.tensor([37, 200], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    want = paged_attention_ref(q, kp, vp, tables, lengths)
    assert (out.float() - want.float()).abs().max().item() <= \
        DECODE_TOL[torch.bfloat16]


def test_decode_rejects_other_head_dims(cuda):
    gen = torch.Generator().manual_seed(9)
    kp, vp, tables = _pages(gen, cuda, lens=[20], Kh=2, D=48)
    q = torch.randn((1, 2, 48), generator=gen).to(cuda)
    lengths = torch.tensor([20], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tpa.paged_attention(q, kp, vp, tables, lengths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Kh,C,window", [(4, 4, 37, 0), (8, 2, 21, 0),
                                           (4, 4, 50, 24), (6, 3, 1, 0)])
def test_prefill_kernel_matches_plain(cuda, dtype, H, Kh, C, window):
    gen = torch.Generator().manual_seed(H * 100 + C + window)
    D = 64
    ctx = [0, 13, 60]
    kp, vp, tables = _pages(gen, cuda, lens=[c + C for c in ctx], Kh=Kh, D=D,
                            dtype=dtype)
    q = torch.randn((len(ctx), C, H, D), generator=gen).to(cuda, dtype)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    got = tpa.paged_prefill_attention(q, kp, vp, tables, ctx_t, window=window)
    want = paged_prefill_attention_ref(q, kp, vp, tables, ctx_t,
                                       window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("src,dst,w", [
    (torch.float32, torch.float32, 64), (torch.bfloat16, torch.bfloat16, 64),
    (torch.float32, torch.bfloat16, 64), (torch.float32, torch.float32, 37)])
def test_cache_write_kernel_matches_plain(cuda, src, dst, w):
    gen = torch.Generator().manual_seed(w)
    T, L, NB, bs, B, C, layer = 2, 3, 10, 4, 3, 5, 2
    data = torch.randn((T, L, NB + 1, bs, w), generator=gen).to(cuda, dst)
    rows = torch.randn((T, B, C, w), generator=gen).to(cuda, src)
    slots = torch.from_numpy(np.random.default_rng(w).permutation(NB * bs)
                             [:B * C].reshape(B, C).astype(np.int32))
    slots = slots.to(cuda)
    got = tcw.paged_chunk_write(data.clone(), layer, rows, slots)
    want = data.clone()
    plane = (torch.arange(T, device=cuda) * L + layer) * ((NB + 1) * bs)
    cache_write_ref(want.view(-1, bs, w), rows.reshape(-1, w),
                    (plane[:, None] + slots.reshape(-1)[None].long())
                    .reshape(-1))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _scan_inputs(gen, dev, B, S, d, N, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen)
    dt = (rnd(B, S, d).abs() * 0.1).to(dev, dtype)
    A = -rnd(d, N).abs().to(dev)
    return (dt, rnd(B, S, d).to(dev, dtype), A, rnd(B, S, N).to(dev, dtype),
            rnd(B, S, N).to(dev, dtype), rnd(B, d, N).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,d,N,with_h0", [
    (1, 37, 100, 16, True), (3, 70, 64, 8, False), (4, 1, 257, 16, True),
    (2, 33, 64, 4, True)] + [
    (B, S, 100 if B == 1 else 257, N, S != 37)
    for N in (4, 8, 16) for S in (1, 37, 512) for B in (1, 5)])
def test_selective_scan_kernel_matches_plain(cuda, dtype, B, S, d, N,
                                             with_h0):
    gen = torch.Generator().manual_seed(B * 1000 + S + d + N)
    dt, x, A, Bm, Cm, h0 = _scan_inputs(gen, cuda, B, S, d, N, dtype)
    h0 = h0 if with_h0 else None
    before = K.launches["selective_scan"]
    y, h = tss.selective_scan(dt, x, A, Bm, Cm, h0)
    y_ref, h_ref = selective_scan_ref(dt, x, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    assert K.launches["selective_scan"] == before + 1
    assert y.dtype == h.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert (y - y_ref).abs().max().item() <= 1e-4
    assert (h - h_ref).abs().max().item() <= 1e-4


def test_selective_scan_kernel_zero_dt_freezes_state(cuda):
    gen = torch.Generator().manual_seed(5)
    dt, x, A, Bm, Cm, h0 = _scan_inputs(gen, cuda, 2, 80, 130, 16,
                                        torch.float32)
    _, h_head = tss.selective_scan(dt[:, :45].contiguous(),
                                   x[:, :45].contiguous(), A,
                                   Bm[:, :45].contiguous(),
                                   Cm[:, :45].contiguous(), h0)
    dt[:, 45:] = 0
    _, h = tss.selective_scan(dt, x, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    assert torch.equal(h, h_head)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,Kh,Sq,Sk,D,causal,window,off", [
    (2, 3, 3, 77, 1500, 64, False, 0, 0),    # odd Sk, whisper cross chunk
    (3, 4, 4, 1, 333, 64, False, 0, 0),      # a decode row
    (1, 8, 2, 130, 130, 128, True, 0, 0),    # GQA, causal
    (2, 4, 1, 200, 200, 128, True, 37, 0),   # window
    (1, 4, 2, 45, 301, 64, True, 17, 256),   # a chunk after a prefix
    (40, 4, 4, 9, 65, 64, False, 0, 0),      # many lanes: the 64-row tile
    (2, 4, 2, 600, 700, 64, True, 0, 100),   # the 32-row tile (132 SMs)
    (3, 4, 4, 300, 301, 128, True, 0, 0),    # the 16-row tile (132 SMs)
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, H, Kh, Sq, Sk,
                                              D, causal, window, off):
    gen = torch.Generator().manual_seed(B * 1000 + Sq + Sk + D)
    q = torch.randn((B, H, Sq, D), generator=gen).to(cuda, dtype)
    k = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, dtype)
    v = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, dtype)
    before = K.launches["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, window=window,
                              kv_offset=off)
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               kv_offset=off)
    torch.cuda.synchronize()
    assert K.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_flash_attention_kernel_reads_head_split_views(cuda):
    """[B, S, H, D] projections viewed as [B, H, S, D]: the kernel reads
    them through their strides and writes its output in q's layout."""
    gen = torch.Generator().manual_seed(3)
    B, S, T, H, D = 2, 50, 90, 4, 64
    q = torch.randn((B, S, H, D), generator=gen).to(cuda).transpose(1, 2)
    kv = torch.randn((B, T, 2, H, D), generator=gen).to(cuda)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    got = tfa.flash_attention(q, k, v, causal=False)
    want = flash_attention_ref(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=False)
    torch.cuda.synchronize()
    assert got.stride() == q.stride()
    assert (got - want).abs().max().item() <= TOL[torch.float32]


def test_flash_attention_kernel_rows_without_keys_are_zero(cuda):
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((1, 2, 70, 64), generator=gen).to(cuda)
    k = torch.randn((1, 2, 100, 64), generator=gen).to(cuda)
    got = tfa.flash_attention(q, k, k, causal=True, window=8, kv_offset=-20)
    torch.cuda.synchronize()
    assert not got[:, :, :20].any() and torch.isfinite(got).all()
    want = flash_attention_ref(q, k, k, causal=True, window=8, kv_offset=-20)
    assert (got - want).abs().max().item() <= TOL[torch.float32]


# ---------------------------------------------------------------------------
# the bf16 tensor-core tile (csrc/attn_mma.cuh) at its edges; f32 takes the
# CUDA-core kernels on the same cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Kh,D,C,ctx,window,page", [
    (4, 4, 128, 100, [0, 13, 70], 0, 16),    # C not a multiple of 16 or 64
    (2, 2, 256, 37, [5, 64, 90], 0, 16),     # D = 256: 32-key tiles
    (16, 4, 128, 21, [0, 50, 130], 0, 16),   # G = 4 folded into the rows
    (8, 2, 256, 9, [3, 40, 61], 0, 8),       # G = 4 at D = 256, 8-row pages
    (4, 4, 64, 50, [100, 130, 7], 40, 16),   # a window that starts mid-tile
    (4, 2, 128, 70, [33, 0, 250], 100, 32),  # chunks crossing pages and tiles
])
def test_prefill_mma_edges_match_plain(cuda, dtype, H, Kh, D, C, ctx, window,
                                       page):
    gen = torch.Generator().manual_seed(H * 1000 + D + C + window + page)
    n = max(ctx) + C
    kp, vp, tables = _pages(gen, cuda, lens=[c + C for c in ctx], Kh=Kh, D=D,
                            page=page, n_pages=3 * (-(-n // page)) + 2,
                            max_pages=-(-n // page) + 1, dtype=dtype)
    q = torch.randn((len(ctx), C, H, D), generator=gen).to(cuda, dtype)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    before = K.launches["paged_prefill_attention"]
    got = tpa.paged_prefill_attention(q, kp, vp, tables, ctx_t, window=window)
    want = paged_prefill_attention_ref(q, kp, vp, tables, ctx_t,
                                       window=window)
    torch.cuda.synchronize()
    assert K.launches["paged_prefill_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_prefill_bf16_rejects_other_head_dims(cuda):
    gen = torch.Generator().manual_seed(9)
    kp, vp, tables = _pages(gen, cuda, lens=[20], Kh=2, D=32,
                            dtype=torch.bfloat16)
    q = torch.randn((1, 4, 2, 32), generator=gen).to(cuda, torch.bfloat16)
    ctx = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tpa.paged_prefill_attention(q, kp, vp, tables, ctx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,Kh,Sq,Sk,D,causal,window,off", [
    (1, 1, 1, 1, 1500, 64, False, 0, 0),      # one row: many splits
    (1, 2, 2, 20, 700, 64, True, 8, -10),     # rows 0-9 and most splits
    #                                           see no key
    (1, 4, 2, 17, 129, 128, True, 16, 120),   # a window across split edges
])
def test_flash_split_kv_matches_plain(cuda, dtype, B, H, Kh, Sq, Sk, D,
                                      causal, window, off):
    gen = torch.Generator().manual_seed(Sq + Sk + D)
    q = torch.randn((B, H, Sq, D), generator=gen).to(cuda, dtype)
    k = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, dtype)
    v = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, dtype)
    kw = dict(causal=causal, window=window, kv_offset=off)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, n_split = tfa.plan(B, H, Sq, Sk, n_sms)
    split = dtype == torch.bfloat16 and n_split > 1
    before = dict(K.launches)
    got = tfa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K.launches["flash_attention"] == before["flash_attention"] + 1
    assert K.launches["flash_attention_merge"] == \
        before["flash_attention_merge"] + int(split)
    assert dtype == torch.float32 or n_split > 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    if off < 0:                       # rows before the first key: exactly 0
        assert not got[:, :, :-off].any()


@pytest.mark.parametrize("Sq,causal,window,off", [(1, False, 0, 0),
                                                  (40, True, 30, 300),
                                                  (9, True, 0, -4)])
def test_flash_split_and_merge_kernels_match_their_plain_versions(
        cuda, Sq, causal, window, off):
    """The split path through flash_attention (split kernel, then merge)
    against the plain attention at the attention bar, and the merge kernel
    alone on plain partials (empty splits among them) against the plain
    merge at its own bar: each bf16 output rounded once (2^-8 of its
    value) after f32 sums in another order (1e-5 at outputs up to ~4)."""
    gen = torch.Generator().manual_seed(Sq + window)
    B, H, Sk, D = 2, 3, 1000, 64
    q, k, v = (torch.randn(s, generator=gen).to(cuda, torch.bfloat16)
               for s in ((B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D)))
    kw = dict(causal=causal, window=window, kv_offset=off)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, n_split = tfa.plan(B, H, Sq, Sk, n_sms)
    assert n_split > 1
    before = K.launches["flash_attention_merge"]
    got = tfa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K.launches["flash_attention_merge"] == before + 1
    assert (got.float() - want.float()).abs().max().item() <= \
        TOL[torch.bfloat16]
    parts = flash_attention_partials_ref(q, k, v, n_split, **kw)
    out = torch.empty((B, H, Sq, D), dtype=torch.bfloat16, device=cuda)
    tfa.merge_partials(*parts, out)
    torch.cuda.synchronize()
    assert K.launches["flash_attention_merge"] == before + 2
    want = merge_partials_ref(*parts)
    assert ((out.float() - want).abs() <= want.abs() * 2 ** -8 + 1e-5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,Kh,Sq,Sk,causal,window,off", [
    (1, 4, 2, 200, 333, True, 37, 50),       # a window starting mid-tile
    (2, 3, 3, 130, 1500, False, 0, 0),       # a ragged last query tile
])
def test_flash_64_row_tiles_match_plain(cuda, dtype, B, H, Kh, Sq, Sk,
                                        causal, window, off):
    """64-row tiles of four warps, causal blocks started last tile first."""
    D = 64
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tfa.plan(B, H, Sq, Sk, n_sms)[0] == 64
    gen = torch.Generator().manual_seed(Sq + Sk)
    q = torch.randn((B, H, Sq, D), generator=gen).to(cuda, dtype)
    k = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, dtype)
    v = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, dtype)
    kw = dict(causal=causal, window=window, kv_offset=off)
    got = tfa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("kernel", ["paged_attention", "flash_attention"])
def test_merge_kernel_writes_f32(cuda, kernel):
    """The merge with an f32 output (the f32 decode split's), from either
    library that builds it, against the plain merge: f32 sums in another
    order only.  Split 1 sees no key (l = 0, m garbage) and weighs
    nothing."""
    gen = torch.Generator().manual_seed(12)
    n, B, H, D = 5, 3, 4, 128
    m = torch.randn((n, B, H), generator=gen).to(cuda) * 3
    l = torch.rand((n, B, H), generator=gen).to(cuda) * 10 + 0.1
    acc = torch.randn((n, B, H, 1, D), generator=gen).to(cuda)
    l[1] = 0
    m[1] = 1e4
    m, l = m[..., None], l[..., None]
    out = torch.empty((B, H, 1, D), device=cuda)
    before = K.launches[f"{kernel}_merge"]
    tfa.merge_partials(m, l, acc, out, kernel=kernel)
    torch.cuda.synchronize()
    assert K.launches[f"{kernel}_merge"] == before + 1
    want = merge_partials_ref(m, l, acc)
    assert (out - want).abs().max().item() <= 1e-5 * want.abs().max().item()
