"""The CUDA kernels against their plain PyTorch versions on the card, at
small and odd shapes (GQA, windows, chunks that are not a multiple of the
kernel's row tile, widths that rule out 16-byte copies).  Skipped without
a card; on the machine with one: ``PYTHONPATH=src python -m pytest
tests/test_torch_cuda.py``.

Tolerances: f32 1e-4 absolute (summation order only), bf16 2e-2 absolute
(one bf16 rounding of outputs near 1, and of P before P V on the bf16
tensor-core tile); bf16 chunked prefill and flash attention are held
against the plain version's f32 output on the same (upcast) inputs, so
only the kernel's own rounding counts; the cache write is exact.  Decode rounds only its output
(no tensor cores, P stays f32; the bf16 latent-row decode at D = 576
weighs P as hi + lo bf16 parts, P to about 16 bits), so its bf16 bar is
4e-3, as in chip_smoke.py: a lane of 16+ keys averages values to well
under 1, where one rounding is at most 2^-9; a lane of one key returns
the key's value exactly.  The
selective scan (both modes) computes in f32 from the same inputs on both
sides and returns f32, so bf16 inputs keep the f32 bar of 1e-4.  Flash attention
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
from repro_torch.kernels.selective_scan.ref import (selective_scan_heads_ref,
                                                    selective_scan_ref)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _f32(*ts):
    """The same inputs upcast: the plain version then computes and returns
    f32, and the kernel's bf16 output is held against that, unrounded."""
    return [t.float() for t in ts]
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
    n_split = tpa.decode_plan(len(lens), H, Kh, D, max_pages, 16, n_sms)
    assert (n_split > 1) == split
    before = dict(K.launches)
    got = tpa.paged_attention(q, kp, vp, tables, lengths, window=window)
    want = paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    assert K.launches["paged_attention"] == before["paged_attention"] + 1
    assert K.launches["paged_attention_split"] == \
        before["paged_attention_split"] + int(split)
    assert K.launches["paged_attention_merge"] == \
        before["paged_attention_merge"]        # merged in the same launch
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
    want = paged_prefill_attention_ref(*_f32(q, kp, vp), tables, ctx_t,
                                       window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


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


def _heads_inputs(gen, dev, B, S, Hh, P, N, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen)
    dt = (rnd(B, S, Hh).abs() * 0.1).to(dev, dtype)
    return (dt, rnd(B, S, Hh * P).to(dev, dtype), -rnd(Hh).abs().to(dev),
            rnd(B, S, N).to(dev, dtype), rnd(B, S, N).to(dev, dtype),
            rnd(B, Hh, P, N).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,Hh,P,with_h0", [
    (1, 37, 3, 64, True), (2, 1, 4, 32, True), (3, 70, 2, 96, False),
    (1, 512, 5, 64, True), (4, 33, 112, 64, True), (8, 1, 112, 64, True)])
def test_selective_scan_heads_kernel_matches_plain(cuda, dtype, B, S, Hh, P,
                                                   with_h0):
    gen = torch.Generator().manual_seed(B * 1000 + S + Hh + P)
    dt, x, A, Bm, Cm, h0 = _heads_inputs(gen, cuda, B, S, Hh, P, 64, dtype)
    h0 = h0 if with_h0 else None
    before = K.launches["selective_scan_heads"]
    y, h = tss.selective_scan_heads(dt, x, A, Bm, Cm, h0)
    y_ref, h_ref = selective_scan_heads_ref(dt, x, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    assert K.launches["selective_scan_heads"] == before + 1
    assert y.dtype == h.dtype == torch.float32
    assert tuple(h.shape) == (B, Hh, P, 64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert (y - y_ref).abs().max().item() <= 1e-4
    assert (h - h_ref).abs().max().item() <= 1e-4


def test_selective_scan_heads_zero_dt_freezes_state(cuda):
    gen = torch.Generator().manual_seed(6)
    dt, x, A, Bm, Cm, h0 = _heads_inputs(gen, cuda, 2, 80, 4, 64, 64,
                                         torch.bfloat16)
    _, h_head = tss.selective_scan_heads(
        dt[:, :45].contiguous(), x[:, :45].contiguous(), A,
        Bm[:, :45].contiguous(), Cm[:, :45].contiguous(), h0)
    dt[:, 45:] = 0
    _, h = tss.selective_scan_heads(dt, x, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    assert torch.equal(h, h_head)


@pytest.mark.parametrize("N,P", [(16, 64), (64, 48)])
def test_selective_scan_heads_rejects_unbuilt_shapes(cuda, N, P):
    gen = torch.Generator().manual_seed(N + P)
    ins = _heads_inputs(gen, cuda, 1, 4, 2, P, N, torch.float32)
    with pytest.raises(ValueError, match="N=|P="):
        tss.selective_scan_heads(*ins)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_paged_kernels_at_zamba2_attention_shape(cuda, dtype, kind):
    """zamba2-7b's shared attention: H = Kh = 32 (G = 1), D = 112, held
    against the plain version's f32 output on the same inputs."""
    gen = torch.Generator().manual_seed(112)
    H = Kh = 32
    D, C, ctx = 112, 37, [0, 13, 60, 200]
    lens = [1, 17, 100, 256] if kind == "decode" else [c + C for c in ctx]
    kp, vp, tables = _pages(gen, cuda, lens=lens, Kh=Kh, D=D, dtype=dtype,
                            n_pages=2 * 17 * len(lens) + 1, max_pages=17)
    name = "paged_attention" if kind == "decode" \
        else "paged_prefill_attention"
    before = K.launches[name]
    if kind == "decode":
        q = torch.randn((len(lens), H, D), generator=gen).to(cuda, dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got = tpa.paged_attention(q, kp, vp, tables, lengths)
        want = paged_attention_ref(*_f32(q, kp, vp), tables, lengths)
        tol = DECODE_TOL[dtype]
    else:
        q = torch.randn((len(ctx), C, H, D), generator=gen).to(cuda, dtype)
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device=cuda)
        got = tpa.paged_prefill_attention(q, kp, vp, tables, ctx_t)
        want = paged_prefill_attention_ref(*_f32(q, kp, vp), tables, ctx_t)
        tol = TOL[dtype]
    torch.cuda.synchronize()
    assert K.launches[name] == before + 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= tol


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
    want = flash_attention_ref(*_f32(q, k, v), causal=causal, window=window,
                               kv_offset=off)
    torch.cuda.synchronize()
    assert K.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


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
    want = paged_prefill_attention_ref(*_f32(q, kp, vp), tables, ctx_t,
                                       window=window)
    torch.cuda.synchronize()
    assert K.launches["paged_prefill_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


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
    _, n_split = tfa.split_plan(B, H, Sq, Sk, D, 0)
    split = dtype == torch.bfloat16 and n_split > 1
    before = dict(K.launches)
    got = tfa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(*_f32(q, k, v), **kw)
    torch.cuda.synchronize()
    assert K.launches["flash_attention"] == before["flash_attention"] + 1
    assert K.launches["flash_attention_split"] == \
        before["flash_attention_split"] + int(split)
    assert K.launches["flash_attention_merge"] == \
        before["flash_attention_merge"]        # merged in the same launch
    assert dtype == torch.float32 or n_split > 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= TOL[dtype]
    if off < 0:                       # rows before the first key: exactly 0
        assert not got[:, :, :-off].any()


@pytest.mark.parametrize("Sq,causal,window,off", [(1, False, 0, 0),
                                                  (40, True, 30, 300),
                                                  (9, True, 0, -4)])
def test_flash_split_and_merge_kernels_match_their_plain_versions(
        cuda, Sq, causal, window, off):
    """The split path through flash_attention (the split kernel, merging
    in its last blocks) against the plain attention at the attention bar,
    and the merge kernel alone on plain partials (empty splits among them)
    against the plain merge at its own bar: each bf16 output rounded once
    (2^-8 of its value) after f32 sums in another order (1e-5 at outputs
    up to ~4)."""
    gen = torch.Generator().manual_seed(Sq + window)
    B, H, Sk, D = 2, 3, 1000, 64
    q, k, v = (torch.randn(s, generator=gen).to(cuda, torch.bfloat16)
               for s in ((B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D)))
    kw = dict(causal=causal, window=window, kv_offset=off)
    _, n_split = tfa.split_plan(B, H, Sq, Sk, D, 0)
    assert n_split > 1
    before = dict(K.launches)
    got = tfa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(*_f32(q, k, v), **kw)
    torch.cuda.synchronize()
    assert K.launches["flash_attention_split"] == \
        before["flash_attention_split"] + 1
    assert K.launches["flash_attention_merge"] == \
        before["flash_attention_merge"]
    assert (got.float() - want).abs().max().item() <= TOL[torch.bfloat16]
    parts = flash_attention_partials_ref(q, k, v, n_split, **kw)
    out = torch.empty((B, H, Sq, D), dtype=torch.bfloat16, device=cuda)
    tfa.merge_partials(*parts, out)
    torch.cuda.synchronize()
    assert K.launches["flash_attention_merge"] == \
        before["flash_attention_merge"] + 1
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
    assert tfa.split_plan(B, H, Sq, Sk, D, 0)[0] == 64
    gen = torch.Generator().manual_seed(Sq + Sk)
    q = torch.randn((B, H, Sq, D), generator=gen).to(cuda, dtype)
    k = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, dtype)
    v = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, dtype)
    kw = dict(causal=causal, window=window, kv_offset=off)
    got = tfa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(*_f32(q, k, v), **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


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


# ---------------------------------------------------------------------------
# the cache write from separate K/V planes, the scratch block untouched
# ---------------------------------------------------------------------------
def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("C", [1, 9], ids=["token", "chunk"])
@pytest.mark.parametrize("src,dst,w,NB,form", [
    (torch.bfloat16, torch.bfloat16, 4096, 512, "planes"),  # pool > 2^31
    (torch.bfloat16, torch.bfloat16, 768, 40, "strided"),   # whisper's width
    (torch.float32, torch.bfloat16, 64, 10, "planes"),      # casts
    (torch.bfloat16, torch.float32, 64, 10, "strided"),
    (torch.float32, torch.float32, 37, 10, "planes"),       # no 16-byte rows
    (torch.float32, torch.float32, 64, 10, "stacked"),
], ids=["bf16-w4096-big", "bf16-w768-strided", "f32-to-bf16",
        "bf16-to-f32-strided", "f32-w37", "f32-stacked"])
def test_cache_write_from_planes_leaves_scratch_untouched(cuda, C, src, dst,
                                                          w, NB, form):
    """K and V as separate planes (or column slices of one wider buffer,
    or one stacked tensor) into the last layer of a pool with a scratch
    block: every row not aimed at scratch bit-exact against the plain
    version (which writes the scratch rows too), and the scratch block
    byte for byte as it was.  Lane 6 has padded positions, lane 7 is a
    padded lane.  The first case's pool holds more than 2^31 elements."""
    gen = torch.Generator(device=cuda).manual_seed(w + C)
    T, bs, B = 2, 16, 8
    L = 32 if NB == 512 else 3
    data = torch.empty((T, L, NB + 1, bs, w), dtype=dst,
                       device=cuda).normal_(generator=gen)
    assert NB != 512 or data.numel() > 2 ** 31
    rows = torch.randn((T, B, C, w), generator=gen, device=cuda).to(src)
    if form == "stacked":
        planes = rows
    elif form == "planes":
        planes = tuple(r.clone() for r in rows)
    else:
        wide = torch.zeros((B, C, 3 * w), dtype=src, device=cuda)
        for t in range(T):
            wide[..., t * w:(t + 1) * w] = rows[t]
        planes = tuple(wide[..., t * w:(t + 1) * w] for t in range(T))
    scratch = NB * bs
    perm = torch.randperm(NB * bs, generator=gen, device=cuda)
    slots = perm[:B * C].view(B, C).to(torch.int32)
    slots[6, C // 2 + (C == 1):] = scratch + 3
    slots[7] = scratch
    before = data.clone()
    before_launches = K.launches["cache_write"]
    if C == 1:
        src_rows = planes[:, :, 0] if form == "stacked" else \
            tuple(p[:, 0] for p in planes)
        tcw.paged_token_write(data, L - 1, src_rows, slots[:, 0],
                              scratch=scratch)
    else:
        tcw.paged_chunk_write(data, L - 1, planes, slots, scratch=scratch)
    want = before.clone()
    plane = (torch.arange(T, device=cuda) * L + L - 1) * ((NB + 1) * bs)
    cache_write_ref(want.view(-1, bs, w), rows.reshape(-1, w),
                    (plane[:, None] + slots.reshape(-1)[None].long())
                    .reshape(-1))
    torch.cuda.synchronize()
    assert K.launches["cache_write"] == before_launches + 1
    assert torch.equal(_bytes(data[:, :, :NB]), _bytes(want[:, :, :NB]))
    assert torch.equal(_bytes(data[:, :, NB]), _bytes(before[:, :, NB]))
    assert not torch.equal(_bytes(data), _bytes(before))


def test_cache_write_without_scratch_writes_every_row(cuda):
    """No scratch named (the flat write, the install of a media entry):
    rows aimed at the last block are written like any other."""
    gen = torch.Generator().manual_seed(21)
    T, L, NB, bs, w = 2, 2, 6, 4, 64
    data = torch.randn((T, L, NB + 1, bs, w), generator=gen).to(cuda)
    k, v = (torch.randn((3, w), generator=gen).to(cuda) for _ in range(2))
    slots = torch.tensor([NB * bs, NB * bs + 3, 5], dtype=torch.int32,
                         device=cuda)
    want = data.cpu()                    # the plain version on the CPU
    tcw.paged_token_write(want, 1, (k.cpu(), v.cpu()), slots.cpu())
    tcw.paged_token_write(data, 1, (k, v), slots)
    torch.cuda.synchronize()
    assert torch.equal(data.cpu(), want)


# ---------------------------------------------------------------------------
# the split-KV merge fused into the split kernels' last blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("n_split", [2, 3, 7, 16])
def test_decode_fused_merge_at_forced_splits(cuda, monkeypatch, dtype,
                                             window, n_split):
    """Decode at split counts the plan would not pick, over 16 table
    columns: lanes of 1, 17, 100 and 256 keys (the later splits of short
    lanes see no key; with a window the earlier ones see none either), GQA
    of 8 query heads on 2 KV heads, and a padded lane."""
    monkeypatch.setattr(tpa, "decode_plan", lambda *a: n_split)
    lens = [1, 17, 100, 256, 1]
    gen = torch.Generator().manual_seed(n_split * 10 + window)
    kp, vp, tables = _pages(gen, cuda, lens=lens[:4], Kh=2, D=64,
                            dtype=dtype, n_pages=70, max_pages=16)
    tables = torch.cat([tables, torch.full_like(tables[:1], 69)])
    q = torch.randn((5, 8, 64), generator=gen).to(cuda, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = dict(K.launches)
    got = tpa.paged_attention(q, kp, vp, tables, lengths, window=window)
    want = paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    assert K.launches["paged_attention_split"] == \
        before["paged_attention_split"] + 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= \
        DECODE_TOL[dtype]


@pytest.mark.parametrize("n_split", [2, 5, 24, 30])
@pytest.mark.parametrize("Sq,causal,window,off", [
    (1, False, 0, 0), (16, True, 100, 1400), (40, True, 30, 300),
    (9, True, 0, -4)], ids=["row", "window-tail", "chunk", "no-key-rows"])
def test_flash_fused_merge_at_forced_splits(cuda, monkeypatch, n_split, Sq,
                                            causal, window, off):
    """bf16 flash attention at split counts the plan would not pick over
    1500 keys (24 tiles; 30 splits leave six ranges with no tile), GQA of
    4 query heads on 2 KV heads: windows leave most splits without a key,
    and rows before the first key come out 0."""
    monkeypatch.setattr(tfa, "plan", lambda B, H, Sq, Sk, n, per_sm: (
        16 if Sq <= 16 else 64, n_split))
    gen = torch.Generator().manual_seed(n_split + Sq)
    B, H, Kh, Sk, D = 2, 4, 2, 1500, 64
    q = torch.randn((B, H, Sq, D), generator=gen).to(cuda, torch.bfloat16)
    k = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, torch.bfloat16)
    v = torch.randn((B, Kh, Sk, D), generator=gen).to(cuda, torch.bfloat16)
    kw = dict(causal=causal, window=window, kv_offset=off)
    before = dict(K.launches)
    got = tfa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(*_f32(q, k, v), **kw)
    torch.cuda.synchronize()
    assert K.launches["flash_attention_split"] == \
        before["flash_attention_split"] + 1
    assert K.launches["flash_attention_merge"] == \
        before["flash_attention_merge"]
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= TOL[torch.bfloat16]
    if off < 0:
        assert not got[:, :, :-off].any()


def _split_call(kind, dev, seed):
    """A decode or flash call the plan splits, as a closure."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "decode":
        kp, vp, tables = _pages(gen, dev, lens=[100, 256], Kh=4, D=128,
                                n_pages=40, max_pages=16,
                                dtype=torch.bfloat16)
        q = torch.randn((2, 4, 128), generator=gen).to(dev, torch.bfloat16)
        lengths = torch.tensor([100, 256], dtype=torch.int32, device=dev)
        return (lambda: tpa.paged_attention(q, kp, vp, tables, lengths),
                lambda: paged_attention_ref(q, kp, vp, tables, lengths),
                "paged_attention_split")
    q, k, v = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
               for s in ((2, 3, 1, 64), (2, 3, 1000, 64), (2, 3, 1000, 64)))
    return (lambda: tfa.flash_attention(q, k, v, causal=False),
            lambda: flash_attention_ref(*_f32(q, k, v), causal=False),
            "flash_attention_split")


@pytest.mark.parametrize("kind", ["decode", "flash"])
def test_fused_merge_repeats_and_replays_identically(cuda, kind):
    """A split call twice, then replayed twice from one CUDA graph: the
    same bits every time, so every call leaves its tile counters at 0
    (a counter left over would make a later call merge early or never)."""
    call, _, key = _split_call(kind, cuda, 31)
    before = K.launches[key]
    first, second = call(), call()
    torch.cuda.synchronize()
    assert K.launches[key] == before + 2
    assert torch.equal(first, second)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(out.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(r, first) for r in replays)
    assert torch.equal(call(), first)


@pytest.mark.parametrize("kind", ["decode", "flash"])
def test_split_calls_on_two_streams_keep_their_own_counters(cuda, kind):
    """Split calls issued on two streams at once, each on its own inputs:
    each stream has its own counter buffer, and both answers are right."""
    calls = [_split_call(kind, cuda, 40 + i) for i in range(2)]
    streams = [torch.cuda.Stream() for _ in calls]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for s, (call, _, _) in zip(streams, calls):
        with torch.cuda.stream(s):
            outs.append([call() for _ in range(8)])
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    dev = torch.cuda.current_device()
    buffers = {K._counters[(dev, s.cuda_stream)][1].data_ptr()
               for s in streams}
    assert len(buffers) == 2
    for (_, plain, _), got in zip(calls, outs):
        want = plain().float()
        for o in got:
            assert (o.float() - want).abs().max().item() <= \
                TOL[torch.bfloat16]


@pytest.mark.parametrize("kind", ["decode", "flash"])
def test_graphs_from_one_capture_stream_replay_at_once(cuda, kind):
    """Two graphs captured one after the other on torch's default capture
    stream, each over its own inputs, then replayed on two streams at
    once, several times: each capture made its own counters, so both
    answers stay right and every replay gives the same bits."""
    calls = [_split_call(kind, cuda, 50 + i) for i in range(2)]
    graphs, outs = [], []
    for call, _, _ in calls:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(call())
        graphs.append(graph)
    wants = [plain().float() for _, plain, _ in calls]
    streams = [torch.cuda.Stream() for _ in graphs]
    firsts = None
    for _ in range(4):
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        for s, g in zip(streams, graphs):
            with torch.cuda.stream(s):
                g.replay()
        for s in streams:
            torch.cuda.current_stream().wait_stream(s)
        got = [o.clone() for o in outs]
        torch.cuda.synchronize()
        for o, want in zip(got, wants):
            assert (o.float() - want).abs().max().item() <= \
                TOL[torch.bfloat16]
        firsts = firsts or got
        assert all(torch.equal(a, b) for a, b in zip(got, firsts))


def test_tile_counters_grow_zero_and_keep_per_stream(cuda):
    """A stream's counter buffer is zero when made and is replaced by a
    larger zero buffer when a call needs more tiles than it holds; a
    buffer large enough is kept."""
    side = torch.cuda.Stream()
    t = torch.empty(1, device=cuda)
    with torch.cuda.stream(side):
        first = K.tile_counters(t, side.cuda_stream, 10, "paged_attention")
        assert K.tile_counters(t, side.cuda_stream, 100,
                               "paged_attention") == first
        grown = K.tile_counters(t, side.cuda_stream, 10_000,
                                "flash_attention")
        buf = K._counters[(torch.cuda.current_device(), side.cuda_stream)][1]
    torch.cuda.synchronize()
    assert buf.data_ptr() == grown and buf.numel() >= 10_000
    assert not buf.any()


# ---------------------------------------------------------------------------
# MLA's latent rows (R + rope wide: 80 reduced, 576 at DeepSeek-V2's width,
# and 112) read as 1-KV-head attention with K and V the same pages, at G = 4
# (the reduced model) and G = 128 (full width)
# ---------------------------------------------------------------------------
LATENT_DIMS = [80, 112, 576]


def _latent(gen, dev, lens, D, G, dtype, C=1, max_pages=48):
    kp, _, tables = _pages(gen, dev, lens=lens, Kh=1, D=D, dtype=dtype,
                           n_pages=len(lens) * max_pages + 1,
                           max_pages=max_pages)
    shape = (len(lens), G, D) if C == 1 else (len(lens), C, G, D)
    return kp, tables, torch.randn(shape, generator=gen).to(dev, dtype)


def _latent_counter(dtype, D, prefill=False):
    """The launch counter of the kernel a latent call at (dtype, D) takes:
    bf16 at D = 576 runs on csrc/attn_latent.cuh."""
    name = "paged_prefill_attention" if prefill else "paged_attention"
    latent = dtype == torch.bfloat16 and D == tpa.LATENT_D
    return name + "_latent" if latent else name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", LATENT_DIMS)
@pytest.mark.parametrize("G", [4, 128])
def test_decode_latent_head_dims_match_plain(cuda, dtype, D, G):
    gen = torch.Generator().manual_seed(D + G)
    lens = [1, 17, 200, 650]
    kp, tables, q = _latent(gen, cuda, lens, D, G, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    counter = _latent_counter(dtype, D)
    before = K.launches[counter]
    got = tpa.paged_attention(q, kp, kp, tables, lengths)
    want = paged_attention_ref(q, kp, kp, tables, lengths)
    torch.cuda.synchronize()
    assert K.launches[counter] == before + 1
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= \
        DECODE_TOL[dtype]


def test_decode_latent_576_replays_in_a_cuda_graph(cuda):
    """The latent decode captured in a CUDA graph, in splits: replays read
    the lengths on the device and count no launch on the host; a request
    tile's splits merge in their cluster, with no counter to leave set."""
    gen = torch.Generator().manual_seed(576)
    kp, tables, q = _latent(gen, cuda, [300, 650], 576, 128, torch.bfloat16)
    lengths = torch.tensor([300, 650], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_attention(q, kp, kp, tables, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_attention(q, kp, kp, tables, lengths)
    counted = K.launches["paged_attention_latent"]
    lengths.copy_(torch.tensor([650, 41], dtype=torch.int32))
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert K.launches["paged_attention_latent"] == counted
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tpa.latent_decode_plan(2, 128, tables.shape[1], 16, n_sms)[0] > 1
    want = paged_attention_ref(q, kp, kp, tables, lengths)
    assert (out.float() - want.float()).abs().max().item() <= \
        DECODE_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", LATENT_DIMS)
@pytest.mark.parametrize("G,C", [(4, 37), (128, 21)])
def test_prefill_latent_head_dims_match_plain(cuda, dtype, D, G, C):
    gen = torch.Generator().manual_seed(D + G + C)
    ctx = [0, 13, 60]
    kp, tables, q = _latent(gen, cuda, [c + C for c in ctx], D, G, dtype,
                            C=C, max_pages=8)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    counter = _latent_counter(dtype, D, prefill=True)
    before = K.launches[counter]
    got = tpa.paged_prefill_attention(q, kp, kp, tables, ctx_t)
    want = paged_prefill_attention_ref(*_f32(q, kp, kp), tables, ctx_t)
    torch.cuda.synchronize()
    assert K.launches[counter] == before + 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


# MLA at DeepSeek-V2's full width on the latent kernels: D = 576, G = 128,
# one KV head, K = V.  Decode lengths that are not whole pages, one lane of
# 4096 keys, batches that split (1, 8) and one that barely does (33).
LATENT_DECODE_LENS = {
    1: [4096],
    8: [600, 615, 631, 648, 656, 671, 689, 700],
    33: [1 + 37 * i for i in range(32)] + [4096],
}


@pytest.mark.parametrize("B", sorted(LATENT_DECODE_LENS))
def test_latent_decode_matches_plain(cuda, B):
    gen = torch.Generator().manual_seed(B)
    lens = LATENT_DECODE_LENS[B]
    P = 256
    kp, tables, q = _latent(gen, cuda, lens, 576, 128, torch.bfloat16,
                            max_pages=P)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = dict(K.launches)
    got = tpa.paged_attention(q, kp, kp, tables, lengths)
    want = paged_attention_ref(*_f32(q, kp, kp), tables, lengths)
    torch.cuda.synchronize()
    assert K.launches["paged_attention_latent"] == \
        before["paged_attention_latent"] + 1
    assert all(K.launches[n] == before[n] for n in before
               if n != "paged_attention_latent")
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= \
        DECODE_TOL[torch.bfloat16]


# (ctx, C, G): a first chunk, later chunks and a padded lane (None: ctx 0
# over scratch pages); C * G not a multiple of the 64-row tile at G = 4
@pytest.mark.parametrize("ctx,C,G", [([0, 13, 60, None], 37, 4),
                                     ([0, 13, 60, None], 21, 128),
                                     ([0, 200, 450], 64, 128)])
def test_latent_prefill_matches_plain(cuda, ctx, C, G):
    gen = torch.Generator().manual_seed(C + G)
    lens = [C if c is None else c + C for c in ctx]
    kp, tables, q = _latent(gen, cuda, lens, 576, G, torch.bfloat16, C=C,
                            max_pages=36)
    if None in ctx:                      # the padded lane reads scratch only
        tables[ctx.index(None)] = kp.shape[0] - 1
    ctx_t = torch.tensor([c or 0 for c in ctx], dtype=torch.int32,
                         device=cuda)
    before = K.launches["paged_prefill_attention_latent"]
    got = tpa.paged_prefill_attention(q, kp, kp, tables, ctx_t)
    want = paged_prefill_attention_ref(*_f32(q, kp, kp), tables, ctx_t)
    torch.cuda.synchronize()
    assert K.launches["paged_prefill_attention_latent"] == before + 1
    assert torch.isfinite(got.float()).all()
    valid = [b for b, c in enumerate(ctx) if c is not None]
    assert (got[valid].float() - want[valid]).abs().max().item() <= \
        TOL[torch.bfloat16]


@pytest.mark.parametrize("case", ["distinct-kv", "kh2", "window"])
def test_latent_shapes_it_does_not_take_raise(cuda, case):
    """bf16 at D = 576 runs on the latent kernels only: distinct K and V
    pages, more than one KV head or a window raise, naming the reason,
    and nothing launches."""
    gen = torch.Generator().manual_seed(7)
    Kh = 2 if case == "kh2" else 1
    kp, vp, tables = _pages(gen, cuda, lens=[40, 70], Kh=Kh, D=576,
                            dtype=torch.bfloat16, max_pages=8)
    vp = vp if case == "distinct-kv" else kp
    q = torch.randn((2, 8, 576), generator=gen).to(cuda, torch.bfloat16)
    lengths = torch.tensor([40, 70], dtype=torch.int32, device=cuda)
    window = 16 if case == "window" else 0
    match = {"distinct-kv": "same pages", "kh2": "one KV head",
             "window": "no window"}[case]
    before = dict(K.launches)
    with pytest.raises(ValueError, match=match):
        tpa.paged_attention(q, kp, vp, tables, lengths, window=window)
    with pytest.raises(ValueError, match=match):
        tpa.paged_prefill_attention(q[:, None], kp, vp, tables, lengths - 1,
                                    window=window)
    assert K.launches == before


@pytest.mark.parametrize("D", [48, 96, 512, 640])
def test_unbuilt_head_dims_raise_on_the_card(cuda, D):
    """Decode and bf16 prefill raise for a head dim they are not built for
    (never a silent route to the plain version)."""
    gen = torch.Generator().manual_seed(D)
    kp, tables, q = _latent(gen, cuda, [20], D, 4, torch.bfloat16,
                            max_pages=4)
    lengths = torch.tensor([20], dtype=torch.int32, device=cuda)
    before = dict(K.launches)
    with pytest.raises(ValueError, match="head dims"):
        tpa.paged_attention(q, kp, kp, tables, lengths)
    with pytest.raises(ValueError, match="head dims"):
        tpa.paged_prefill_attention(q[:, None], kp, kp, tables, lengths - 1)
    assert K.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cache_write_latent_576_single_plane(cuda, dtype):
    """One plane of 576-wide rows (1,152 bytes in bf16: not a whole number
    of the kernel's 1 KB pieces), one token per lane: every row not aimed at
    scratch bit-exact, the scratch block byte for byte untouched."""
    gen = torch.Generator(device=cuda).manual_seed(576)
    L, NB, bs, B, w = 3, 40, 16, 8, 576
    data = torch.empty((1, L, NB + 1, bs, w), dtype=dtype,
                       device=cuda).normal_(generator=gen)
    rows = torch.randn((1, B, w), generator=gen, device=cuda).to(dtype)
    scratch = NB * bs
    slots = torch.randperm(NB * bs, generator=gen, device=cuda)[:B] \
        .to(torch.int32)
    slots[7] = scratch + 5                   # a padded lane
    before = data.clone()
    launches = K.launches["cache_write"]
    tcw.paged_token_write(data, 1, rows, slots, scratch=scratch)
    want = before.clone()
    cache_write_ref(want.view(-1, bs, w), rows.reshape(-1, w),
                    (NB + 1) * bs + slots.long())
    torch.cuda.synchronize()
    assert K.launches["cache_write"] == launches + 1
    assert torch.equal(_bytes(data[:, :, :NB]), _bytes(want[:, :, :NB]))
    assert torch.equal(_bytes(data[:, :, NB]), _bytes(before[:, :, NB]))
