#!/usr/bin/env python3
"""Device times of the cache-write, attention and selective-scan kernels
of two source trees on one card, and the accuracy cost of an approximate
scan exponential.

    python3 tools/kernel_ab.py --parent DIR

DIR holds another checkout's ``src/repro_torch`` (for example one
unpacked with ``git archive <commit> src/repro_torch | tar -x -C DIR``):
its ``csrc`` sources and its flash planner.  Both trees' ``cache_write.cu``, ``paged_attention.cu``,
``flash_attention.cu`` and ``selective_scan.cu`` are built with nvcc: the
cache write of K and V at LLaVA's image chunk and decode (B = 8, w = 4096)
and at whisper's decode (w = 768), each tree's caller path (the parent's
stacks K and V into one tensor first; this tree's reads them where they
lie and skips the scratch rows), with the stack copy and each write also
timed alone; decode and chunked-prefill paged attention, flash attention
(split calls with their merge, each tree at its own plan, then this
tree's kernel at other plans of the split shapes) and the scan at the
smoke's shapes.  Each
case is timed parent, change, change, parent (CUDA-graph replays of 20
calls, medians of 7; decode also with the 50 MB L2 flushed before each
call), so the two versions meet the same card in one process.  The
parent's entry points are those of the tree before the split kernels
merged in their own last blocks and the write took separate planes.  The last lines build the checkout's scan with ``expf``
replaced by ``ex2.approx`` of dt * A * log2 e and report both kernels'
largest error against the plain version at falcon-mamba's prefill shape,
seeds 0-2, beside the scan's bar of 1e-4.

    python3 tools/kernel_ab.py --mla --parent DIR

times only MLA's attention at full width (bf16, H = 128, Kh = 1, D =
576, K and V the same pages): the parent's paged decode (its plan) and
chunked prefill against this tree's latent-row kernels
(``csrc/attn_latent.cuh``, decode at ``latent_decode_plan``), decode at B
= 8, ctx 600-700 (warm and with L2 flushed), prefill of one 512-token
first chunk, each with its largest error against the plain version's f32
output; then this tree's decode at every split count from 1 to 8 beside
the card's cluster capacity for it (``latent_max_clusters``).  The parent is a tree whose ``paged_attention.cu`` still serves
bf16 at D = 576 through ``paged_attention`` and
``paged_prefill_attention``.

    python3 tools/kernel_ab.py --flash-bwd --parent DIR

times only flash attention's backward (``flash_attention_bwd``, bf16) of
both trees' ``flash_attention.cu`` at LLaVA-1.5-7B's training shape (B =
2, H = Kh = 32, S = 2,624, D = 128, causal), llama3-8b's GQA (B = 1, H =
32, Kh = 8, S = 2,048, causal) and whisper's encoder (B = 4, H = Kh = 12,
S = 1,500, D = 64, non-causal), parent, change, change, parent, beside
each shape's bound (the five products at the bf16 tensor-core peak) and
SDPA's backward (autograd over ``scaled_dot_product_attention``: eager,
timed with CUDA events, and its kernels' device time from torch.profiler)
on the same inputs, with each tree's largest error against the plain
version's f32 gradients.  Needs a CUDA card and
nvcc; prints one JSON object per line.

    python3 tools/kernel_ab.py --widths --parent DIR

checks that a change left the instances both trees have as they were:
flash attention's forward (bf16, with lse) at whisper's encoder (D = 64),
its split decode row and 64-row chunk, llama3's GQA and LLaVA-1.5-7B's
training shape (D = 128); its backward at LLaVA's, llama3's and whisper's
training shapes (the narrow body) and at stablelm-12b's (D = 160),
gemma3-4b's global and local (D = 256, window 1,024) and DeepSeek-V2's
MLA (D = 192, Dv = 128) (the wide body); and the bf16 chunked prefill at
each of its six widths (64, 80, 112, 128, 160, 256; a 512-row first chunk,
H = Kh = 32), both trees' C entries on the same inputs at the same plan:
whether their outputs are the same bits, and their device times parent,
change, change, parent (CUDA-graph replays, medians of 7) with the change
of the medians in percent.  A tree whose flash entries take the value
width (D, Dv) is called with Dv = D.  Then flash attention's bf16 forward
(with lse) at the wide training shapes (``chip_smoke.py``'s ``WIDTHS``:
zamba2-7b's D = 112, stablelm-12b's 160, gemma3-4b's 256 global and with
window 1,024, DeepSeek-V2's (192, 128)), each tree at its own plan (the
parent's ``plan`` loaded from its tree): device times parent, change,
change, parent, each tree's largest error against the plain version's f32
output, whether each tree repeats its own bits and whether the two trees'
outputs are the same bits.  These rows do not count toward
``all_bits_equal``: the trees' bodies there may differ by design.  The backward rows feed both trees one ``(out, lse)``, this
tree's.  Last, at each wide pair's shortest causal sequence whose 64-row
grid needs no split (B = 1), this tree's wgmma body against its mma.sync
tile unsplit (rows ``flash_fwd_threshold``).  Then bf16 chunked prefill
at the served shapes (zamba2-7b's and stablelm-12b's 512-token chunks,
LLaVA's image and text chunks, stablelm-12b's CLI 16-row chunks, and
later chunks of 16, 32 and 64 rows at each of the three widths), each
tree at its own ``prefill_plan`` (rows ``paged_prefill``, outside
``all_bits_equal``), and this tree's wgmma prefill body against its tile
at each of those shapes whose width the body is built for (rows
``paged_prefill_threshold``).

    python3 tools/kernel_ab.py --scan-bwd --parent DIR

times only the selective scan's two backward kernels (``selective_scan_bwd``
and ``selective_scan_heads_bwd``, bf16 inputs, f32 dy) of both trees'
``selective_scan.cu`` through their C entries (the same interface; the
scratch is sized for the larger of the two layouts, states saved every 8
steps over 32-channel blocks) at falcon-mamba-7b's training shape (B = 2,
S = 2,048, d = 8,192, N = 16) and zamba2-7b's widths (B = 1, S = 2,048, H
= 112, P = 64, N = 64), parent, change, change, parent: CUDA-graph
replays of 5 calls, medians of 7, and eager calls, beside each shape's
bound (``chip_smoke.py::scan_bwd_bound``), with each tree's largest error
against the plain backward's f32 gradients on the same inputs and each
backward instance's registers and resident blocks an SM.

    python3 tools/kernel_ab.py --scan-heads --parent DIR

times only the per-head scan's forward (``selective_scan_heads``, bf16
inputs, f32 state) of both trees through their C entries at zamba2-7b's
widths (H = 112, P = 64, N = 64): B = 1, 2 and 4 at S = 512, the training
shape B = 2 at S = 2,048, and decode at B = 1, 4 and 8; parent, change,
change, parent (CUDA-graph replays, medians of 7), each tree's largest
error against the plain version, whether the trees' bits are equal and
each tree repeats its own, beside the bound
(``chip_smoke.py::heads_bound``).  Last, at B = 1, S = 512 and at the
training shape, f32 and bf16 inputs on three draws each: each tree's
largest error, absolute and over the magnitude scale that
``chip_smoke.py::long_scan_check`` holds rows past 512 steps to, beside
the same reading of the plain version on TF32-rounded x, B and C (the
control that bar must catch).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ab"
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "--split-compile=0"]
_P, _I = ctypes.c_void_p, ctypes.c_int
PAGE = 16


def build(srcs: dict) -> dict:
    """{name: (source path, include dir)} -> {name: ctypes library}, all
    nvcc processes at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(NVCC + ["-I", str(inc), "-o",
                                         str(OUT / f"{n}.so"), str(src)])
             for n, (src, inc) in srcs.items()}
    for n, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for {n}")
    return {n: ctypes.CDLL(str(OUT / f"{n}.so")) for n in srcs}


def graph_ms(fn, reps: int = 20) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def alternate(parent, change, timer) -> list:
    return [timer(parent), timer(change), timer(change), timer(parent)]


def decode_ab(libs, gen, sms):
    import torch
    from repro_torch.kernels.paged_attention.ops import decode_plan
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    par, new = libs["parent_pa"].paged_attention, libs["pa"].paged_attention
    par.argtypes = [_P] * 6 + [_I] * 9 + [_P] * 2
    new.argtypes = [_P] * 6 + [_I] * 9 + [_P] * 3
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")

    def cold(fn):
        return graph_ms(lambda: (flush.zero_(), fn())) - \
            graph_ms(lambda: flush.zero_())
    # (tag, lens, H, Kh, D): LLaVA's widths at B = 8 and 4, whisper's
    # decoder, one long lane
    for tag, lens, H, Kh, D in [
            ("b8", [600, 615, 631, 648, 656, 671, 689, 700], 32, 32, 128),
            ("b4", [600, 633, 700, 1], 32, 32, 128),
            ("whisper-b4", [40, 41, 45, 48], 12, 12, 64),
            ("b1-ctx4096", [4096], 32, 32, 128)]:
        B, n_pages = len(lens), 400
        P = 1 << max(0, max(-(-n // PAGE) for n in lens) - 1).bit_length()
        kp, vp = (torch.randn((n_pages, PAGE, Kh, D), generator=gen,
                              device="cuda").bfloat16() for _ in range(2))
        perm = torch.randperm(n_pages - 1, generator=gen, device="cuda")
        tables = torch.full((B, P), n_pages - 1, dtype=torch.int32,
                            device="cuda")
        used = 0
        for b, n in enumerate(lens):
            m = -(-n // PAGE)
            tables[b, :m] = perm[used:used + m].int()
            used += m
        q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n_split = decode_plan(B, H, Kh, D, P, PAGE, sms)
        parts = torch.empty(n_split * B * H * (D + 2), device="cuda")
        outs = [torch.empty_like(q) for _ in range(2)]
        ptrs = [t.data_ptr() for t in (q, kp, vp, tables, lengths)]

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def fp():
            par(*ptrs, outs[0].data_ptr(), 1, B, H, Kh, D, PAGE, P, 0,
                n_split, parts.data_ptr(), stream())

        def fn():
            new(*ptrs, outs[1].data_ptr(), 1, B, H, Kh, D, PAGE, P, 0,
                n_split, parts.data_ptr(), counters.data_ptr(), stream())
        fp()
        fn()
        torch.cuda.synchronize()
        want = paged_attention_ref(q, kp, vp, tables, lengths).float()
        print(json.dumps({
            "decode": f"{tag}: B={B} H={H} Kh={Kh} D={D} bf16",
            "n_split": n_split,
            "max_abs_err": [(o.float() - want).abs().max().item()
                            for o in outs],
            "warm_ms": alternate(fp, fn, graph_ms),
            "cold_l2_ms": alternate(fp, fn, cold),
            "order": "parent, change, change, parent"}), flush=True)


def prefill_ab(libs, gen):
    """bf16 chunked prefill of one 1024-row image chunk (576 valid) at
    LLaVA's widths: the same entry point in both trees."""
    import torch
    fns = [libs[n].paged_prefill_attention for n in ("parent_pa", "pa")]
    for f in fns:
        f.argtypes = [_P] * 6 + [_I] * 9 + [_P]
    H = Kh = 32
    D, C, n_pages = 128, 1024, 80
    kp, vp = (torch.randn((n_pages, PAGE, Kh, D), generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    tables = torch.full((1, C // PAGE), n_pages - 1, dtype=torch.int32,
                        device="cuda")
    tables[0, :576 // PAGE] = torch.arange(576 // PAGE, dtype=torch.int32)
    q = torch.randn((1, C, H, D), generator=gen, device="cuda").bfloat16()
    ctx = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, kp, vp, tables, ctx, out)]
    calls = [lambda f=f: f(*ptrs, 1, 1, C, H, Kh, D, PAGE, C // PAGE, 0,
                           torch.cuda.current_stream().cuda_stream)
             for f in fns]
    print(json.dumps({"prefill": "image chunk: B=1 C=1024 H=Kh=32 D=128 "
                                 "bf16", "device_ms": alternate(*calls,
                                                                graph_ms),
                      "order": "parent, change, change, parent"}),
          flush=True)


def mla_ab(libs, gen, sms, parent_plan):
    """MLA's latent rows at full width (bf16, H = 128, Kh = 1, D = 576, K
    and V the same pages): the parent's paged kernels (its CUDA-core
    decode at its own plan, its chunked prefill) against this tree's
    latent-row kernels (csrc/attn_latent.cuh, decode at
    latent_decode_plan).  Decode at B = 8, ctx 600-700, warm and with L2
    flushed; one 512-token first chunk."""
    import torch
    from repro_torch.kernels.paged_attention.ops import (
        _LATENT_DECODE_ARGS, _LATENT_PREFILL_ARGS, latent_decode_plan,
        latent_max_clusters)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefill_attention_ref)
    par_dec, par_pre = (libs["parent_pa"].paged_attention,
                        libs["parent_pa"].paged_prefill_attention)
    par_dec.argtypes = [_P] * 6 + [_I] * 9 + [_P] * 3
    par_pre.argtypes = [_P] * 6 + [_I] * 9 + [_P]
    new_dec, new_pre = (libs["pa"].paged_latent_attention,
                        libs["pa"].paged_latent_prefill_attention)
    new_dec.argtypes = _LATENT_DECODE_ARGS
    new_pre.argtypes = _LATENT_PREFILL_ARGS
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def cold(fn):
        return graph_ms(lambda: (flush.zero_(), fn())) - \
            graph_ms(lambda: flush.zero_())

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def pool(lens, P, n_pages):
        kp = torch.randn((n_pages, PAGE, 1, 576), generator=gen,
                         device="cuda").bfloat16()
        perm = torch.randperm(n_pages - 1, generator=gen, device="cuda")
        tables = torch.full((len(lens), P), n_pages - 1, dtype=torch.int32,
                            device="cuda")
        used = 0
        for b, n in enumerate(lens):
            m = -(-n // PAGE)
            tables[b, :m] = perm[used:used + m].int()
            used += m
        return kp, tables

    lens = [600, 615, 631, 648, 656, 671, 689, 700]
    B, H, D, P = len(lens), 128, 576, 64
    kp, tables = pool(lens, P, 400)
    q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    p_split = parent_plan(B, H, 1, D, P, PAGE, sms)
    n_split, per = latent_decode_plan(B, H, P, PAGE, sms, functools.partial(
        latent_max_clusters, 0))
    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")
    outs = [torch.empty_like(q) for _ in range(2)]
    parts = torch.empty(p_split * B * H * (D + 2), device="cuda")
    ptrs = [t.data_ptr() for t in (q, kp, kp, tables, lengths)]

    def fp():
        par_dec(*ptrs, outs[0].data_ptr(), 1, B, H, 1, D, PAGE, P, 0,
                p_split, parts.data_ptr(), counters.data_ptr(), stream())

    def fn():
        new_dec(q.data_ptr(), kp.data_ptr(), tables.data_ptr(),
                lengths.data_ptr(), outs[1].data_ptr(), B, H, PAGE, P,
                kp.shape[0] * PAGE, n_split, per, stream())
    fp()
    fn()
    torch.cuda.synchronize()
    want = paged_attention_ref(q.float(), kp.float(), kp.float(), tables,
                               lengths)
    print(json.dumps({
        "decode": f"mla: B={B} H={H} Kh=1 D={D} ctx 600-700 bf16",
        "n_split": [p_split, n_split],
        "max_abs_err": [(o.float() - want).abs().max().item() for o in outs],
        "device_ms": alternate(fp, fn, graph_ms),
        "cold_l2_ms": alternate(fp, fn, cold),
        "order": "parent, change, change, parent"}), flush=True)

    # this tree's decode at every split count, beside the card's cluster
    # capacity for it (the plan takes the most splits whose clusters all
    # fit at once)
    sweep = {}
    for n in range(1, 9):
        per_n = -(-P // n)
        per_n += per_n % 2
        sweep[n] = {"max_clusters": latent_max_clusters(0, n),
                    "device_ms": graph_ms(lambda: new_dec(
                        q.data_ptr(), kp.data_ptr(), tables.data_ptr(),
                        lengths.data_ptr(), outs[1].data_ptr(), B, H, PAGE,
                        P, kp.shape[0] * PAGE, n, per_n, stream()))}
    print(json.dumps({"decode_splits": f"mla: B={B} H={H} (16 request x "
                      f"head-tile pairs) ctx 600-700, this tree",
                      "plan": n_split, "by_n_split": sweep}), flush=True)

    C = 512
    kp, tables = pool([C], C // PAGE, C // PAGE + 1)
    q = torch.randn((1, C, H, D), generator=gen, device="cuda").bfloat16()
    ctx = torch.zeros(1, dtype=torch.int32, device="cuda")
    outs = [torch.empty_like(q) for _ in range(2)]

    def pp():
        par_pre(q.data_ptr(), kp.data_ptr(), kp.data_ptr(), tables.data_ptr(),
                ctx.data_ptr(), outs[0].data_ptr(), 1, 1, C, H, 1, D, PAGE,
                C // PAGE, 0, stream())

    def pn():
        new_pre(q.data_ptr(), kp.data_ptr(), tables.data_ptr(),
                ctx.data_ptr(), outs[1].data_ptr(), 1, C, H, PAGE, C // PAGE,
                kp.shape[0] * PAGE, stream())
    pp()
    pn()
    torch.cuda.synchronize()
    want = paged_prefill_attention_ref(q.float(), kp.float(), kp.float(),
                                       tables, ctx)
    print(json.dumps({
        "prefill": f"mla: B=1 C={C} H={H} Kh=1 D={D} ctx 0 bf16",
        "max_abs_err": [(o.float() - want).abs().max().item() for o in outs],
        "device_ms": alternate(pp, pn, lambda f: graph_ms(f, reps=5)),
        "order": "parent, change, change, parent"}), flush=True)


def flash_ab(libs, gen, sms, parent_plan, srcs):
    """bf16 flash attention at whisper's shapes: the encoder (one split)
    and the cross-attention of a 64-row chunk and of a decode row, each
    tree at its own plan (``parent_plan``: the parent's ``plan``; the
    parent's split calls launch their merge as a second kernel).  Then
    this tree's kernel at other (rows, n_split) plans of the two split
    shapes, timed once each, to compare the planner's choice with."""
    import torch
    from repro_torch.kernels.flash_attention.ops import split_plan
    fl = flash_entries(libs, ("parent_fa", "fa"), srcs)
    par, new = fl["parent_fa"][0], fl["fa"][0]
    dims = {f: (64, 64) if fl[n][2] else (64,)
            for f, n in ((par, "parent_fa"), (new, "fa"))}
    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")
    sweep = {"cross-prefill-b4-c64": [(64, n) for n in (2, 3, 4, 6, 8, 12)],
             "cross-decode-b8": [(16, n) for n in (2, 3, 4, 6, 8, 12)]}
    for tag, B, Sq in [("enc-self-b4", 4, 1500), ("cross-prefill-b4-c64", 4,
                                                  64),
                       ("cross-decode-b8", 8, 1)]:
        H, Sk, D = 12, 1500, 64
        q = torch.randn((B, H, Sq, D), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((B, H, Sk, D), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        out = torch.empty_like(q)
        parts = torch.empty(12 * B * H * Sq * (D + 2), device="cuda")
        strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, out)
                                          for st in t.stride()[:3]))
        ptrs = [t.data_ptr() for t in (q, k, v, out)]

        def call(f, rows, n_split, *x):
            tail = x + (None,) * (2 - len(x))        # counters, lse
            return lambda: f(*ptrs, 1, B, H, H, Sq, Sk, *dims[f], 0, 0, 0,
                             strides, rows, n_split, parts.data_ptr(), *tail,
                             torch.cuda.current_stream().cuda_stream)
        pplan = parent_plan(B, H, Sq, Sk, sms)
        nplan = split_plan(B, H, Sq, Sk, D, 0)
        print(json.dumps({
            "flash": f"{tag}: B={B} H={H} Sq={Sq} Sk={Sk} D={D} bf16",
            "plan_rows_n_split": {"parent": pplan, "change": nplan},
            "device_ms": alternate(call(par, *pplan),
                                   call(new, *nplan, counters.data_ptr()),
                                   graph_ms),
            "order": "parent, change, change, parent"}), flush=True)
        if tag in sweep:
            print(json.dumps({
                "flash_plans": tag, "change_device_ms": {
                    f"{r}x{n}": graph_ms(call(new, r, n, counters.data_ptr()))
                    for r, n in sweep[tag]}}), flush=True)


def event_ms(fn, reps: int = 20) -> float:
    """Eager time of one call: CUDA events around ``reps`` calls, median
    of 7 (after a warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def profiled_ms(fn, reps: int = 5) -> float:
    """Device time of one call of ``fn``: the summed time of every kernel
    it launches, from a torch.profiler trace of ``reps`` calls (after a
    warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps / 1e3


def flash_bwd_ab(libs, gen, srcs):
    """bf16 flash attention backward of both trees through their C entry
    ``flash_attention_bwd`` (the same interface), at three training
    shapes, beside the bound and SDPA's backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    fl = flash_entries(libs, ("parent_fa", "fa"), srcs)
    fns = {n: fl[n][1] for n in fl}
    # (tag, B, H, Kh, S, D, causal)
    for tag, B, H, Kh, S, D, causal in [
            ("llava-train", 2, 32, 32, 2624, 128, True),
            ("llama3-gqa", 1, 32, 8, 2048, 128, True),
            ("whisper-enc", 4, 12, 12, 1500, 64, False)]:
        q, do = (torch.randn((B, H, S, D), generator=gen,
                             device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn((B, Kh, S, D), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        grads = {n: (torch.empty_like(q), torch.empty_like(k),
                     torch.empty_like(v)) for n in fns}
        delta = torch.empty((B, H, S), device="cuda")
        strides = (ctypes.c_int64 * 24)(*(
            st for t in (q, k, v, out, do, *grads["fa"])
            for st in t.stride()[:3]))

        def call(n):
            dq, dk, dv = grads[n]
            return lambda: fns[n](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, B, H, Kh, S,
                S, *((D, D) if fl[n][2] else (D,)), int(causal), 0, 0,
                strides, torch.cuda.current_stream().cuda_stream)
        errs = {}
        want_o, want_lse = flash_attention_fwd_ref(q.float(), k.float(),
                                                   v.float(), causal=causal)
        want = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       want_o, want_lse, do.float(),
                                       causal=causal)
        for n in fns:
            if call(n)() != 0:
                raise RuntimeError(f"{n}: flash_attention_bwd failed")
            torch.cuda.synchronize()
            errs[n] = max((g.float() - w).abs().max().item()
                          for g, w in zip(grads[n], want))
        del want, want_o, want_lse
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        gqa = {"enable_gqa": True} if Kh != H else {}
        so = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                            **gqa)
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)

        def sdpa_bwd():
            torch.autograd.grad(so, (ql, kl, vl), do, retain_graph=True)
        print(json.dumps({
            "flash_bwd": f"{tag}: B={B} H={H} Kh={Kh} S={S} D={D} "
                         f"{'causal' if causal else 'non-causal'} bf16",
            "device_ms": alternate(call("parent_fa"), call("fa"), graph_ms),
            "eager_ms": alternate(call("parent_fa"), call("fa"), event_ms),
            "order": "parent, change, change, parent",
            "max_abs_err": {"parent": errs["parent_fa"],
                            "change": errs["fa"]},
            "bound_ms": 10 * pairs * D / 989e12 * 1e3,
            "bound_by": "operations (5 products, 10 * pairs * D FLOP at "
                        "989 TFLOP/s bf16)",
            "pairs": pairs,
            "sdpa_bwd_ms": event_ms(sdpa_bwd),
            "sdpa_bwd_device_ms": profiled_ms(sdpa_bwd)}), flush=True)
        del q, k, v, do, out, lse, grads, delta, ql, kl, vl, so
        torch.cuda.empty_cache()


def scan_bwd_case(gen, B, S, Hh):
    """Inputs of one backward call (bf16, as the smoke's kernel cases draw
    them), the f32 plain backward's gradients, and ``call(lib)``: a
    function that runs ``lib``'s backward entry on them into that tree's
    own outputs (returned) and scratch."""
    import torch
    from repro_torch.kernels.selective_scan import ref as sr
    d, N = (8192, 16) if Hh is None else (Hh * 64, 64)
    P = None if Hh is None else d // Hh

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = (rnd(B, S, d if Hh is None else Hh).abs() * 0.1).bfloat16()
    x, Bm, Cm = rnd(B, S, d).bfloat16(), rnd(B, S, N).bfloat16(), \
        rnd(B, S, N).bfloat16()
    A = -(rnd(d, N) if Hh is None else rnd(Hh)).abs()
    dy = rnd(B, S, d)
    want = (sr.selective_scan_bwd_ref if Hh is None else
            sr.selective_scan_heads_bwd_ref)(dt.float(), x.float(), A,
                                             Bm.float(), Cm.float(), None,
                                             dy, None)
    f32 = dict(dtype=torch.float32, device="cuda")
    blocks = d // 32
    ws = [torch.empty((B, -(-S // 8), d, N), **f32),
          torch.empty((blocks, B, S, N), **f32),
          torch.empty((blocks, B, S, N), **f32)]
    if Hh is not None:
        ws.append(torch.empty((B, S, Hh, P // 32), **f32))
    ws.append(torch.empty((B, d, N) if Hh is None else (Hh, B, P // 32),
                          **f32))

    def call(lib):
        outs = (torch.empty_like(dt), torch.empty_like(x), torch.empty_like(A),
                torch.empty_like(Bm), torch.empty_like(Cm),
                torch.empty(((B, d, N) if Hh is None else (B, Hh, P, N)),
                            **f32))
        if Hh is None:
            fn, shape = lib.selective_scan_bwd, (B, S, d, N)
            fn.argtypes = [_P] * 18 + [_I] * 5 + [_P]
        else:
            fn, shape = lib.selective_scan_heads_bwd, (B, S, Hh, P, N)
            fn.argtypes = [_P] * 19 + [_I] * 6 + [_P]
        args = [t.data_ptr() for t in (dt, x, A, Bm, Cm)] + [None] + \
            [dy.data_ptr(), None] + [t.data_ptr() for t in outs + tuple(ws)] \
            + [1, *shape]

        def run():
            if fn(*args, torch.cuda.current_stream().cuda_stream) != 0:
                raise RuntimeError("scan backward launch failed")
        return run, outs
    return call, want, (B, S, d, N, Hh)


def max_err(got, want) -> float:
    """Largest of each output's max abs error over its max |want|."""
    return max(((g.float() - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


def bwd_info(lib) -> dict:
    """Each backward instance's threads, shared bytes, registers, local
    bytes and resident blocks an SM (``selective_scan_bwd_info``), where
    the library exports it."""
    fn = getattr(lib, "selective_scan_bwd_info", None)
    if fn is None:
        return {}
    fn.argtypes = [_I] * 3 + [_P]
    out = {}
    for heads, N in ((0, 4), (0, 8), (0, 16), (1, 64)):
        for dtype in (0, 1):
            v = (ctypes.c_int * 5)()
            if fn(heads, dtype, N, ctypes.addressof(v)) == 0:
                out[f"{'heads' if heads else 'mamba1'}_N{N}_"
                    f"{'bf16' if dtype else 'f32'}"] = dict(zip(
                        ("threads", "smem", "regs", "local_bytes",
                         "blocks_per_sm"), v))
    return out


def scan_bwd_ab(libs, gen, sms):
    """The scan's backward of both trees at the two training shapes."""
    import torch
    from repro_torch.kernels.selective_scan.ops import bwd_plan
    sys.path.insert(0, str(ROOT))
    from chip_smoke import scan_bwd_bound
    print(json.dumps({"scan_bwd_info": {n: bwd_info(libs[n]) for n in
                                        ("parent_ss", "ss")}}), flush=True)
    for tag, B, S, Hh in (("falcon-train", 2, 2048, None),
                          ("zamba2-train", 1, 2048, 112)):
        call, want, (B, S, d, N, Hh) = scan_bwd_case(gen, B, S, Hh)
        runs = {n: call(libs[n]) for n in ("parent_ss", "ss")}
        errs = {}
        for n, (run, outs) in runs.items():
            run()
            torch.cuda.synchronize()
            errs[n] = max_err(outs, want)
        b_ms, b_by = scan_bwd_bound(B, S, d, N, 2, Hh)
        grid = bwd_plan(B, S, d, N, Hh)["grid"]
        print(json.dumps({
            "scan_bwd": f"{tag}: B={B} S={S} " + (
                f"d={d} N={N}" if Hh is None else f"H={Hh} P={d // Hh} N={N}")
            + " bf16 inputs, f32 dy",
            "device_ms": alternate(runs["parent_ss"][0], runs["ss"][0],
                                   lambda f: graph_ms(f, reps=5)),
            "eager_ms": alternate(runs["parent_ss"][0], runs["ss"][0],
                                  lambda f: event_ms(f, reps=5)),
            "order": "parent, change, change, parent",
            "max_rel_err": {"parent": errs["parent_ss"], "change": errs["ss"]},
            "bound_ms": b_ms, "bound_by": b_by,
            "change_grid_blocks": grid[0] * grid[1],
            "sms": sms}), flush=True)
        del runs, want
        torch.cuda.empty_cache()


def cache_write_ab(libs, gen):
    """The write of one layer's K and V rows into a 513-block pool (32
    layers of w = 4096 for LLaVA, 12 of w = 768 for whisper; bf16): the
    parent's path stacks K and V, then writes every row; this tree's reads
    K and V where they lie and skips the rows aimed at the scratch block.
    Each path, then the stack alone and each tree's write alone."""
    import torch
    par, new = libs["parent_cw"].cache_write, libs["cw"].cache_write
    L_ = ctypes.c_longlong
    par.argtypes = [_P, _I, _P, _I, _P, _I, _I, L_, L_, _I, _I, _P]
    new.argtypes = [_P, _I, _P, _I, L_, L_, _P, L_, _I, L_, L_, _I, _I, _I,
                    _I, _P]
    NB, bs = 512, PAGE
    for tag, L, w, B, C, n in [("image-chunk", 32, 4096, 1, 1024, 576),
                               ("decode-b8", 32, 4096, 8, 1, 1),
                               ("whisper-decode-b8", 12, 768, 8, 1, 1)]:
        pool = torch.zeros((2, L, NB + 1, bs, w), dtype=torch.bfloat16,
                           device="cuda")
        k, v = (torch.randn((B, C, w), generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        scratch = NB * bs
        slots = torch.full((B, C), scratch, dtype=torch.int32, device="cuda")
        perm = torch.randperm(NB * bs, generator=gen, device="cuda")
        slots[:, :n] = perm[:B * n].view(B, n).int()
        stacked = torch.stack([k, v])
        layer = L - 1
        pstride = (v.data_ptr() - k.data_ptr()) // 2

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def write_parent(rows):
            err = par(pool.data_ptr(), 1, rows.data_ptr(), 1,
                      slots.data_ptr(), 2 * B * C, B * C,
                      L * (NB + 1) * bs, layer * (NB + 1) * bs, w, 1,
                      stream())
            if err:
                raise RuntimeError(f"parent cache_write: {err}")

        def write_change():
            err = new(pool.data_ptr(), 1, k.data_ptr(), 1, pstride, w,
                      slots.data_ptr(), 2 * B * C, B * C,
                      L * (NB + 1) * bs, layer * (NB + 1) * bs, scratch, bs,
                      w, 1, stream())
            if err:
                raise RuntimeError(f"cache_write: {err}")

        write_parent(stacked)
        want = pool.clone()
        pool.zero_()
        write_change()
        torch.cuda.synchronize()
        same = torch.equal(pool[:, :, :NB], want[:, :, :NB]) and \
            not pool[:, :, NB].any()
        print(json.dumps({
            "cache_write": f"{tag}: T=2 B={B} C={C} ({n} valid) w={w} bf16",
            "rows_match_parent_scratch_untouched": same,
            "path_device_ms": alternate(
                lambda: write_parent(torch.stack([k, v])), write_change,
                graph_ms),
            "stack_device_ms": graph_ms(lambda: torch.stack([k, v])),
            "write_alone_device_ms": alternate(
                lambda: write_parent(stacked), write_change, graph_ms),
            "order": "parent, change, change, parent"}), flush=True)
        del pool, want
        torch.cuda.empty_cache()


def scan_inputs(gen, B, S, dtype, d=8192, N=16):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return ((rnd(B, S, d).abs() * 0.1).to(dtype), rnd(B, S, d).to(dtype),
            -rnd(d, N).abs(), rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype),
            rnd(B, d, N))


def run_scan(fn, ins, y, h):
    import torch
    dt = ins[0]
    B, S, d = dt.shape
    N = ins[2].shape[1]
    err = fn(*[t.data_ptr() for t in ins], y.data_ptr(), h.data_ptr(),
             0 if dt.dtype == torch.float32 else 1, B, S, d, N,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"scan launch failed: {err}")


def scan_ab(libs, gen):
    import torch
    fns = {}
    for n in ("parent_ss", "ss", "ss_ex2"):
        fns[n] = libs[n].selective_scan
        fns[n].argtypes = [_P] * 8 + [_I] * 5 + [_P]
    for B, S, dtype in [(1, 512, torch.bfloat16), (4, 512, torch.bfloat16),
                        (8, 1, torch.bfloat16), (1, 512, torch.float32)]:
        ins = scan_inputs(gen, B, S, dtype)
        y = torch.empty((B, S, 8192), device="cuda")
        h = torch.empty((B, 8192, 16), device="cuda")
        print(json.dumps({
            "scan": f"B={B} S={S} d=8192 N=16 {str(dtype)[6:]}",
            "device_ms": alternate(
                lambda: run_scan(fns["parent_ss"], ins, y, h),
                lambda: run_scan(fns["ss"], ins, y, h), graph_ms),
            "order": "parent, change, change, parent"}), flush=True)
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    for seed in range(3):
        g = torch.Generator(device="cuda").manual_seed(seed)
        ins = scan_inputs(g, 1, 512, torch.bfloat16)
        y_ref, _ = selective_scan_ref(*ins)
        errs = {}
        for n in ("ss", "ss_ex2"):
            y = torch.empty_like(y_ref)
            h = torch.empty((1, 8192, 16), device="cuda")
            run_scan(fns[n], ins, y, h)
            torch.cuda.synchronize()
            errs[n] = (y - y_ref).abs().max().item()
        print(json.dumps({"scan_exp": "B=1 S=512 d=8192 N=16 bf16", "seed":
                          seed, "max_abs_err_y": {"expf": errs["ss"],
                                                  "ex2.approx": errs["ss_ex2"]},
                          "tol": 1e-4}), flush=True)


# the per-head forward's rows: (tag, B, S)
SCAN_HEADS_CASES = (("prefill-b1-s512", 1, 512), ("prefill-b2-s512", 2, 512),
                    ("prefill-b4-s512", 4, 512), ("train-b2-s2048", 2, 2048),
                    ("decode-b1", 1, 1), ("decode-b4", 4, 1),
                    ("decode-b8", 8, 1))
# the error readings' rows (not timed)
SCAN_HEADS_ERR = (("prefill-b1-s512", 1, 512), ("train-b2-s2048", 2, 2048))


def run_heads(fn, ins, y, h):
    import torch
    dt, x, A, Bm, Cm, h0 = ins
    B, S, Hh = dt.shape
    err = fn(*[t.data_ptr() for t in ins], y.data_ptr(), h.data_ptr(),
             0 if dt.dtype == torch.float32 else 1, B, S, Hh,
             x.shape[2] // Hh, Bm.shape[2],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"per-head scan launch failed: {err}")


def scan_heads_ab(libs, gen):
    """The per-head forward (``selective_scan_heads``, bf16 inputs, f32
    state from a nonzero h0) of both trees through their C entries at
    zamba2-7b's widths (H = 112, P = 64, N = 64): S = 512 at B = 1, 2, 4,
    the training shape B = 2 at S = 2,048, decode at B = 1, 4, 8.  Device
    ms parent, change, change, parent (CUDA-graph replays), each tree's
    largest error against the plain version, whether the two trees give
    the same bits (y and h) and whether each repeats its own; beside the
    bound (``chip_smoke.py::heads_bound``).  Last, the error readings of
    ``SCAN_HEADS_ERR``'s rows (see ``heads_err_rows``)."""
    import torch
    from repro_torch.kernels.selective_scan.ref import selective_scan_heads_ref
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (ZH, ZN, ZP, exp_rate, fma_rate, heads_bound,
                            heads_inputs)
    fns = {}
    for n in ("parent_ss", "ss"):
        fns[n] = libs[n].selective_scan_heads
        fns[n].argtypes = [_P] * 8 + [_I] * 6 + [_P]
    fma, rate = fma_rate(), exp_rate()
    for tag, B, S in SCAN_HEADS_CASES:
        ins = heads_inputs(gen, "cuda", B, S, torch.bfloat16)
        y_ref, h_ref = selective_scan_heads_ref(*ins)
        outs = {}
        for n in fns:
            y = torch.empty((B, S, ZH * ZP), device="cuda")
            h = torch.empty((B, ZH, ZP, ZN), device="cuda")
            run_heads(fns[n], ins, y, h)
            torch.cuda.synchronize()
            y2, h2 = torch.empty_like(y), torch.empty_like(h)
            run_heads(fns[n], ins, y2, h2)
            torch.cuda.synchronize()
            outs[n] = (y, h, torch.equal(y, y2) and torch.equal(h, h2))
        err = {n: max((o[0] - y_ref).abs().max().item(),
                      (o[1] - h_ref).abs().max().item())
               for n, o in outs.items()}
        b_ms, b_by = heads_bound(B, S, 2, fma, rate)

        def timer(n):
            y, h = outs[n][0], outs[n][1]
            return graph_ms(lambda: run_heads(fns[n], ins, y, h))
        dev = alternate("parent_ss", "ss", timer)
        print(json.dumps({
            "scan_heads": f"{tag}: B={B} S={S} H={ZH} P={ZP} N={ZN} bf16 "
                          f"inputs, f32 state",
            "device_ms": dev, "order": "parent, change, change, parent",
            "change_pct": 100 * (statistics.median(dev[1:3])
                                 / statistics.median(dev[::3]) - 1),
            "max_abs_err": {"parent": err["parent_ss"], "change": err["ss"]},
            "tol": 1e-4,
            "bits_equal": {"y": torch.equal(outs["parent_ss"][0],
                                            outs["ss"][0]),
                           "h": torch.equal(outs["parent_ss"][1],
                                            outs["ss"][1])},
            "repeatable": {"parent": outs["parent_ss"][2],
                           "change": outs["ss"][2]},
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / statistics.median(dev[1:3])}), flush=True)
        del ins, outs, y_ref, h_ref
        torch.cuda.empty_cache()
    heads_err_rows(fns)


def heads_err_rows(fns):
    """For each (tag, B, S) of ``SCAN_HEADS_ERR``, f32 and bf16 inputs,
    three draws (seeds 0-2, ``chip_smoke.heads_inputs``): each tree's
    largest error against the plain version (y and h), absolute and over
    the magnitude scale (``chip_smoke.long_scan_reading``), and the plain
    version's own on TF32-rounded x, B and C (``chip_smoke.tf32``; inputs
    already bf16 are left as they are, so that row reads 0)."""
    import torch
    from repro_torch.kernels.selective_scan.ref import selective_scan_heads_ref
    from chip_smoke import (LONG_SCAN_RTOL, ZH, ZN, ZP, heads_inputs,
                            long_scan_reading, scan_scale, tf32)
    for tag, B, S in SCAN_HEADS_ERR:
        for dtype in (torch.float32, torch.bfloat16):
            for seed in range(3):
                g = torch.Generator(device="cuda").manual_seed(seed)
                ins = heads_inputs(g, "cuda", B, S, dtype)
                want = selective_scan_heads_ref(*ins)
                scale = scan_scale(selective_scan_heads_ref, ins)
                dt, x, A, Bm, Cm, h0 = ins
                ctrl = selective_scan_heads_ref(dt, tf32(x), A, tf32(Bm),
                                                tf32(Cm), h0)
                read = {}
                for n in fns:
                    y = torch.empty((B, S, ZH * ZP), device="cuda")
                    h = torch.empty((B, ZH, ZP, ZN), device="cuda")
                    run_heads(fns[n], ins, y, h)
                    torch.cuda.synchronize()
                    read[n] = (y, h)
                read["tf32_control"] = ctrl
                print(json.dumps({
                    "scan_heads_err": f"{tag}: B={B} S={S} H={ZH} P={ZP} "
                                      f"N={ZN} {str(dtype)[6:]} inputs",
                    "seed": seed, "rtol_of_scale": LONG_SCAN_RTOL,
                    **{("parent" if n == "parent_ss" else
                        "change" if n == "ss" else n): {
                        part: long_scan_reading(o[i], want[i], scale[i])
                        for i, part in enumerate(("y", "h"))}
                       for n, o in read.items()}}), flush=True)
                del ins, want, scale, ctrl, read
                torch.cuda.empty_cache()


def takes_dv(src: Path) -> bool:
    """Whether a tree's flash_attention.cu entries take the value width
    (``int D, int DV``) after the head dim."""
    return "int D, int DV" in src.read_text()


def flash_entries(libs, names, srcs):
    """{name: (forward, backward, takes_dv)} of each tree's flash library,
    their argument types declared."""
    out = {}
    for n, src in zip(names, srcs):
        dv = takes_dv(src)
        ints = 11 if dv else 10
        f = libs[n].flash_attention
        f.argtypes = [_P] * 4 + [_I] * ints + [
            ctypes.POINTER(ctypes.c_int64)] + [_I] * 2 + [_P] * 4
        f.restype = _I
        b = libs[n].flash_attention_bwd
        b.argtypes = [_P] * 10 + [_I] * ints + [
            ctypes.POINTER(ctypes.c_int64), _P]
        b.restype = _I
        out[n] = (f, b, dv)
    return out


def shared_ab(libs, gen, srcs):
    """Both trees' instances that existed before the change: the same
    inputs and plan through each tree's C entry; bits and device times."""
    import torch
    from repro_torch.kernels.flash_attention.ops import split_plan
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_fwd_ref
    names = ("parent_fa", "fa")
    fl = flash_entries(libs, names, srcs)
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")

    def row(kind, shape, outs, calls, err=None):
        """outs: each tree's outputs after one call; the timing's replays
        of the same calls then show whether each tree repeats its own
        bits.  A row counts against the trees only where the parent
        repeats itself, and the change must repeat its own."""
        torch.cuda.synchronize()
        first = [[t.clone() for t in o] for o in outs]
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        t = alternate(*calls, graph_ms)
        torch.cuda.synchronize()
        repeats = [all(torch.equal(a, b) for a, b in zip(f, o))
                   for f, o in zip(first, outs)]
        par, chg = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(json.dumps({kind: shape, "bits_equal": same,
                          "repeats_own_bits": {"parent": repeats[0],
                                               "change": repeats[1]},
                          "device_ms": t,
                          "order": "parent, change, change, parent",
                          "change_pct": 100 * (chg - par) / par,
                          **({"max_abs_err_vs_plain": err} if err else {})}),
              flush=True)
        return (same or not repeats[0]) and repeats[1]

    ok = True
    # flash forward (with lse), each tree at this tree's plan
    for tag, B, H, Kh, Sq, Sk, D, causal in [
            ("whisper-enc", 4, 12, 12, 1500, 1500, 64, False),
            ("whisper-cross-decode", 8, 12, 12, 1, 1500, 64, False),
            ("whisper-cross-chunk", 4, 12, 12, 64, 1500, 64, False),
            ("llama3-gqa", 1, 32, 8, 1024, 1024, 128, True),
            ("llava-train", 2, 32, 32, 2624, 2624, 128, True)]:
        q = torch.randn((B, H, Sq, D), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((B, Kh, Sk, D), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        rows, n_split = split_plan(B, H, Sq, Sk, D, 0)
        outs = {n: (torch.empty_like(q), torch.empty((B, H, Sq),
                                                     device="cuda"))
                for n in names}
        parts = torch.empty(max(n_split, 1) * B * H * Sq * (D + 2),
                            device="cuda")
        strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, q)
                                          for st in t.stride()[:3]))

        def call(n):
            f, _, dv = fl[n]
            o, lse = outs[n]
            dims = (D, D) if dv else (D,)
            return lambda: f(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), 1, B, H, Kh, Sq, Sk, *dims,
                             int(causal), 0, 0, strides, rows, n_split,
                             parts.data_ptr(), counters.data_ptr(),
                             lse.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
        for n in names:
            if call(n)() != 0:
                raise RuntimeError(f"{n}: flash_attention failed")
        want, _ = flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                          causal=causal)
        err = (outs["fa"][0].float() - want).abs().max().item()
        ok &= row("flash_fwd", f"{tag}: B={B} H={H} Kh={Kh} Sq={Sq} Sk={Sk} "
                  f"D={D} rows={rows} n_split={n_split} bf16",
                  [outs[n] for n in names], [call(n) for n in names], err)
        del q, k, v, outs, parts, want
        torch.cuda.empty_cache()
    # flash backward: the narrow body at D = 64 and 128, the wide body at
    # the smoke's wide training shapes (chip_smoke.py WIDTHS)
    for tag, B, H, Kh, S, D, Dv, causal, window in [
            ("llava-train", 2, 32, 32, 2624, 128, 128, True, 0),
            ("llama3-gqa", 1, 32, 8, 2048, 128, 128, True, 0),
            ("whisper-enc", 4, 12, 12, 1500, 64, 64, False, 0),
            ("stablelm-train", 2, 32, 8, 2048, 160, 160, True, 0),
            ("gemma3-global", 2, 8, 4, 2048, 256, 256, True, 0),
            ("gemma3-local", 2, 8, 4, 2048, 256, 256, True, 1024),
            ("mla-train", 2, 128, 128, 2048, 192, 128, True, 0)]:
        from repro_torch.kernels.flash_attention.ops import \
            flash_attention_fwd
        q = torch.randn((B, H, S, D), generator=gen, device="cuda").bfloat16()
        do = torch.randn((B, H, S, Dv), generator=gen,
                         device="cuda").bfloat16()
        k = torch.randn((B, Kh, S, D), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, Kh, S, Dv), generator=gen,
                        device="cuda").bfloat16()
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        grads = {n: (torch.empty_like(q), torch.empty_like(k),
                     torch.empty_like(v)) for n in names}
        delta = torch.empty((B, H, S), device="cuda")
        strides = (ctypes.c_int64 * 24)(*(
            st for t in (q, k, v, out, do, *grads["fa"])
            for st in t.stride()[:3]))

        def bcall(n):
            _, b, dv = fl[n]
            dq, dk, dvv = grads[n]
            dims = (D, Dv) if dv else (D,)
            return lambda: b(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), 1, B, H, Kh, S,
                S, *dims, int(causal), window, 0, strides,
                torch.cuda.current_stream().cuda_stream)
        for n in names:
            if bcall(n)() != 0:
                raise RuntimeError(f"{n}: flash_attention_bwd failed")
        ok &= row("flash_bwd", f"{tag}: B={B} H={H} Kh={Kh} S={S} D={D} "
                  f"Dv={Dv} window={window} bf16",
                  [grads[n] for n in names], [bcall(n) for n in names])
        del q, k, v, do, out, lse, grads, delta
        torch.cuda.empty_cache()
    # bf16 chunked prefill at its six widths
    fns = {n: libs[n].paged_prefill_attention for n in ("parent_pa", "pa")}
    for f in fns.values():
        f.argtypes = [_P] * 6 + [_I] * 9 + [_P]
    H = Kh = 32
    C, n_pages = 512, 40
    for D in (64, 80, 112, 128, 160, 256):
        kp, vp = (torch.randn((n_pages, PAGE, Kh, D), generator=gen,
                              device="cuda").bfloat16() for _ in range(2))
        tables = torch.arange(C // PAGE, dtype=torch.int32,
                              device="cuda")[None]
        q = torch.randn((1, C, H, D), generator=gen, device="cuda").bfloat16()
        ctx = torch.zeros(1, dtype=torch.int32, device="cuda")
        outs = {n: (torch.empty_like(q),) for n in fns}

        def pcall(n):
            ptrs = [t.data_ptr() for t in (q, kp, vp, tables, ctx,
                                           outs[n][0])]
            return lambda: fns[n](*ptrs, 1, 1, C, H, Kh, D, PAGE, C // PAGE,
                                  0, torch.cuda.current_stream().cuda_stream)
        for n in fns:
            pcall(n)()
        ok &= row("prefill", f"first chunk: B=1 C={C} H=Kh={H} D={D} bf16",
                  [outs[n] for n in fns], [pcall(n) for n in fns])
    print(json.dumps({"all_bits_equal": bool(ok)}), flush=True)
    return ok


# the wide training shapes of chip_smoke.py's WIDTHS: (tag, B, H, Kh, S, D,
# Dv, window), causal
WIDE_TRAIN = [("zamba2-train", 2, 32, 32, 2048, 112, 112, 0),
              ("stablelm-train", 2, 32, 8, 2048, 160, 160, 0),
              ("gemma3-global", 2, 8, 4, 2048, 256, 256, 0),
              ("gemma3-local", 2, 8, 4, 2048, 256, 256, 1024),
              ("mla-train", 2, 128, 128, 2048, 192, 128, 0)]


def wide_fwd_inputs(gen, B, H, Kh, S, D, Dv, window):
    """q, k, v of a wide training shape, the plain version's f32 output and
    the C entries' strides."""
    import torch
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_fwd_ref
    q = torch.randn((B, H, S, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, Kh, S, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, Kh, S, Dv), generator=gen, device="cuda").bfloat16()
    want, _ = flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                      causal=True, window=window)
    out = torch.empty((B, H, S, Dv), device="cuda", dtype=torch.bfloat16)
    strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, out)
                                      for st in t.stride()[:3]))
    return q, k, v, want, strides


def fwd_call(f, q, k, v, out, lse, strides, plan, window, parts, counters):
    """A closure of one bf16 forward call through a tree's C entry (which
    takes the value width) at plan (rows, n_split)."""
    import torch
    B, H, S, D = q.shape
    Kh, Dv = k.shape[1], v.shape[3]
    return lambda: f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     1, B, H, Kh, S, S, D, Dv, 1, window, 0, strides, *plan,
                     parts.data_ptr(), counters.data_ptr(), lse.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)


def wide_fwd_ab(libs, gen, srcs, parent_plan):
    """The bf16 forward at the wide training shapes, each tree at its own
    plan: device times, each tree's error against the plain version and
    whether it repeats its own bits."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        blocks_per_sm, split_plan, tile_rows)
    names = ("parent_fa", "fa")
    fl = flash_entries(libs, names, srcs)
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tag, B, H, Kh, S, D, Dv, window in WIDE_TRAIN:
        q, k, v, want, strides = wide_fwd_inputs(gen, B, H, Kh, S, D, Dv,
                                                 window)
        per_sm = blocks_per_sm(tile_rows(S), D, Dv)
        widths = (D, Dv) if "Dv" in inspect.signature(parent_plan).parameters \
            else ()
        plans = {"parent_fa": parent_plan(B, H, S, S, sms, per_sm, *widths),
                 "fa": split_plan(B, H, S, S, D, 0, Dv)}
        parts = torch.empty(max(p[1] for p in plans.values()) * B * H * S
                            * (Dv + 2), device="cuda")
        outs = {n: (torch.empty((B, H, S, Dv), device="cuda",
                                dtype=torch.bfloat16),
                    torch.empty((B, H, S), device="cuda")) for n in names}
        calls = [fwd_call(fl[n][0], q, k, v, *outs[n], strides, plans[n],
                          window, parts, counters) for n in names]
        for n, c in zip(names, calls):
            if c() != 0:
                raise RuntimeError(f"{n}: flash_attention failed")
        torch.cuda.synchronize()
        first = {n: [t.clone() for t in outs[n]] for n in names}
        errs = {n: (outs[n][0].float() - want).abs().max().item()
                for n in names}
        t = alternate(*calls, graph_ms)
        torch.cuda.synchronize()
        print(json.dumps({
            "flash_fwd_wide": f"{tag}: B={B} H={H} Kh={Kh} S={S} D={D} "
                              f"Dv={Dv} window={window} causal bf16",
            "plan_rows_n_split": {"parent": plans["parent_fa"],
                                  "change": plans["fa"]},
            "device_ms": t, "order": "parent, change, change, parent",
            "change_pct": 100 * ((t[1] + t[2]) - (t[0] + t[3]))
            / (t[0] + t[3]),
            "max_abs_err_vs_plain": {"parent": errs["parent_fa"],
                                     "change": errs["fa"]},
            "bits_equal": all(torch.equal(a, b) for a, b in zip(
                first["parent_fa"], first["fa"])),
            "repeats_own_bits": {
                "parent": all(torch.equal(a, b) for a, b in zip(
                    first["parent_fa"], outs["parent_fa"])),
                "change": all(torch.equal(a, b) for a, b in zip(
                    first["fa"], outs["fa"]))},
            "counts_toward_all_bits_equal": False}), flush=True)
        del q, k, v, want, parts, outs, first
        torch.cuda.empty_cache()
    threshold_fwd_ab(fl["fa"][0], gen, counters, sms)


def threshold_fwd_ab(f, gen, counters, sms):
    """This tree's bf16 forward at each wide pair's shortest causal
    sequence whose 64-row grid needs no split (B = 1, the training shape's
    heads): the wgmma body (the plan's choice) against the mma.sync tile
    unsplit, tile, body, body, tile."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        WGMMA_ROWS, blocks_per_sm, split_plan)
    for tag, _, H, Kh, _, D, Dv, window in WIDE_TRAIN:
        if window:
            continue
        per_sm = blocks_per_sm(64, D, Dv)
        S = 64 * (sms * per_sm // (2 * H) + 1)
        if split_plan(1, H, S, S, D, 0, Dv) != (WGMMA_ROWS, 1):
            raise RuntimeError(f"{tag}: S={S} is not past the split threshold")
        q, k, v, want, strides = wide_fwd_inputs(gen, 1, H, Kh, S, D, Dv, 0)
        parts = torch.empty(1, device="cuda")
        plans = {"tile": (64, 1), "wgmma": (WGMMA_ROWS, 1)}
        outs = {n: (torch.empty((1, H, S, Dv), device="cuda",
                                dtype=torch.bfloat16),
                    torch.empty((1, H, S), device="cuda")) for n in plans}
        calls = [fwd_call(f, q, k, v, *outs[n], strides, plans[n], 0, parts,
                          counters) for n in plans]
        for n, c in zip(plans, calls):
            if c() != 0:
                raise RuntimeError(f"{n}: flash_attention failed")
        torch.cuda.synchronize()
        errs = {n: (outs[n][0].float() - want).abs().max().item()
                for n in plans}
        t = alternate(*calls, graph_ms)
        print(json.dumps({
            "flash_fwd_threshold": f"{tag}: B=1 H={H} Kh={Kh} S={S} D={D} "
                                   f"Dv={Dv} causal bf16",
            "tile_blocks_per_sm": per_sm,
            "blocks": {"tile": H * (S // 64),
                       "wgmma": H * -(-S // WGMMA_ROWS)},
            "device_ms": t, "order": "tile, wgmma, wgmma, tile",
            "wgmma_pct": 100 * ((t[1] + t[2]) - (t[0] + t[3]))
            / (t[0] + t[3]),
            "max_abs_err_vs_plain": errs}), flush=True)
        del q, k, v, want, outs
        torch.cuda.empty_cache()


# bf16 chunked prefill at the served shapes: (tag, H, Kh, D, ctx per lane
# (None: a padded lane, its table all scratch), C, valid rows per lane):
# zamba2-7b's and stablelm-12b's 512-token chunks (a first one and a later
# one), LLaVA's image chunk and 32-token text chunks, stablelm-12b's CLI
# 16-row chunks; then the later chunks of 16, 32 and 64 rows each width
# also gets (a prompt's tail)
PREFILL_SERVED = [("zamba2-c512", 32, 32, 112, [0, 512], 512, [512, 88]),
                  ("stablelm-c512", 32, 8, 160, [0, 512], 512, [512, 88]),
                  ("llava-media-c1024", 32, 32, 128, [0], 1024, [576]),
                  ("llava-text-c32", 32, 32, 128, [600, 620, 650, None], 32,
                   [32, 32, 32, 0]),
                  ("stablelm-cli-c16", 32, 8, 160, [0, 0, 0, 0], 16,
                   [16, 16, 16, 16]),
                  *((f"{tag}-tail-c{C}", H, Kh, D, [300, 500], C,
                     [C, C // 2 + 1])
                    for tag, H, Kh, D in (("zamba2", 32, 32, 112),
                                          ("llava", 32, 32, 128),
                                          ("stablelm", 32, 8, 160))
                    for C in (16, 32, 64))]


def prefill_inputs(gen, H, Kh, D, ctx, C, n_valid):
    """q, pages (the last one scratch), tables and ctx of a served chunk:
    lane b owns distinct pages for its ctx + n_valid keys, the rest of
    its row (and a padded lane's whole row) names scratch; and the plain
    version's f32 output."""
    import torch
    from repro_torch.kernels.paged_attention.ref import \
        paged_prefill_attention_ref
    B = len(ctx)
    max_pages = max(-(-((c or 0) + C) // PAGE) for c in ctx)
    n_pages = B * max_pages + 1
    kp, vp = (torch.randn((n_pages, PAGE, Kh, D), generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    tables = torch.full((B, max_pages), n_pages - 1, dtype=torch.int32)
    nxt = 0
    for b, (c, n) in enumerate(zip(ctx, n_valid)):
        if c is not None:
            k = -(-(c + n) // PAGE)
            tables[b, :k] = torch.arange(nxt, nxt + k, dtype=torch.int32)
            nxt += k
    tables = tables.cuda()
    q = torch.randn((B, C, H, D), generator=gen, device="cuda").bfloat16()
    ctx_t = torch.tensor([c or 0 for c in ctx], dtype=torch.int32,
                         device="cuda")
    want = paged_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                       tables, ctx_t)
    return q, kp, vp, tables, ctx_t, want


def prefill_call(lib, body, q, kp, vp, tables, ctx, out):
    """A closure of one bf16 chunked prefill through a tree's C entry:
    ``paged_prefill_attention`` (the tile) or, for body "wgmma",
    ``paged_prefill_attention_wgmma``."""
    import torch
    B, C, H, D = q.shape
    n_pages, page, Kh, _ = kp.shape
    ptrs = [t.data_ptr() for t in (q, kp, vp, tables, ctx, out)]
    if body == "wgmma":
        f = lib.paged_prefill_attention_wgmma
        f.argtypes = [_P] * 6 + [_I] * 9 + [_P]
        return lambda: f(*ptrs, B, C, H, Kh, D, page, tables.shape[1], 0,
                         n_pages * page,
                         torch.cuda.current_stream().cuda_stream)
    f = lib.paged_prefill_attention
    f.argtypes = [_P] * 6 + [_I] * 9 + [_P]
    return lambda: f(*ptrs, 1, B, C, H, Kh, D, page, tables.shape[1], 0,
                     torch.cuda.current_stream().cuda_stream)


def prefill_plan_ab(libs, gen, parent_plan):
    """bf16 chunked prefill at the served shapes, each tree at its own
    plan (the parent's ``prefill_plan`` loaded from its tree; a tree
    without one runs every chunk on the tile): device times parent,
    change, change, parent, each tree's largest error against the plain
    version's f32 output on the rows that see a key and whether it repeats
    its own bits (rows ``paged_prefill``, outside ``all_bits_equal``);
    then this tree's wgmma body against its tile at each shape of a width
    the body is built for, tile, wgmma, wgmma, tile (rows
    ``paged_prefill_threshold``: they decide ``PREFILL_WGMMA_DIMS``)."""
    import torch
    from repro_torch.kernels.paged_attention.ops import (
        PREFILL_WGMMA_DIMS, prefill_plan)
    for tag, H, Kh, D, ctx, C, n_valid in PREFILL_SERVED:
        q, kp, vp, tables, ctx_t, want = prefill_inputs(gen, H, Kh, D, ctx,
                                                        C, n_valid)
        B = len(ctx)
        seen = torch.tensor([[c is not None and i < n for i in range(C)]
                             for c, n in zip(ctx, n_valid)], device="cuda")
        plans = {"parent": parent_plan(D, PAGE) if parent_plan else "tile",
                 "change": prefill_plan(D, PAGE)}
        rows = [("paged_prefill", {"parent": ("parent_pa", plans["parent"]),
                                   "change": ("pa", plans["change"])})]
        if D in PREFILL_WGMMA_DIMS:
            rows.append(("paged_prefill_threshold",
                         {"tile": ("pa", "tile"), "wgmma": ("pa", "wgmma")}))
        for kind, who in rows:
            outs = {n: torch.empty_like(q) for n in who}
            calls = {n: prefill_call(libs[lib], body, q, kp, vp, tables,
                                     ctx_t, outs[n])
                     for n, (lib, body) in who.items()}
            for n, c in calls.items():
                if c() != 0:
                    raise RuntimeError(f"{tag} {n}: prefill launch failed")
            torch.cuda.synchronize()
            first = {n: o.clone() for n, o in outs.items()}
            errs = {n: (o[seen].float() - want[seen]).abs().max().item()
                    for n, o in outs.items()}
            a, b = list(calls)
            t = alternate(calls[a], calls[b], graph_ms)
            torch.cuda.synchronize()
            print(json.dumps({
                kind: f"{tag}: B={B} C={C} H={H} Kh={Kh} D={D} ctx {ctx} "
                      f"valid {n_valid} page {PAGE} bf16",
                "bodies": {n: body for n, (_, body) in who.items()},
                "device_ms": t, "order": f"{a}, {b}, {b}, {a}",
                "change_pct": 100 * ((t[1] + t[2]) - (t[0] + t[3]))
                / (t[0] + t[3]),
                "max_abs_err_vs_plain": errs,
                "bits_equal": torch.equal(first[a], first[b]),
                "repeats_own_bits": {n: torch.equal(first[n], outs[n])
                                     for n in outs},
                "counts_toward_all_bits_equal": False}), flush=True)
            del outs, first
        del q, kp, vp, tables, want
        torch.cuda.empty_cache()


def parent_function(parent: Path, module: str, name: str):
    """Function ``name`` of the parent tree's ``src/repro_torch/<module>``,
    loaded from its file (its imports resolve to this tree's package)."""
    import importlib.util
    path = parent / "src" / "repro_torch" / module
    spec = importlib.util.spec_from_file_location(f"parent_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--mla", action="store_true",
                    help="only MLA's decode and chunked prefill at D = 576")
    ap.add_argument("--flash-bwd", action="store_true",
                    help="only flash attention's backward (bf16)")
    ap.add_argument("--scan-bwd", action="store_true",
                    help="only the selective scan's backward (bf16)")
    ap.add_argument("--scan-heads", action="store_true",
                    help="only the per-head scan's forward (bf16) of both "
                         "trees, then their error readings")
    ap.add_argument("--widths", action="store_true",
                    help="only the flash and chunked-prefill instances both "
                         "trees have: bits and device times; and the wide "
                         "bf16 forward of each tree at its own plan")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    pcsrc = args.parent / "src" / "repro_torch" / "csrc"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if args.mla:
        libs = build({"pa": (csrc / "paged_attention.cu", csrc),
                      "parent_pa": (pcsrc / "paged_attention.cu", pcsrc)})
        print(json.dumps({"card": card}), flush=True)
        mla_ab(libs, gen, sms, parent_function(
            args.parent, "kernels/paged_attention/ops.py", "decode_plan"))
        return 0
    if args.flash_bwd:
        libs = build({"fa": (csrc / "flash_attention.cu", csrc),
                      "parent_fa": (pcsrc / "flash_attention.cu", pcsrc)})
        print(json.dumps({"card": card}), flush=True)
        flash_bwd_ab(libs, gen, (pcsrc / "flash_attention.cu",
                                 csrc / "flash_attention.cu"))
        return 0
    if args.widths:
        libs = build({"fa": (csrc / "flash_attention.cu", csrc),
                      "parent_fa": (pcsrc / "flash_attention.cu", pcsrc),
                      "pa": (csrc / "paged_attention.cu", csrc),
                      "parent_pa": (pcsrc / "paged_attention.cu", pcsrc)})
        print(json.dumps({"card": card}), flush=True)
        srcs = (pcsrc / "flash_attention.cu", csrc / "flash_attention.cu")
        ok = shared_ab(libs, gen, srcs)
        wide_fwd_ab(libs, gen, srcs, parent_function(
            args.parent, "kernels/flash_attention/ops.py", "plan"))
        try:
            parent_plan = parent_function(
                args.parent, "kernels/paged_attention/ops.py", "prefill_plan")
        except AttributeError:              # a tree with the tile alone
            parent_plan = None
        prefill_plan_ab(libs, gen, parent_plan)
        return 0 if ok else 1
    if args.scan_heads:
        libs = build({"ss": (csrc / "selective_scan.cu", csrc),
                      "parent_ss": (pcsrc / "selective_scan.cu", pcsrc)})
        print(json.dumps({"card": card}), flush=True)
        scan_heads_ab(libs, gen)
        return 0
    if args.scan_bwd:
        libs = build({"ss": (csrc / "selective_scan.cu", csrc),
                      "parent_ss": (pcsrc / "selective_scan.cu", pcsrc)})
        print(json.dumps({"card": card}), flush=True)
        scan_bwd_ab(libs, gen, sms)
        return 0
    scan = (csrc / "selective_scan.cu").read_text()
    old = "expf(dtv * a[i])"
    if old not in scan:
        raise RuntimeError("the scan's exponential is not where expected")
    OUT.mkdir(parents=True, exist_ok=True)
    variant = OUT / "selective_scan_ex2.cu"
    variant.write_text(scan.replace(
        "namespace {\n", "namespace {\n__device__ __forceinline__ float "
        "ex2a(float x) {\n  float y;\n  asm(\"ex2.approx.ftz.f32 %0, %1;\" : "
        "\"=f\"(y) : \"f\"(x * 1.4426950408889634f));\n  return y;\n}\n", 1)
        .replace(old, "ex2a(dtv * a[i])"))
    libs = build({"cw": (csrc / "cache_write.cu", csrc),
                  "parent_cw": (pcsrc / "cache_write.cu", pcsrc),
                  "pa": (csrc / "paged_attention.cu", csrc),
                  "ss": (csrc / "selective_scan.cu", csrc),
                  "fa": (csrc / "flash_attention.cu", csrc),
                  "parent_fa": (pcsrc / "flash_attention.cu", pcsrc),
                  "parent_pa": (pcsrc / "paged_attention.cu", pcsrc),
                  "parent_ss": (pcsrc / "selective_scan.cu", pcsrc),
                  "ss_ex2": (variant, csrc)})
    print(json.dumps({"card": card}), flush=True)
    cache_write_ab(libs, gen)
    decode_ab(libs, gen, sms)
    prefill_ab(libs, gen)
    flash_ab(libs, gen, sms, parent_function(
        args.parent, "kernels/flash_attention/ops.py", "plan"),
        (pcsrc / "flash_attention.cu", csrc / "flash_attention.cu"))
    scan_ab(libs, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
