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
``paged_prefill_attention``.  Needs a CUDA card and nvcc; prints one JSON
object per line.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
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


def flash_ab(libs, gen, sms, parent_plan):
    """bf16 flash attention at whisper's shapes: the encoder (one split)
    and the cross-attention of a 64-row chunk and of a decode row, each
    tree at its own plan (``parent_plan``: the parent's ``plan``; the
    parent's split calls launch their merge as a second kernel).  Then
    this tree's kernel at other (rows, n_split) plans of the two split
    shapes, timed once each, to compare the planner's choice with."""
    import torch
    from repro_torch.kernels.flash_attention.ops import split_plan
    par, new = (libs[n].flash_attention for n in ("parent_fa", "fa"))
    head = [_P] * 4 + [_I] * 10 + [ctypes.POINTER(ctypes.c_int64)] + [_I] * 2
    par.argtypes = head + [_P] * 2
    new.argtypes = head + [_P] * 3
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
            return lambda: f(*ptrs, 1, B, H, H, Sq, Sk, D, 0, 0, 0, strides,
                             rows, n_split, parts.data_ptr(), *x,
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
        args.parent, "kernels/flash_attention/ops.py", "plan"))
    scan_ab(libs, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
