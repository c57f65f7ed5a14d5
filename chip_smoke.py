#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA.  Phases, each of which raises
on failure:

1. card   - name and power limit, from nvidia-smi;
2. build  - compile every kernel of the serving paths from ``src/repro_torch/
            csrc`` (all nvcc processes at once), and read from ``cuobjdump
            -sass`` that the bf16 attention kernels run on tensor cores
            (HMMA instructions; HGMMA, wgmma, in the latent-row kernel)
            and from ptxas that the latent-row kernel and the scan's
            per-head mode do not spill;
3. kernels- each kernel against its plain PyTorch version on the card: the
            attention and cache-write kernels at full-width LLaVA-1.5-7B
            shapes (H = Kh = 32, D = 128, page 16, w = 4096), in f32 and
            bf16, plus a window case, a GQA case and empty-mask rows
            (bf16 chunked prefill and flash attention held against the
            plain version's f32 output on the same inputs, upcast);
            decode also at whisper-small's decoder shape (H = Kh = 12,
            D = 64, one split) and on one lane of 4096 keys (many splits),
            at B = 8 with L2 flushed too, and captured in a CUDA graph;
            chunked prefill at whisper-small's decoder shape (64-row chunks
            with ragged valid rows); the selective scan at falcon-mamba-7b
            widths (d = 8192, N = 16): prefill B = 1 and 4 at S = 512 from
            a nonzero state, decode B = 4 and 8, f32 and bf16, and a tail
            of dt = 0 that must leave the state unchanged; flash attention
            at whisper-small shapes (H = 12, D = 64, 1500 frames: encoder
            self-attention at B = 1 and 4, cross-attention of a 64-row chunk
            at B = 4 and of a decode row at B = 8) and causal GQA at H = 32,
            Kh = 8, D = 128, S = 1024 (plain, window 256, and a 256-row
            chunk after 768 cached keys), f32 and bf16, the decode row also
            with L2 flushed between calls (as a decode step finds its cross
            K/V; device time from a torch.profiler trace); the cache write
            from separate K and V planes into a pool past 2^31 elements at
            LLaVA's image chunk and decode (B = 8), the scratch block left
            byte for byte as it was; the split-KV merge (csrc/
            attn_merge.cuh), which the split kernels run in their last
            blocks, also as a kernel of its own from each library against
            its plain version, with a planted fault its bar must catch,
            and its share of the split calls that run it (decode at B = 8,
            flash's decode row and 64-row chunk): their device time beside
            that of the same calls from a build whose split blocks write
            their partials and skip the merge;
            MLA's latent rows (K and V the same pages, one KV head, 128
            query heads) at D = 80, 112 and 576: decode at B = 8 and
            chunked prefill of a 64-row chunk, f32 and bf16 (bf16 at 576
            on the latent-row wgmma kernels of csrc/attn_latent.cuh, held
            against the plain version's f32 output; its decode also on
            one lane of 4096 keys and with L2 flushed), and the
            single-plane width-576 cache write of a decode step, scratch
            untouched;
            times kernel (eager, and CUDA-graph replay), plain
            version and one PyTorch library call (where there is one) with
            CUDA events, and computes each kernel's bound (at D = 576 too:
            decode at B = 8, a 512-token chunk, the write);
            the scan's per-head mode (Mamba-2) at zamba2-7b's widths (H =
            112 heads of P = 64, N = 64): prefill B = 1 and 4 at S = 512
            from a nonzero state, decode B = 4 and 8, f32 and bf16, a dt =
            0 tail that must leave the state unchanged, its bound from the
            bytes and 3 f32 instructions per (step, channel, state) over
            the card's f32 lanes; the paged decode (B = 8) and chunked
            prefill (a 512-token chunk, f32 and bf16) at zamba2-7b's
            shared attention (H = Kh = 32, D = 112) against their plain
            versions and SDPA;
4. model  - the port's runner on the card against the same runner on the
            CPU (plain versions) on reduced LLaVA, reduced falcon-mamba
            (batched chunks of different lengths) and reduced whisper-small
            (encoder output, batched chunks, decode over cross K/V),
            reduced granite-moe-1b-a400m, reduced DeepSeek-V2 (latent
            pool, D = 80), reduced zamba2-7b (Mamba-2 + shared attention)
            and reduced gemma3-4b (sliding window): logits per step;
5. serve  - three main paths through ``repro_torch.engine.api.Engine``,
            each with the launch counters set to 0 just before it and read
            just after: full-width, 32-layer LLaVA-1.5-7B with random bf16
            weights on E/P/D instances (four image+text greedy requests and
            one seeded sampled request; every attention and cache-write
            kernel must launch, decode with split-KV; device time by kernel
            of a steady decode step, with its merge-kernel and copy
            launches); then, with LLaVA's memory freed,
            full-width 64-layer falcon-mamba-7b on P/D instances (four
            greedy text requests of 200-600 tokens and one seeded sampled
            one; the scan must launch, each request's recurrent state must
            migrate P -> D; device time by kernel of a 512-token prefill
            chunk); then full-width whisper-small on E/P/D
            instances (five requests of one 1500x768 frame-embedding clip
            and 8-48 prompt tokens, same sampling mix; flash attention must
            launch in encode, prefill and decode, decode's cross-attention
            must take split-KV, each request's encoder output and cross K/V
            must migrate P -> D, and the embedding cache must hold a host
            copy of every encoder output); then full-width 24-layer
            granite-moe-1b-a400m and full-width DeepSeek-V2 cut to 4
            layers (MLA + MoE on a latent pool), each on P/D instances
            (five greedy/sampled text requests of 200-600 tokens as for
            falcon-mamba; every attention and cache-write kernel must
            launch (DeepSeek-V2's attention on the latent-row kernels,
            none of it on the other paged attention kernels), the K/V or
            latent rows must migrate P -> D; one
            profiled decode step at B = 4 with its MoE FFN's device time
            and the share of its matrix products); then full-width,
            81-layer zamba2-7b on P/D instances with falcon-mamba's
            request mix (the scan's per-head mode must launch 68 times a
            decode step and in every prefill call, Mamba-1's scan never,
            every paged attention and cache-write kernel must launch, each
            request's KV and 127.8 MB of recurrent state must migrate P ->
            D; device time by kernel of a 512-token prefill chunk and of a
            steady decode step at B = 4);
6. report - one JSON line of kernels (each split-KV merge keeps its own
            row: fused into its split kernel, its launches are the split
            calls, ``ms`` and ``standalone_*`` time the merge kernel alone,
            ``fused`` its share of the split calls; the ``*_latent`` rows
            are the latent-row kernels and ``cache_write_mla`` the
            576-wide write, at DeepSeek-V2's latent rows, their launches
            the DeepSeek-V2 path's; ``selective_scan_heads`` and the
            ``*_zamba2`` rows at zamba2-7b's widths, their launches the
            zamba2 path's), then the final status line.

Exits non-zero (and prints no status line) without a card or outside the
repository.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BYTES = 3.35e12                                  # H100 SXM HBM3, B/s
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}     # FLOP/s, dense
# kernel vs plain, max abs error.  f32 differs in summation order only.
# bf16 rounds each output to 8 bits: decode outputs average 40 to 4096 keys
# and stay small (measured error 4.9e-4 on H100; decode keeps P in f32, so
# one output rounding is all it adds), while the first rows of a
# prefill chunk see one to a few keys and keep values near 4, where one
# rounding is 1.6e-2 (measured 7.8e-3).  The bf16 latent-row decode at D =
# 576 runs on tensor cores but weighs P as hi + lo bf16 parts (P to about
# 16 bits), so the decode bar holds for it too; it is held against the
# plain version's f32 output.  The cache write copies exactly.
# The selective scan computes in f32 from the same inputs on both sides and
# returns f32, so bf16 inputs keep the f32 bar.
# Flash attention: f32 in summation order only; bf16 rounds each output
# once (values near 1 after averaging few keys round by up to 2^-8 ~ 4e-3,
# and the first causal rows see a single key, where outputs keep |v| up to
# ~4): the prefill bar of 2e-2.
# The bf16 attention tiles also round P to bf16 before P V, and sum l from
# the same rounded P, so numerator and denominator weigh each key alike:
# inside the same bars.  bf16 chunked prefill and flash attention are held
# against the plain version run in f32 on the same inputs (upcast), its
# output not rounded: the kernel's own error, not two roundings' sum.  The merge of split-KV partials rounds its output
# once and is checked alone into bf16 at flash's decode row (outputs
# average 1500 keys) and at paged decode's B = 8 (600-700 keys), where
# outputs stay below 1 in magnitude (checked): one rounding there is at
# most 2^-9 < 2e-3 (its own bar, which dropping one split of the partials
# must exceed; checked too).
TOL = {"paged_attention": {"float32": 1e-4, "bfloat16": 4e-3},
       "paged_prefill_attention": {"float32": 1e-4, "bfloat16": 2e-2},
       "cache_write": {"float32": 0.0, "bfloat16": 0.0},
       "selective_scan": {"float32": 1e-4, "bfloat16": 1e-4},
       "selective_scan_heads": {"float32": 1e-4, "bfloat16": 1e-4},
       "flash_attention": {"float32": 1e-4, "bfloat16": 2e-2},
       "flash_attention_merge": {"bfloat16": 2e-3},
       "paged_attention_merge": {"bfloat16": 2e-3}}
H, KH, D, PAGE, W = 32, 32, 128, 16, 4096             # llava-1.5-7b widths
D_INNER, N_STATE = 8192, 16                           # falcon-mamba-7b widths
ZH, ZP, ZN = 112, 64, 64                              # zamba2-7b Mamba-2
#                                           heads, head width, state size
ZAH, ZD = 32, 112                                     # zamba2-7b attention
#                                           heads (= KV heads), head dim
WH, WD, WT = 12, 64, 1500                             # whisper-small heads,
#                                                       head dim, frames
GH, GKH, GD, GL = 16, 8, 64, 24                       # granite-moe-1b-a400m
#                                  heads, KV heads, head dim, layers
MLA_H = 128                                           # deepseek-v2 heads
LATENT_DIMS = (80, 112, 576)                          # MLA latent rows R +
#                                          rope: reduced, 112, full width


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events (after a warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def time_ms_graph(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of one call's time in a replay of a CUDA graph
    that holds ``reps`` calls: the device time, without the host's cost of
    issuing each call (a wrapper's Python and its launches), which the
    back-to-back timing of ``time_ms`` includes once it exceeds the device
    time."""
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
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(out)


def time_ms_cold(fn, kernels: tuple, reps: int = 20) -> float:
    """Device time of one call with the 50 MB L2 flushed before it (a 64 MB
    buffer is written before each call): the mean over ``reps`` calls of
    the summed time of the kernels whose names contain one of
    ``kernels``, from a torch.profiler trace, so neither the flush nor the
    host's issue time falls inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(k in e.key for k in kernels))
    if us <= 0:
        raise AssertionError(f"no device time of {kernels} in the trace")
    return us / reps / 1e3


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_rate(per_clock: int) -> float:
    """Results per second of a unit that gives ``per_clock`` results per
    clock per SM, at the card's maximum SM clock as nvidia-smi reports
    it."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * per_clock * mhz * 1e6


def exp_rate() -> float:
    """Exponentials per second the card's special-function units give: 16
    results per clock per SM on sm_90 (the CUDA C++ Programming Guide's
    table of arithmetic-instruction throughput)."""
    return sm_rate(16)


def fma_rate() -> float:
    """f32 instructions (an FMA counts one) per second of the card's f32
    lanes: 128 per clock per SM on sm_90 (the same table)."""
    return sm_rate(128)


def dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def distinct_kv_rows(tables, n_keys) -> int:
    """Distinct (page, row) pairs behind the keys at positions < n_keys[b]
    of each lane: the bytes an attention call must read.  Padded table
    entries all name the one scratch page, which is read once."""
    t = tables.tolist()
    return len({(t[b][p // PAGE], p % PAGE)
                for b, n in enumerate(n_keys) for p in range(n)})


def paged_yardstick(q, kp, vp, tables, n_keys, qpos, flops):
    """The bound of a paged attention call (distinct K/V rows read once,
    q read and out written once, the table; or ``flops``) and its
    library yardstick: SDPA over K/V pre-gathered contiguous and expanded
    to the query heads, with the call's mask (keys < n_keys[b], and key
    <= qpos[b, row]).  q: [B, Sq, H, D]."""
    import torch
    import torch.nn.functional as F
    B, Sq, Hq, Dh = q.shape
    kh = kp.shape[2]
    S = tables.shape[1] * PAGE
    k, v = (x[tables.long()].reshape(B, S, kh, Dh).transpose(1, 2)
            .repeat_interleave(Hq // kh, dim=1) for x in (kp, vp))
    keys = torch.arange(S, device=q.device)
    n = torch.tensor(n_keys, device=q.device)
    mask = ((keys[None, None] < n[:, None, None])
            & (keys[None, None] <= qpos[:, :, None]))[:, None]
    qq = q.transpose(1, 2)
    isz = q.element_size()
    b_ms, b_by = bound(2 * q.numel() * isz
                       + 2 * distinct_kv_rows(tables, n_keys) * kh * Dh * isz
                       + tables.numel() * 4 + B * 4, flops, dname(q.dtype))

    def sdpa():
        return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)
    return {"bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(sdpa),
            "library_device_ms": time_ms_graph(sdpa)}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def paged_case(gen, dev, dtype, *, lens, n_pages_total, Kh=KH, Dh=D):
    """Random K/V pages (last page = scratch) and block tables: request b
    owns ceil(lens[b] / PAGE) distinct pages, padded lanes (lens None) and
    the tail of every row point at scratch."""
    import numpy as np
    import torch
    from repro_torch.engine.runner import bucket_pow2
    scratch = n_pages_total - 1
    max_pages = bucket_pow2(max(-(-(n or 1) // PAGE) for n in lens))
    kp = torch.randn((n_pages_total, PAGE, Kh, Dh), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((n_pages_total, PAGE, Kh, Dh), generator=gen,
                     device=dev).to(dtype)
    tables = np.full((len(lens), max_pages), scratch, np.int32)
    free = list(np.random.default_rng(len(lens)).permutation(scratch))
    for b, n in enumerate(lens):
        for j in range(-(-(n or 0) // PAGE)):
            tables[b, j] = free.pop()
    return kp, vp, torch.from_numpy(tables).to(dev), max_pages


def check(name, dtype, got, want, rows=None):
    import torch
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if rows is not None:
        g, w = g[rows], w[rows]
    err = (g - w).abs().max().item()
    tol = TOL[name.split("/")[0]][dname(dtype)]
    log({"check": name, "dtype": dname(dtype), "max_abs_err": err,
         "tol": tol})
    if not err <= tol:
        raise AssertionError(f"{name} {dname(dtype)}: max abs err {err} > "
                             f"{tol}")
    return err


NO_MERGE = {}     # split kernel libraries built without their fused merge


def start_no_merge_builds():
    """Start nvcc (all at once) on copies of the two split kernels' sources
    whose ``arrive_last`` answers false at once: every split block writes
    its partials and stops, no block merges.  Built under the ignored
    ``build/``, used only to time the merge's share of a split call.
    Returns the jobs for :func:`finish_no_merge_builds`."""
    import shutil
    from repro_torch.kernels import _build
    out = ROOT / "build" / "no_merge"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    header = out / "csrc" / "attn_merge.cuh"
    head = ("__device__ __forceinline__ bool arrive_last(unsigned* counter, "
            "int n_split) {\n")
    text = header.read_text()
    if head not in text:
        raise RuntimeError("attn_merge.cuh: arrive_last not where expected")
    header.write_text(text.replace(head, head + "  return false;\n", 1))
    return {n: (subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{n}.so"),
         str(out / "csrc" / f"{n}.cu")]), out / f"{n}.so")
        for n in ("paged_attention", "flash_attention")}


def finish_no_merge_builds(jobs):
    import ctypes
    for name, (proc, lib) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the no-merge {name}")
        NO_MERGE[name] = ctypes.CDLL(str(lib))


@contextlib.contextmanager
def no_merge(name: str):
    """Calls of ``name``'s wrapper launch the no-merge build meanwhile."""
    from repro_torch.kernels import _build
    keep = _build.load(name)
    _build._LIBS[name] = NO_MERGE[name]
    try:
        yield
    finally:
        _build._LIBS[name] = keep


def fused_share(name: str, call, device_ms: float) -> dict:
    """A split call's device time (``device_ms``, CUDA-graph replay) beside
    the same call's from the no-merge build: the fused merge's share."""
    with no_merge(name):
        bare = time_ms_graph(call)
    return {"split_call_device_ms": device_ms,
            "split_call_no_merge_device_ms": bare,
            "merge_share_device_ms": device_ms - bare}


def decode_cases(gen, dev, results):
    """Decode attention against its plain version: LLaVA's widths at B = 4
    and 8 (ctx 600-700), a 256-key window, GQA with 8 KV heads, whisper's
    decoder (H = Kh = 12, D = 64, under 64 keys: one split), granite-moe's
    (H = 16, Kh = 8, D = 64, ctx 200-600) and one lane of 4096 keys (many
    splits), f32 and bf16; at B = 8 bf16 the times warm
    (eager and CUDA-graph replay), with L2 flushed, and SDPA's on the same
    keys gathered contiguous; then the split-KV merge alone."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (tag, lens (None = padded lane), H, Kh, D, window)
    cases = [("b4", [600, 633, 700, None], H, KH, D, 0),
             ("b8", [600, 615, 631, 648, 656, 671, 689, 700], H, KH, D, 0),
             ("b4-window256", [600, 633, 700, None], H, KH, D, 256),
             ("b4-gqa-kh8", [600, 633, 700, None], H, 8, D, 0),
             ("whisper-b4", [40, 41, 45, 48], WH, WH, WD, 0),
             ("granite-b4", [200, 350, 480, 600], GH, GKH, GD, 0),
             ("b1-ctx4096", [4096], H, KH, D, 0)]
    errs = []
    for tag, lens, Hq, kh, Dh, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            kp, vp, tables, P = paged_case(gen, dev, dtype, lens=lens,
                                           n_pages_total=400, Kh=kh, Dh=Dh)
            B = len(lens)
            q = torch.randn((B, Hq, Dh), generator=gen, device=dev).to(dtype)
            lengths = torch.tensor([n or 1 for n in lens], dtype=torch.int32,
                                   device=dev)
            got = paged_attention(q, kp, vp, tables, lengths, window=window)
            want = paged_attention_ref(q, kp, vp, tables, lengths,
                                       window=window)
            err = check(f"paged_attention/{tag}", dtype, got, want)
            n_split = ops.decode_plan(B, Hq, kh, Dh, P, PAGE, sms)
            if dtype == torch.bfloat16:
                errs.append(err)
            if dtype == torch.bfloat16 and tag != "b8":
                row = {"n_split": n_split,
                       "device_ms": time_ms_graph(lambda: paged_attention(
                           q, kp, vp, tables, lengths, window=window))}
                if tag == "granite-b4":    # bound and SDPA beside it
                    n_keys = lengths.tolist()
                    row.update(paged_yardstick(
                        q[:, None], kp, vp, tables, n_keys,
                        (lengths.long() - 1)[:, None],
                        4 * sum(n_keys) * Hq * Dh))
                    row["bound_share"] = row["bound_ms"] / row["device_ms"]
                log({"timing": f"paged_attention/{tag}-bf16", **row})
            if tag == "b8" and dtype == torch.bfloat16:
                # yardstick: SDPA on the same keys, pre-gathered contiguous
                S = P * PAGE
                k = kp[tables.long()].reshape(B, S, kh, Dh).transpose(1, 2)
                v = vp[tables.long()].reshape(B, S, kh, Dh).transpose(1, 2)
                mask = (torch.arange(S, device=dev)[None]
                        < lengths[:, None])[:, None, None, :]
                qq = q[:, :, None, :]
                isz = q.element_size()
                nkeys = sum(lengths.tolist())
                rows_kv = distinct_kv_rows(tables, lengths.tolist())
                b_ms, b_by = bound(
                    2 * q.numel() * isz + 2 * rows_kv * kh * Dh * isz
                    + tables.numel() * 4 + B * 4,
                    4 * nkeys * Hq * Dh, dname(dtype))

                def call():
                    return paged_attention(q, kp, vp, tables, lengths)

                def sdpa():
                    return F.scaled_dot_product_attention(qq, k, v,
                                                          attn_mask=mask)
                row = {"shape": f"B={B} H={Hq} Kh={kh} D={Dh} page={PAGE} "
                                f"ctx 600-700 {dname(dtype)}",
                       "n_split": n_split, "ms": time_ms(call),
                       "device_ms": time_ms_graph(call),
                       "device_ms_cold_l2": time_ms_cold(
                           call, ("paged_decode_kernel",)),
                       "plain_ms": time_ms(lambda: paged_attention_ref(
                           q, kp, vp, tables, lengths)),
                       "library_ms": time_ms(sdpa),
                       "library_device_ms": time_ms_graph(sdpa),
                       "bound_ms": b_ms, "bound_by": b_by}
                row["bound_share"] = b_ms / row["device_ms"]
                row["bound_share_cold_l2"] = b_ms / row["device_ms_cold_l2"]
                results["paged_attention"] = row
                log({"timing": "paged_attention/b8-bf16", **row})
                fused = {"b8": fused_share("paged_attention", call,
                                           row["device_ms"])}
                paged_merge_case(q, kp, vp, tables, lengths, n_split, fused,
                                 results)
    results["paged_attention"]["max_abs_err"] = max(errs)


def paged_merge_case(q, kp, vp, tables, lengths, n_split, fused, results):
    """The decode merge (run by the split kernel's last blocks) as a kernel
    of its own at B = 8, on the plain partials of the split the plan picks,
    against the plain merge; its bar must catch a merge that loses a
    split.  ``fused``: its share of the split calls (:func:`fused_share`)."""
    import torch
    from repro_torch.kernels.paged_attention.ref import \
        paged_attention_partials_ref
    if n_split <= 1:
        raise AssertionError("decode at B = 8 must take split-KV")
    m, l, acc = paged_attention_partials_ref(q, kp, vp, tables, lengths,
                                             n_split)
    merge_check("paged_attention_merge", f"b8-n{n_split}", m[..., None],
                l[..., None], acc[..., None, :], results,
                fused_into="paged_decode_kernel", fused=fused)


def merge_check(name, tag, m, l, acc, results, *, fused_into: str,
                fused: dict):
    """The merge kernel of ``name`` (flash_attention_merge or
    paged_attention_merge) alone on partials m/l [n, B, H, Sq] and acc [n,
    B, H, Sq, D] into bf16, against the plain merge at its own bar, which
    the same kernel on partials with one live split dropped (l = 0) must
    miss.  Records the kernel's row: the same row merge runs in the last
    blocks of ``fused_into`` on the main path, where ``fused`` (by shape)
    gives its share of the split calls; ``ms`` (the line's key) and
    ``standalone_ms`` time the merge kernel alone."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import merge_partials_ref
    kernel = name[:-len("_merge")]
    n_split, B, Hq, Sq, Dh = acc.shape
    want = merge_partials_ref(m, l, acc)
    if not want.abs().max() < 1:
        raise AssertionError("the merge's bar assumes outputs below 1")
    bf = torch.bfloat16
    out = torch.empty((B, Hq, Sq, Dh), dtype=bf, device=acc.device)
    ops.merge_partials(m, l, acc, out, kernel=kernel)
    err = check(f"{name}/{tag}", bf, out, want)
    dropped = l.clone()
    dropped[n_split // 2] = 0
    fault = torch.empty_like(out)
    ops.merge_partials(m, dropped, acc, fault, kernel=kernel)
    fault_err = (fault.float() - want).abs().max().item()
    tol = TOL[name]["bfloat16"]
    log({"planted_fault": f"{name}, split {n_split // 2} of {n_split} "
                          "dropped",
         "max_abs_err": fault_err, "sound_max_abs_err": err, "tol": tol})
    if not fault_err > tol:
        raise AssertionError(f"{name} bar {tol} passes a dropped split "
                             f"({fault_err})")
    # each partial read once, the output written once; one FMA per
    # partial element on the CUDA cores
    b_ms, b_by = bound((2 * m.numel() + acc.numel()) * 4
                       + out.numel() * out.element_size(),
                       2 * acc.numel(), "float32")
    alone = time_ms(lambda: ops.merge_partials(m, l, acc, out, kernel=kernel))
    results[name] = {
        "shape": f"n_split={n_split} B={B} H={Hq} Sq={Sq} D={Dh} f32 "
                 f"partials -> bf16",
        "fused_into": fused_into,
        "launches_are": "split calls: each merges in its last blocks; ms "
                        "and standalone_* time the merge kernel alone, "
                        "fused its share of the split calls on the device",
        "ms": alone, "standalone_ms": alone,
        "standalone_device_ms": time_ms_graph(lambda: ops.merge_partials(
            m, l, acc, out, kernel=kernel)),
        "fused": fused,
        "plain_ms": time_ms(lambda: merge_partials_ref(m, l, acc)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err}


def prefill_cases(gen, dev, results):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import paged_prefill_attention
    from repro_torch.kernels.paged_attention.ref import \
        paged_prefill_attention_ref
    # (tag, ctx per lane (None = padded lane), C, valid rows per lane, H,
    # Kh, D, window); LLaVA's widths, then whisper-small's decoder prefill
    # (H = Kh = 12, D = 64: the D = 64 tile) with ragged valid rows, two
    # first chunks and two later ones, then granite-moe's (H = 16, Kh = 8,
    # D = 64) at its 512-token budget: a first chunk and a later one
    cases = [("text-c32", [600, 620, 650, None], 32, 32, H, KH, D, 0),
             ("media-c1024", [0], 1024, 576, H, KH, D, 0),
             ("text-c32-window128", [600, 620, 650, 1200], 32, 32, H, KH, D,
              128),
             ("text-c32-gqa-kh8", [600, 620, 650, None], 32, 32, H, 8, D, 0),
             ("whisper-c64", [0, 0, 64, 37], 64, [45, 22, 64, 20], WH, WH,
              WD, 0),
             ("granite-c512", [0, 512], 512, [512, 88], GH, GKH, GD, 0)]
    errs = []
    for tag, ctx, C, n_valid, Hq, kh, Dh, window in cases:
        if isinstance(n_valid, int):
            n_valid = [n_valid] * len(ctx)
        for dtype in (torch.float32, torch.bfloat16):
            # lane 3 of the window case sits past its table: every row's
            # window is empty there, which must still come out finite
            lens = [None if c is None or c >= 1000 else c + n
                    for c, n in zip(ctx, n_valid)]
            kp, vp, tables, P = paged_case(gen, dev, dtype, lens=lens,
                                           n_pages_total=400, Kh=kh, Dh=Dh)
            B = len(ctx)
            q = torch.randn((B, C, Hq, Dh), generator=gen,
                            device=dev).to(dtype)
            ctx_t = torch.tensor([c or 0 for c in ctx], dtype=torch.int32,
                                 device=dev)
            got = paged_prefill_attention(q, kp, vp, tables, ctx_t,
                                          window=window)
            want = paged_prefill_attention_ref(q.float(), kp.float(),
                                               vp.float(), tables, ctx_t,
                                               window=window)
            rows = slice(0, 3) if "window" in tag else None
            err = check(f"paged_prefill_attention/{tag}", dtype, got, want,
                        rows)
            if dtype == torch.bfloat16:
                errs.append(err)
            if tag == "media-c1024" and dtype == torch.bfloat16:
                S = tables.shape[1] * PAGE
                k = kp[tables.long()].reshape(B, S, kh, D).transpose(1, 2)
                v = vp[tables.long()].reshape(B, S, kh, D).transpose(1, 2)
                qpos = ctx_t[:, None] + torch.arange(C, device=dev)
                mask = (torch.arange(S, device=dev)[None, None]
                        <= qpos[:, :, None])[:, None]
                qq = q.transpose(1, 2)
                isz = q.element_size()
                # bytes: distinct K/V rows (the padded rows' keys all sit
                # on scratch); operations: every row of the padded chunk
                rows_kv = distinct_kv_rows(
                    tables, [min(c + C, S) for c in ctx_t.tolist()])
                pairs = sum(min(c + i + 1, S) for c in ctx_t.tolist()
                            for i in range(C))
                b_ms, b_by = bound(
                    2 * q.numel() * isz + 2 * rows_kv * kh * D * isz
                    + tables.numel() * 4 + B * 4,
                    4 * pairs * H * D, dname(dtype))
                # ctx 0 and S == C: the mask is the square causal triangle,
                # so the yardstick is SDPA's own causal path; the boolean
                # mask's time goes on the timing line beside it
                if ctx_t.tolist() != [0] or S != C:
                    raise AssertionError("media-c1024 must be the square "
                                         "causal case")
                masked_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qq, k, v, attn_mask=mask))
                results["paged_prefill_attention"] = {
                    "shape": f"B={B} C={C} ({n_valid[0]} valid) H={H} "
                             f"Kh={kh} D={D} ctx 0 {dname(dtype)}",
                    "ms": time_ms(lambda: paged_prefill_attention(
                        q, kp, vp, tables, ctx_t)),
                    "plain_ms": time_ms(lambda: paged_prefill_attention_ref(
                        q, kp, vp, tables, ctx_t)),
                    "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                        qq, k, v, is_causal=True)),
                    "bound_ms": b_ms, "bound_by": b_by}
                results["paged_prefill_attention"].update(
                    device_ms=time_ms_graph(lambda: paged_prefill_attention(
                        q, kp, vp, tables, ctx_t)),
                    library_device_ms=time_ms_graph(
                        lambda: F.scaled_dot_product_attention(
                            qq, k, v, is_causal=True)))
                log({"timing": "paged_prefill_attention/media-c1024-bf16",
                     **results["paged_prefill_attention"],
                     "library_masked_ms": masked_ms})
            if tag in ("text-c32", "whisper-c64", "granite-c512") \
                    and dtype == torch.bfloat16:
                row = {"ms": time_ms(lambda: paged_prefill_attention(
                           q, kp, vp, tables, ctx_t)),
                       "plain_ms": time_ms(lambda: paged_prefill_attention_ref(
                           q, kp, vp, tables, ctx_t)),
                       "device_ms": time_ms_graph(lambda: paged_prefill_attention(
                           q, kp, vp, tables, ctx_t))}
                if tag == "granite-c512":  # bound and SDPA beside it
                    # as for the image chunk: every row of the padded
                    # chunk is computed, over the keys its table holds
                    S = tables.shape[1] * PAGE
                    qpos = ctx_t.long()[:, None] + torch.arange(C, device=dev)
                    n_keys = [min(c + C, S) for c in ctx_t.tolist()]
                    pairs = sum(min(c + i + 1, S) for c in ctx_t.tolist()
                                for i in range(C))
                    row.update(paged_yardstick(q, kp, vp, tables, n_keys, qpos,
                                               4 * pairs * Hq * Dh))
                    row["bound_share"] = row["bound_ms"] / row["device_ms"]
                log({"timing": f"paged_prefill_attention/{tag}-bf16", **row})
    results.setdefault("paged_prefill_attention", {})["max_abs_err"] = \
        max(errs)


def cache_write_cases(gen, dev, results):
    """Writes into the full KV pool of one instance with the server's
    default kv_blocks=512: 2 x 32 x 513 x 16 x 4096 elements, past 2^31,
    at the last layer (offsets beyond 2^31 elements), from K and V as two
    separate planes (the model passes them so), the scratch block named as
    the model names it.  Every row not aimed at scratch must match the
    plain version bit for bit, and the scratch block must come out byte
    for byte as it was.  Timed at LLaVA's image chunk and at decode B = 8,
    each against the bytes it must move: every row not aimed at scratch
    read once and written once, and the slots.  Then granite-moe's writes
    (K and V planes of Kh * D = 512 into its 24-layer pool), checked and
    timed alike at its decode (B = 4) and a 512-token chunk."""
    import torch
    from repro_torch.kernels.cache_write.ops import paged_chunk_write
    from repro_torch.kernels.cache_write.ref import cache_write_ref
    T, NB, bs = 2, 512, PAGE
    # (tag, B, C, valid rows a lane): LLaVA's, then granite-moe's
    llava = (("decode-b8", 8, 1, 1), ("prefill-c1024", 1, 1024, 576))
    granite = (("granite-decode-b4", 4, 1, 1),
               ("granite-prefill-c512", 1, 512, 512))
    errs = []
    for pool_dtype, row_dtype, NBx, L, Wp, writes in (
            (torch.bfloat16, torch.bfloat16, NB, 32, W, llava),
            (torch.bfloat16, torch.float32, NB, 32, W, llava),
            (torch.float32, torch.float32, 64, 32, W, llava),
            (torch.bfloat16, torch.bfloat16, NB, GL, GKH * GD, granite)):
        pool = torch.randn((T, L, NBx + 1, bs, Wp), generator=gen,
                           device=dev).to(pool_dtype)
        if writes is llava and pool_dtype == torch.bfloat16 \
                and pool.numel() <= 2 ** 31:
            raise AssertionError("the pool must exceed 2^31 elements")
        scratch = NBx * bs
        for tag, B, C, n in writes:
            layer = L - 1
            perm = torch.randperm(NBx * bs, generator=gen, device=dev)
            slots = torch.full((B, C), scratch, dtype=torch.int32,
                               device=dev)
            slots[:, :n] = perm[:B * n].view(B, n).to(torch.int32)
            k, v = (torch.randn((B, C, Wp), generator=gen, device=dev)
                    .to(row_dtype) for _ in range(T))
            got = pool.clone()
            paged_chunk_write(got, layer, (k, v), slots, scratch=scratch)
            plane = (torch.arange(T, device=dev) * L + layer) * \
                ((NBx + 1) * bs)
            slot_vec = (plane[:, None] + slots.reshape(-1)[None].long()) \
                .reshape(-1)
            want = pool.clone()
            flat = want.view(-1, bs, Wp)
            rows2 = torch.stack([k, v]).reshape(-1, Wp)
            cache_write_ref(flat, rows2, slot_vec)
            err = check(f"cache_write/{tag}/rows-{dname(row_dtype)}",
                        pool_dtype, got[:, :, :NBx], want[:, :, :NBx])
            errs.append(err)
            if not torch.equal(got[:, :, NBx].view(torch.uint8),
                               pool[:, :, NBx].view(torch.uint8)):
                raise AssertionError(f"cache_write/{tag}: the kernel wrote "
                                     f"into the scratch block")
            if pool_dtype == row_dtype == torch.bfloat16:
                isz = k.element_size()
                n_dst = T * int((slots < scratch).sum())
                b_ms, b_by = bound(2 * n_dst * Wp * isz + slots.numel() * 4,
                                   0.0, dname(pool_dtype))

                def write():
                    paged_chunk_write(got, layer, (k, v), slots,
                                      scratch=scratch)
                row = {"shape": f"T=2 B={B} C={C} ({n} valid) w={Wp} from "
                                f"K and V planes into a {NBx + 1}-block "
                                f"{L}-layer pool {dname(pool_dtype)}",
                       "ms": time_ms(write),
                       "plain_ms": time_ms(lambda: cache_write_ref(
                           flat, rows2, slot_vec)),
                       "library_ms": time_ms(lambda: flat.view(-1, Wp)
                                             .index_copy_(0, slot_vec, rows2)),
                       "device_ms": time_ms_graph(write),
                       "library_device_ms": time_ms_graph(
                           lambda: flat.view(-1, Wp).index_copy_(0, slot_vec,
                                                                rows2)),
                       # as a step finds it: K/V and the pool rows not in
                       # L2 (a warm replay keeps the image chunk's 19 MB
                       # there, under the HBM bound)
                       "device_ms_cold_l2": time_ms_cold(
                           write, ("cache_write_kernel",)),
                       "bound_ms": b_ms, "bound_by": b_by}
                row["bound_share"] = b_ms / row["device_ms"]
                row["bound_share_cold_l2"] = b_ms / row["device_ms_cold_l2"]
                log({"timing": f"cache_write/{tag}-bf16", **row})
                if tag == "prefill-c1024":
                    results.setdefault("cache_write", {}).update(row)
                elif tag == "decode-b8":
                    results.setdefault("cache_write", {})["decode_b8"] = row
            del got, want, flat, k, v
        del pool
        torch.cuda.empty_cache()
    results["cache_write"]["max_abs_err"] = max(errs)


def latent_cases(gen, dev, results):
    """MLA's absorbed attention on the paged kernels: 1-KV-head MQA over
    latent rows (K and V the same pages) at D = 80 (reduced DeepSeek-V2),
    112 and 576 (full width), G = MLA_H query heads.  Decode at B = 8
    (ctx 600-700), f32 and bf16, and at D = 576 also one lane of 4096
    keys; chunked prefill of a 64-row chunk at B = 4 (a first chunk, two
    later ones, a padded lane), f32 and bf16; the single-plane width-576
    cache write of a decode step at B = 8 (a padded lane aimed at
    scratch), exact, the scratch block untouched.  bf16 at D = 576 runs on
    the latent-row wgmma kernels (csrc/attn_latent.cuh), held against the
    plain version's f32 output on the same inputs (upcast); the other
    widths on the CUDA-core decode and attn_mma.cuh's mma.sync tile, held
    as the other decode and prefill checks are.  At each D in bf16 the times of the decode at
    B = 8 and of one 512-token prefill chunk, and at D = 576 of the write,
    each beside its plain version, one PyTorch call (SDPA on the
    pre-gathered latent rows; index_copy_) and its bound; the kernels line
    takes the D = 576 rows (the decode also with L2 flushed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.cache_write.ops import paged_token_write
    from repro_torch.kernels.cache_write.ref import cache_write_ref
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_prefill_attention)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefill_attention_ref)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lens8 = [600, 615, 631, 648, 656, 671, 689, 700]
    errs = {"paged_attention": [], "paged_prefill_attention": []}

    def latent(Dl, dtype):             # the row of the kernels line it feeds
        return Dl == 576 and dtype == torch.bfloat16

    for Dl in LATENT_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            kp, _, tables, P = paged_case(gen, dev, dtype, lens=lens8,
                                          n_pages_total=400, Kh=1, Dh=Dl)
            B = len(lens8)
            q = torch.randn((B, MLA_H, Dl), generator=gen,
                            device=dev).to(dtype)
            lengths = torch.tensor(lens8, dtype=torch.int32, device=dev)
            got = paged_attention(q, kp, kp, tables, lengths)
            if latent(Dl, dtype):
                want = paged_attention_ref(q.float(), kp.float(), kp.float(),
                                           tables, lengths)
            else:
                want = paged_attention_ref(q, kp, kp, tables, lengths)
            err = check(f"paged_attention/mla-d{Dl}-g{MLA_H}", dtype, got, want)
            if latent(Dl, dtype):
                errs["paged_attention"].append(err)
            if dtype != torch.bfloat16:
                continue
            S = P * PAGE
            k = kp[tables.long()].reshape(B, 1, S, Dl) \
                .expand(B, MLA_H, S, Dl)
            mask = (torch.arange(S, device=dev)[None]
                    < lengths[:, None])[:, None, None, :]
            qq = q[:, :, None, :]
            isz = q.element_size()
            nkeys = sum(lens8)
            rows_kv = distinct_kv_rows(tables, lens8)
            # one read of each latent row serves as both K and V
            b_ms, b_by = bound(2 * q.numel() * isz + rows_kv * Dl * isz
                               + tables.numel() * 4 + B * 4,
                               4 * nkeys * MLA_H * Dl, dname(dtype))

            def call():
                return paged_attention(q, kp, kp, tables, lengths)

            def sdpa():
                return F.scaled_dot_product_attention(qq, k, k,
                                                      attn_mask=mask)
            row = {"shape": f"B={B} H={MLA_H} Kh=1 D={Dl} page={PAGE} "
                            f"ctx 600-700, K = V pages {dname(dtype)}",
                   "n_split": (ops.latent_decode_plan(
                       B, MLA_H, P, PAGE, sms, functools.partial(
                           ops.latent_max_clusters, 0))[0] if Dl == 576 else
                       ops.decode_plan(B, MLA_H, 1, Dl, P, PAGE, sms)),
                   "ms": time_ms(call), "device_ms": time_ms_graph(call),
                   "plain_ms": time_ms(lambda: paged_attention_ref(
                       q, kp, kp, tables, lengths)),
                   "library_ms": time_ms(sdpa),
                   "library_device_ms": time_ms_graph(sdpa),
                   "bound_ms": b_ms, "bound_by": b_by}
            row["bound_share"] = b_ms / row["device_ms"]
            if Dl == 576:
                row["device_ms_cold_l2"] = time_ms_cold(call,
                                                        ("latent_kernel",))
                row["bound_share_cold_l2"] = b_ms / row["device_ms_cold_l2"]
                results["paged_attention_latent"] = row
            log({"timing": f"paged_attention/mla-d{Dl}-bf16", **row})
            del k, mask
        # chunked prefill: lane 0 a first chunk, lanes 1-2 later chunks
        # (lane 2 with 30 valid rows), lane 3 padded
        ctx, C, n_valid = [0, 200, 450, None], 64, [64, 64, 30, 0]
        for dtype in (torch.float32, torch.bfloat16):
            lens = [None if c is None else c + n for c, n in zip(ctx, n_valid)]
            kp, _, tables, P = paged_case(gen, dev, dtype, lens=lens,
                                          n_pages_total=400, Kh=1, Dh=Dl)
            q = torch.randn((len(ctx), C, MLA_H, Dl), generator=gen,
                            device=dev).to(dtype)
            ctx_t = torch.tensor([c or 0 for c in ctx], dtype=torch.int32,
                                 device=dev)
            got = paged_prefill_attention(q, kp, kp, tables, ctx_t)
            want = paged_prefill_attention_ref(q.float(), kp.float(),
                                               kp.float(), tables, ctx_t)
            err = check(f"paged_prefill_attention/mla-d{Dl}-g{MLA_H}", dtype,
                        got[:2], want[:2])
            err = max(err, check(
                f"paged_prefill_attention/mla-d{Dl}-g{MLA_H}-ragged", dtype,
                got[2, :30], want[2, :30]))
            if latent(Dl, dtype):
                errs["paged_prefill_attention"].append(err)
    # the latent decode on one lane of 4096 keys (many splits)
    kp, _, tables, P = paged_case(gen, dev, torch.bfloat16, lens=[4096],
                                  n_pages_total=400, Kh=1, Dh=576)
    q = torch.randn((1, MLA_H, 576), generator=gen,
                    device=dev).to(torch.bfloat16)
    lengths = torch.tensor([4096], dtype=torch.int32, device=dev)
    errs["paged_attention"].append(check(
        f"paged_attention/mla-d576-g{MLA_H}-b1-ctx4096", torch.bfloat16,
        paged_attention(q, kp, kp, tables, lengths),
        paged_attention_ref(q.float(), kp.float(), kp.float(), tables,
                            lengths)))
    # one 512-token first chunk at each D, bf16: the prefill's timing rows
    C, dtype = 512, torch.bfloat16
    for Dl in LATENT_DIMS:
        kp, _, tables, P = paged_case(gen, dev, dtype, lens=[C],
                                      n_pages_total=40, Kh=1, Dh=Dl)
        q = torch.randn((1, C, MLA_H, Dl), generator=gen,
                        device=dev).to(dtype)
        ctx_t = torch.zeros(1, dtype=torch.int32, device=dev)
        S = tables.shape[1] * PAGE
        if S != C:
            raise AssertionError("the timed chunk must be the square "
                                 "causal case")
        k = kp[tables.long()].reshape(1, 1, S, Dl).expand(1, MLA_H, S, Dl)
        qq = q.transpose(1, 2)
        isz = q.element_size()
        b_ms, b_by = bound(2 * q.numel() * isz + C * Dl * isz
                           + tables.numel() * 4 + 4,
                           4 * (C * (C + 1) // 2) * MLA_H * Dl, dname(dtype))

        def chunk():
            return paged_prefill_attention(q, kp, kp, tables, ctx_t)

        def sdpa_chunk():
            return F.scaled_dot_product_attention(qq, k, k, is_causal=True)
        if Dl == 576:                  # checked at the timed shape too
            errs["paged_prefill_attention"].append(check(
                "paged_prefill_attention/mla-d576-c512", dtype, chunk(),
                paged_prefill_attention_ref(q.float(), kp.float(),
                                            kp.float(), tables, ctx_t)))
        row = {"shape": f"B=1 C={C} H={MLA_H} Kh=1 D={Dl} ctx 0, K = V "
                        f"pages {dname(dtype)}",
               "ms": time_ms(chunk), "device_ms": time_ms_graph(chunk, reps=5),
               "plain_ms": time_ms(lambda: paged_prefill_attention_ref(
                   q, kp, kp, tables, ctx_t), reps=3, rounds=3),
               "library_ms": time_ms(sdpa_chunk),
               "library_device_ms": time_ms_graph(sdpa_chunk, reps=5),
               "bound_ms": b_ms, "bound_by": b_by}
        row["bound_share"] = b_ms / row["device_ms"]
        if Dl == 576:
            results["paged_prefill_attention_latent"] = row
        log({"timing": f"paged_prefill_attention/mla-d{Dl}-c512-bf16",
             **row})
        del k, q, qq
    for name, e in errs.items():
        results[f"{name}_latent"]["max_abs_err"] = max(e)

    # the write of one decode step's latent rows: one plane, 1,152-byte rows
    L, NB, B, Dl = 3, 512, 8, 576
    pool = torch.randn((1, L, NB + 1, PAGE, Dl), generator=gen,
                       device=dev).to(dtype)
    scratch = NB * PAGE
    slots = torch.randperm(NB * PAGE, generator=gen, device=dev)[:B] \
        .to(torch.int32)
    slots[-1] = scratch + 7                       # a padded lane
    rows = torch.randn((1, B, Dl), generator=gen, device=dev).to(dtype)
    got = pool.clone()
    paged_token_write(got, L - 1, rows, slots, scratch=scratch)
    want = pool.clone()
    flat = want.view(-1, PAGE, Dl)
    slot_vec = (L - 1) * (NB + 1) * PAGE + slots.long()
    cache_write_ref(flat, rows.reshape(-1, Dl), slot_vec)
    err = check("cache_write/mla-d576-decode-b8", dtype, got[:, :, :NB],
                want[:, :, :NB])
    if not torch.equal(got[:, :, NB].view(torch.uint8),
                       pool[:, :, NB].view(torch.uint8)):
        raise AssertionError("cache_write/mla-d576: the kernel wrote into "
                             "the scratch block")
    isz = rows.element_size()
    b_ms, b_by = bound(2 * (B - 1) * Dl * isz + B * 4, 0.0, dname(dtype))

    def write():
        paged_token_write(got, L - 1, rows, slots, scratch=scratch)

    def index_copy():
        flat.view(-1, Dl).index_copy_(0, slot_vec, rows.reshape(-1, Dl))
    row = {"shape": f"T=1 B={B} ({B - 1} valid) w={Dl} into a {NB + 1}-block "
                    f"{L}-layer latent pool {dname(dtype)}",
           "ms": time_ms(write), "device_ms": time_ms_graph(write),
           "plain_ms": time_ms(lambda: cache_write_ref(
               flat, rows.reshape(-1, Dl), slot_vec)),
           "library_ms": time_ms(index_copy),
           "library_device_ms": time_ms_graph(index_copy),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    row["bound_share"] = b_ms / row["device_ms"]
    results["cache_write_mla"] = row
    log({"timing": "cache_write/mla-d576-decode-b8-bf16", **row})


def scan_inputs(gen, dev, B, S, dtype, d=D_INNER, N=N_STATE):
    """dt = 0.1 |z|, x, B, C ~ z; A = -|z| f32; a nonzero f32 state h0."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return ((rnd(B, S, d).abs() * 0.1).to(dtype), rnd(B, S, d).to(dtype),
            -rnd(d, N).abs(), rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype),
            rnd(B, d, N))


def scan_bound(B, S, isz, rate, d=D_INNER, N=N_STATE) -> tuple:
    """The least time of one scan call: each input read once (dt, x, B, C
    in their type; A and h0 in f32), y and h written once in f32; against
    the B*S*d*N exponentials over the special-function units and about 5
    f32 operations per (step, channel, state) over the f32 peak."""
    nbytes = (2 * B * S * d + 2 * B * S * N) * isz + d * N * 4 \
        + 2 * B * d * N * 4 + B * S * d * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(B * S * d * N / rate,
                5 * B * S * d * N / PEAK_OPS["float32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_cases(gen, dev, results, name, fn, ref, inputs, bound, widths,
               tail_dtype):
    """One mode of the selective scan against its plain version: prefill
    B = 1 and 4 at S = 512 from a nonzero state, decode B = 4 and 8, f32
    and bf16, timed beside ``bound(B, S, itemsize)``; then a tail of dt =
    0 (what the prefill mask makes of padded positions) that must leave
    the state exactly as the valid head left it.  ``inputs(gen, dev, B,
    S, dtype)`` makes (dt, x, A, B, C, h0); the B = 1 bf16 prefill is the
    kernels line's row."""
    import torch
    errs = []
    for tag, B, S in (("prefill-b1-s512", 1, 512), ("prefill-b4-s512", 4, 512),
                      ("decode-b4", 4, 1), ("decode-b8", 8, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            ins = inputs(gen, dev, B, S, dtype)
            y, h = fn(*ins)
            y_ref, h_ref = ref(*ins)
            errs += [check(f"{name}/{tag}/y", dtype, y, y_ref),
                     check(f"{name}/{tag}/h", dtype, h, h_ref)]
            b_ms, b_by = bound(B, S, ins[0].element_size())
            row = {"shape": f"B={B} S={S} {widths} {dname(dtype)} inputs, "
                            f"f32 state",
                   "ms": time_ms(lambda: fn(*ins)),
                   "plain_ms": time_ms(lambda: ref(*ins), reps=2, rounds=3),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            row["device_ms"] = time_ms_graph(lambda: fn(*ins))
            row["bound_share"] = b_ms / row["device_ms"]
            if tag == "prefill-b1-s512" and dtype == torch.bfloat16:
                results[name] = row
            else:
                log({"timing": f"{name}/{tag}-{dname(dtype)}", **row})
            del ins, y, h, y_ref, h_ref
    dt, x, A, Bm, Cm, h0 = inputs(gen, dev, 2, 512, tail_dtype)
    n = 384
    _, h_head = fn(dt[:, :n].contiguous(), x[:, :n].contiguous(), A,
                   Bm[:, :n].contiguous(), Cm[:, :n].contiguous(), h0)
    dt[:, n:] = 0
    y, h = fn(dt, x, A, Bm, Cm, h0)
    y_ref, h_ref = ref(dt, x, A, Bm, Cm, h0)
    errs += [check(f"{name}/zero-dt-tail/y", dt.dtype, y, y_ref),
             check(f"{name}/zero-dt-tail/h", dt.dtype, h, h_ref)]
    if not torch.equal(h, h_head):
        raise AssertionError(f"{name}: dt = 0 changed the state")
    log({"check": f"{name}/zero-dt-tail", "state_unchanged": True})
    results[name]["max_abs_err"] = max(errs)


def heads_inputs(gen, dev, B, S, dtype, Hh=ZH, P=ZP, N=ZN):
    """dt = 0.1 |z| per head, x, B, C ~ z; A = -|z| per head, f32; a
    nonzero f32 state h0 [B, H, P, N]."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return ((rnd(B, S, Hh).abs() * 0.1).to(dtype), rnd(B, S, Hh * P).to(dtype),
            -rnd(Hh).abs(), rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype),
            rnd(B, Hh, P, N))


def heads_bound(B, S, isz, fma, rate, Hh=ZH, P=ZP, N=ZN) -> tuple:
    """The least time of one per-head scan call: each input read once (x,
    dt, B, C in their type; A and h0 in f32), y and h written once in f32;
    against 3 f32 instructions per (step, channel, state) over the f32
    lanes (dt * x * B, the recurrence's FMA, y's FMA), plus one
    exponential per (step, head) over the special-function units."""
    d = Hh * P
    nbytes = (B * S * d + B * S * Hh + 2 * B * S * N) * isz + Hh * 4 \
        + 2 * B * d * N * 4 + B * S * d * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (3 * B * S * d * N / fma + B * S * Hh / rate) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zamba_attention_cases(gen, dev, results):
    """The paged kernels at zamba2-7b's shared attention (H = Kh = 32, D =
    112): decode at B = 8 (ctx 600-700) and a 512-token chunk (a first
    one and a later one at B = 2), f32 and bf16 (bf16 chunked prefill held
    against the plain version's f32 output); the bf16 calls timed beside
    their bound, plain version and SDPA on pre-gathered K/V."""
    import torch
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_prefill_attention)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefill_attention_ref)
    errs = {"paged_attention_zamba2": [], "paged_prefill_attention_zamba2": []}
    for dtype in (torch.float32, torch.bfloat16):
        lens = [600, 615, 631, 648, 656, 671, 689, 700]
        kp, vp, tables, _ = paged_case(gen, dev, dtype, lens=lens,
                                       n_pages_total=400, Kh=ZAH, Dh=ZD)
        B = len(lens)
        q = torch.randn((B, ZAH, ZD), generator=gen, device=dev).to(dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

        def call():
            return paged_attention(q, kp, vp, tables, lengths)

        def plain():
            return paged_attention_ref(q.float(), kp.float(), vp.float(),
                                       tables, lengths)
        errs["paged_attention_zamba2"].append(check(
            "paged_attention/zamba2-b8", dtype, call(), plain()))
        if dtype == torch.bfloat16:
            row = {"shape": f"B={B} H={ZAH} Kh={ZAH} D={ZD} page={PAGE} "
                            f"ctx 600-700 bf16",
                   "ms": time_ms(call), "device_ms": time_ms_graph(call),
                   "plain_ms": time_ms(plain),
                   **paged_yardstick(q[:, None], kp, vp, tables, lens,
                                     (lengths.long() - 1)[:, None],
                                     4 * sum(lens) * ZAH * ZD)}
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            results["paged_attention_zamba2"] = row

        ctx, C, n_valid = [0, 512], 512, [512, 88]
        kp, vp, tables, _ = paged_case(
            gen, dev, dtype, lens=[c + n for c, n in zip(ctx, n_valid)],
            n_pages_total=400, Kh=ZAH, Dh=ZD)
        q = torch.randn((len(ctx), C, ZAH, ZD), generator=gen,
                        device=dev).to(dtype)
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)

        def chunk():
            return paged_prefill_attention(q, kp, vp, tables, ctx_t)

        def chunk_plain():
            return paged_prefill_attention_ref(q.float(), kp.float(),
                                               vp.float(), tables, ctx_t)
        errs["paged_prefill_attention_zamba2"].append(check(
            "paged_prefill_attention/zamba2-c512", dtype, chunk(),
            chunk_plain()))
        if dtype == torch.bfloat16:
            # every row of the padded chunk is computed, over the keys its
            # table holds (as for granite-moe's chunk)
            S = tables.shape[1] * PAGE
            qpos = ctx_t.long()[:, None] + torch.arange(C, device=dev)
            n_keys = [min(c + C, S) for c in ctx]
            pairs = sum(min(c + i + 1, S) for c in ctx for i in range(C))
            row = {"shape": f"B=2 C={C} (512 + 88 valid) ctx 0 / 512 "
                            f"H={ZAH} Kh={ZAH} D={ZD} bf16",
                   "ms": time_ms(chunk), "device_ms": time_ms_graph(chunk),
                   "plain_ms": time_ms(chunk_plain),
                   **paged_yardstick(q, kp, vp, tables, n_keys, qpos,
                                     4 * pairs * ZAH * ZD)}
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            results["paged_prefill_attention_zamba2"] = row
    for name, e in errs.items():
        results[name]["max_abs_err"] = max(e)


def flash_cases(gen, dev, results, rate):
    """Flash attention at whisper-small's shapes (encoder self-attention,
    cross-attention of a prefill chunk and of a decode step, all over the
    1500 audio frames) and at the TPU kernel's other features: causal GQA,
    a 256-key window, a chunk after a cached prefix (kv_offset)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    # (tag, B, H, Kh, Sq, Sk, D, causal, window, kv_offset)
    cases = [("enc-self-b1", 1, WH, WH, WT, WT, WD, False, 0, 0),
             ("enc-self-b4", 4, WH, WH, WT, WT, WD, False, 0, 0),
             ("cross-prefill-b4-c64", 4, WH, WH, 64, WT, WD, False, 0, 0),
             ("cross-decode-b8", 8, WH, WH, 1, WT, WD, False, 0, 0),
             ("causal-gqa-s1024", 1, 32, 8, 1024, 1024, 128, True, 0, 0),
             ("causal-gqa-window256", 1, 32, 8, 1024, 1024, 128, True, 256,
              0),
             ("causal-gqa-offset768", 2, 32, 8, 256, 1024, 128, True, 0,
              768)]
    errs, fused = [], {}
    for tag, B, Hq, Kh, Sq, Sk, Dh, causal, window, off in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Hq, Sq, Dh), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn((B, Kh, Sk, Dh), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((B, Kh, Sk, Dh), generator=gen,
                            device=dev).to(dtype)
            kw = dict(causal=causal, window=window, kv_offset=off)
            got = flash_attention(q, k, v, **kw)
            want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
            err = check(f"flash_attention/{tag}", dtype, got, want)
            errs.append(err)
            if dtype != torch.bfloat16:
                continue
            # the (query, key) pairs this mask lets through
            qpos = off + torch.arange(Sq, device=dev)[:, None]
            kpos = torch.arange(Sk, device=dev)[None, :]
            mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos <= qpos
            if window:
                mask &= kpos > qpos - window
            pairs = int(mask.sum()) * B * Hq
            isz = q.element_size()
            nbytes = 2 * (q.numel() + k.numel()) * isz
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = max(4 * pairs * Dh / PEAK_OPS["bfloat16"],
                        pairs / rate) * 1e3
            # one PyTorch call on the same tensors: plain causal when the
            # mask is the square triangle, else the boolean mask
            sdpa_kw = {"enable_gqa": Kh != Hq}
            if causal and not window and not off and Sq == Sk:
                sdpa_kw["is_causal"] = True
            elif causal or window:
                sdpa_kw["attn_mask"] = mask
            row = {"shape": f"B={B} H={Hq} Kh={Kh} Sq={Sq} Sk={Sk} D={Dh} "
                            f"causal={int(causal)} window={window} "
                            f"kv_offset={off} bf16",
                   "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
                   "plain_ms": time_ms(lambda: flash_attention_ref(
                       q, k, v, **kw), reps=3, rounds=3),
                   "library_ms": time_ms(
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, **sdpa_kw)),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            row["device_ms"] = time_ms_graph(
                lambda: flash_attention(q, k, v, **kw))
            row["library_device_ms"] = time_ms_graph(
                lambda: F.scaled_dot_product_attention(q, k, v, **sdpa_kw))
            if tag.startswith("cross-"):
                fused[tag] = fused_share(
                    "flash_attention", lambda: flash_attention(q, k, v, **kw),
                    row["device_ms"])
            if tag == "cross-decode-b8":
                row["device_ms_cold_l2"] = time_ms_cold(
                    lambda: flash_attention(q, k, v, **kw),
                    ("flash_mma_kernel",))
                split_merge_case(q, k, v, kw, fused, results)
            if tag == "enc-self-b4":
                results["flash_attention"] = row
            log({"timing": f"flash_attention/{tag}", **row})
            del q, k, v, got, want
    results["flash_attention"]["max_abs_err"] = max(errs)


def split_merge_case(q, k, v, kw, fused, results):
    """The flash merge as a kernel of its own at the decode row's shape, on
    the plain partials of the split the plan picks (the split kernel and
    its fused merge are checked through flash_attention at every split
    shape).  ``fused``: its share of the split calls, by shape."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_partials_ref
    B, Hq, Sq, Dh = q.shape
    _, n_split = ops.split_plan(B, Hq, Sq, k.shape[2], Dh, 0)
    if n_split <= 1:
        raise AssertionError("the decode row must take split-KV")
    m, l, acc = flash_attention_partials_ref(q, k, v, n_split, **kw)
    merge_check("flash_attention_merge", f"cross-decode-b8-n{n_split}", m,
                l, acc, results, fused_into="flash_mma_kernel", fused=fused)


def ptxas_report(text: str) -> list:
    """[{"fn", "registers", "spill_bytes"}] for each kernel in an nvcc
    ``-Xptxas -v`` log (spill_bytes: stores + loads)."""
    import re
    out, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = {"fn": m.group(1), "registers": None, "spill_bytes": 0}
            out.append(fn)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            fn["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
    return out


def sass_hmma(card: str):
    """Count the tensor-core instructions in each bf16 attention kernel's
    SASS (``cuobjdump -sass`` of the built libraries): HMMA (mma.sync) in
    the attn_mma.cuh tiles, HGMMA (wgmma) in the latent-row kernel; fails
    when one has none of its kind."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts, hgmma = {}, {}
    for lib in ("paged_attention", "flash_attention"):
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        for part in sass.split("Function : ")[1:]:
            name = part.split(maxsplit=1)[0]
            lines = part.splitlines()
            if "mma_kernel" in name:
                counts[name] = sum("HMMA" in ln for ln in lines)
            if "latent_kernel" in name:
                hgmma[name] = sum("HGMMA" in ln for ln in lines)
    log({"sass_hmma": counts, "sass_hgmma": hgmma, "card": card})
    if not counts or not all(counts.values()):
        raise AssertionError(f"bf16 attention kernels without HMMA: {counts}")
    if not hgmma or not all(hgmma.values()):
        raise AssertionError(f"latent-row kernels without HGMMA: {hgmma}")


def check_ptxas(logs: dict):
    """Print each built kernel's registers and spills (``-Xptxas -v``);
    fails when the latent-row kernel or the scan's per-head mode (a 4 x 4
    tile of states a thread) spills."""
    for name, text in logs.items():
        report = ptxas_report(text)
        log({"ptxas": name, "kernels": report})
        for k in report:
            heads = "selective_scan_heads_kernel" in k["fn"]
            if "latent_kernel" in k["fn"] or heads:
                log({"ptxas_latent" if not heads else "ptxas_scan_heads": k})
                if k["spill_bytes"]:
                    raise AssertionError(f"{k['fn']} spills: {k}")


# ---------------------------------------------------------------------------
# phase 4: the runner on the card against the runner on the CPU
# ---------------------------------------------------------------------------
def model_check(seed: int):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import runner as R
    from repro_torch.models import model as M
    cfg = get_config("llava-1.5-7b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(seed))
    runners = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else M.init_params(
            cfg, torch.Generator().manual_seed(seed)).to(dev)
        runners[dev] = R.ModelRunner(cfg, p, R.RunnerCaches(
            cfg, kv_blocks=32, img_blocks=4, device=dev), device=dev)
    rng = np.random.default_rng(seed)
    worst = 0.0

    def compare(outs):
        nonlocal worst
        want, got = outs["cpu"], outs["cuda"]
        rel = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))
        worst = max(worst, rel)
        if not rel < 2e-4:
            raise AssertionError(f"model check: logits off by {rel} (rel)")
        return want

    toks = []
    for rid in range(3):
        prompt = rng.integers(0, cfg.vocab_size, 6 + 3 * rid).astype(np.int32)
        media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
                 * 0.1).astype(np.float32)
        outs = {}
        for dev, r in runners.items():
            r.encode([(rid, media)])
            r.prefill_chunk(rid, None, use_media=True)
            outs[dev] = r.prefill_chunk(rid, prompt)
        toks.append(int(np.argmax(compare(outs))))
    toks = np.asarray(toks)
    for _ in range(4):
        outs = {dev: r.decode([0, 1, 2], toks) for dev, r in runners.items()}
        toks = np.argmax(compare(outs), -1)
    log({"model_check": "reduced llava-1.5-7b f32, runner on cuda vs cpu",
         "steps": 3 + 4, "max_rel_logit_err": worst, "tol": 2e-4})


def mamba_model_check(seed: int):
    """Reduced falcon-mamba: a batched first chunk of three prompts of
    different lengths (padded lanes freeze their state), a second chunk
    for two of them, then four decode steps, on the card and on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import runner as R
    from repro_torch.models import model as M
    cfg = get_config("falcon-mamba-7b").reduced()
    runners = {}
    for dev in ("cpu", "cuda"):
        p = M.init_params(cfg, torch.Generator().manual_seed(seed)).to(dev)
        runners[dev] = R.ModelRunner(cfg, p, R.RunnerCaches(cfg, device=dev),
                                     device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (13, 6, 9)]
    worst, steps = 0.0, 0

    def compare(fn):
        nonlocal worst, steps
        want, got = fn(runners["cpu"]), fn(runners["cuda"])
        rel = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))
        worst, steps = max(worst, rel), steps + 1
        if not rel < 2e-4:
            raise AssertionError(f"mamba model check: logits off by {rel}")
        return want

    first = compare(lambda r: r.prefill_chunks([(0, prompts[0][:8], False),
                                                (1, prompts[1], False),
                                                (2, prompts[2][:5], False)]))
    last = compare(lambda r: r.prefill_chunks([(0, prompts[0][8:], False),
                                               (2, prompts[2][5:], False)]))
    toks = np.argmax(np.stack([last[0], first[1], last[1]]), -1)
    for _ in range(4):
        toks = np.argmax(compare(lambda r: r.decode([0, 1, 2], toks)), -1)
    log({"model_check": "reduced falcon-mamba-7b f32, runner on cuda vs cpu",
         "steps": steps, "max_rel_logit_err": worst, "tol": 2e-4})


def whisper_model_check(seed: int):
    """Reduced whisper-small: the audio encoder on three clips, a batched
    first prompt chunk of three lengths cross-attending each lane's own
    encoder output, a second chunk for two of them, then four decode steps
    over the cross K/V, on the card and on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import runner as R
    from repro_torch.models import model as M
    cfg = get_config("whisper-small").reduced()
    runners = {}
    for dev in ("cpu", "cuda"):
        p = M.init_params(cfg, torch.Generator().manual_seed(seed)).to(dev)
        runners[dev] = R.ModelRunner(cfg, p, R.RunnerCaches(
            cfg, kv_blocks=32, img_blocks=4, device=dev), device=dev)
    rng = np.random.default_rng(seed)
    clips = [(rng.standard_normal((cfg.media_tokens, cfg.d_model))
              * 0.1).astype(np.float32) for _ in range(3)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (13, 6, 9)]
    worst, steps = 0.0, 0

    def compare(fn):
        nonlocal worst, steps
        want, got = fn(runners["cpu"]), fn(runners["cuda"])
        rel = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))
        worst, steps = max(worst, rel), steps + 1
        if not rel < 2e-4:
            raise AssertionError(f"whisper model check: off by {rel}")
        return want

    for r in runners.values():
        r.encode([(i, c) for i, c in enumerate(clips)])
    compare(lambda r: np.concatenate([
        r.caches.states.get(i)["enc_out"].cpu().numpy() for i in range(3)]))
    first = compare(lambda r: r.prefill_chunks([(0, prompts[0][:8], False),
                                                (1, prompts[1], False),
                                                (2, prompts[2][:5], False)]))
    last = compare(lambda r: r.prefill_chunks([(0, prompts[0][8:], False),
                                               (2, prompts[2][5:], False)]))
    toks = np.argmax(np.stack([last[0], first[1], last[1]]), -1)
    for _ in range(4):
        toks = np.argmax(compare(lambda r: r.decode([0, 1, 2], toks)), -1)
    log({"model_check": "reduced whisper-small f32, runner on cuda vs cpu "
                        "(encoder output, then logits)",
         "steps": steps, "max_rel_err": worst, "tol": 2e-4})


def arch_model_check(arch: str, seed: int):
    """Reduced granite-moe or DeepSeek-V2 (MoE FFN; DeepSeek with latent
    attention over its MLA pool, head dim 80, one KV head), zamba2-7b
    (Mamba-2 layers and shared attention over the KV pool) or gemma3-4b
    (sliding window 16 on local layers, tied embeddings): a batched first
    chunk of three prompts of different lengths, a second chunk for two of
    them, then four decode steps, on the card and on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import runner as R
    from repro_torch.models import model as M
    cfg = get_config(arch).reduced()
    runners = {}
    for dev in ("cpu", "cuda"):
        p = M.init_params(cfg, torch.Generator().manual_seed(seed)).to(dev)
        runners[dev] = R.ModelRunner(cfg, p, R.RunnerCaches(
            cfg, kv_blocks=32, device=dev), device=dev)
    pools = {n for n, _ in runners["cuda"].caches.seq_pools()}
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (13, 6, 9)]
    worst, steps = 0.0, 0

    def compare(fn):
        nonlocal worst, steps
        want, got = fn(runners["cpu"]), fn(runners["cuda"])
        rel = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))
        worst, steps = max(worst, rel), steps + 1
        if not rel < 2e-4:
            raise AssertionError(f"{arch} model check: logits off by {rel}")
        return want

    first = compare(lambda r: r.prefill_chunks([(0, prompts[0][:8], False),
                                                (1, prompts[1], False),
                                                (2, prompts[2][:5], False)]))
    last = compare(lambda r: r.prefill_chunks([(0, prompts[0][8:], False),
                                               (2, prompts[2][5:], False)]))
    toks = np.argmax(np.stack([last[0], first[1], last[1]]), -1)
    for _ in range(4):
        toks = np.argmax(compare(lambda r: r.decode([0, 1, 2], toks)), -1)
    log({"model_check": f"reduced {arch} f32 (pools {sorted(pools)}), "
                        f"runner on cuda vs cpu",
         "steps": steps, "max_rel_logit_err": worst, "tol": 2e-4})


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def timed_calls(targets):
    """Accumulate wall seconds, calls and flash-attention launches (all,
    and the split calls among them) of each ``owner.name`` in ``targets``
    into the yielded {name: {"s", "calls", "flash_launches",
    "split_launches"}}; the originals come back on exit.  The runner's
    methods return host numpy, so their wall time covers the device work
    they started."""
    from repro_torch import kernels as K
    acc, saved = {}, []
    for owner, name in targets:
        fn = getattr(owner, name)
        saved.append((owner, name, fn))
        acc[name] = rec = {"s": 0.0, "calls": 0, "flash_launches": 0,
                           "split_launches": 0}

        def timed(*a, _fn=fn, _rec=rec, **k):
            t = time.perf_counter()
            n = K.launches["flash_attention"]
            n_split = K.launches["flash_attention_split"]
            try:
                return _fn(*a, **k)
            finally:
                _rec["s"] += time.perf_counter() - t
                _rec["calls"] += 1
                _rec["flash_launches"] += K.launches["flash_attention"] - n
                _rec["split_launches"] += \
                    K.launches["flash_attention_split"] - n_split
        setattr(owner, name, timed)
    try:
        yield acc
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def wall_split_targets():
    """Where a main path's wall time goes: runner stages, migrations, and
    within the migrations the transfer checksums."""
    from repro_torch.engine import paged_cache, runner, server
    return [(runner.ModelRunner, n) for n in ("encode", "prefill_chunks",
                                              "decode")] + \
        [(server.R, "migrate"), (paged_cache, "payload_checksum")]


def run_requests(eng, reqs, vocab: int):
    """Drive the requests through the Engine's streams; check each returns
    its tokens from the vocabulary.  Returns (token lists, wall s)."""
    import torch
    t0 = time.perf_counter()
    streams = [eng.generate(p, media=m, sampling=sp) for p, m, sp in reqs]
    outs = [s.tokens() for s in streams]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for (_, _, sp), toks in zip(reqs, outs):
        if len(toks) != sp.max_tokens:
            raise AssertionError(f"request produced {len(toks)} tokens, "
                                 f"expected {sp.max_tokens}")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"out-of-vocabulary token in {toks}")
    return [eng.result(s.rid).req for s in streams], outs, wall


def text_requests(rng, vocab: int, seed: int) -> list:
    """The text paths' mix: five requests of 200-600 prompt tokens, 16 new
    tokens, four greedy and one seeded sampled; [(prompt, None, params)]."""
    from repro_torch.core.request import SamplingParams
    reqs = []
    for i in range(5):
        prompt = rng.integers(0, vocab, int(rng.integers(200, 601)))
        sp = SamplingParams(max_tokens=16) if i < 4 else SamplingParams(
            temperature=0.8, top_k=50, top_p=0.95, seed=seed, max_tokens=16)
        reqs.append((prompt.astype("int32"), None, sp))
    return reqs


def request_metrics(rs) -> dict:
    ttft = [r.ttft() for r in rs]
    tpot = [t for r in rs for t in r.tpots()]
    t_first = min(r.first_token_time for r in rs)
    t_last = max(r.finish_time for r in rs)
    return {"ttft_s": ttft, "ttft_mean_s": statistics.mean(ttft),
            "tpot_mean_s": statistics.mean(tpot),
            "tpot_p90_s": sorted(tpot)[int(0.9 * (len(tpot) - 1))],
            "decode_tok_per_s": len(tpot) / (t_last - t_first)}


def check_reclaimed(srv):
    """Every pool back: blocks free, or (with prefix caching) parked
    unreferenced in the evictable pool, still indexed for later hits."""
    for inst in srv.instances:
        if inst.running or inst.waiting or inst.caches.states.store:
            raise AssertionError(f"instance {inst.iid} still holds work")
        for c in (inst.caches.kv, inst.caches.mla, inst.caches.img):
            if c is not None and (
                    c.tables or any(c.refcount)
                    or c.allocator.n_free + len(c.evictable)
                    != c.allocator.num_blocks):
                raise AssertionError(f"instance {inst.iid}: pool not "
                                     f"reclaimed")


def profile_calls(fn, what: str, card: str, tag: str, steps: int = 3,
                  ranges: tuple = ()):
    """Device time by kernel over ``steps`` calls of ``fn`` (torch.profiler
    with CUDA activity), the device's busy share of their wall time, and
    the launches per call of the split-KV merge kernel and of copy kernels
    (names with "copy" in them: CatArrayBatchedCopy of torch.stack and
    torch.cat, casts and copies).  For each name in ``ranges`` (a
    ``record_function`` range that ``fn`` opens) also the device time of
    the kernels launched inside it, and of the matrix products
    (``aten::mm``) among them, as shares of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []                    # device-side kernel events only: the
    for e in prof.key_averages():  # host ops above them carry the same time
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in ranges:
            continue                 # (a range's own span on the device too)
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    copies: dict = {}            # launches per call by (shortened) name
    for _, k, n in rows:
        if "copy" in k.lower():
            copies[k[:60]] = copies.get(k[:60], 0) + n / steps
    spans = {}
    for name in ranges:
        inside = [e for e in prof.events() if e.name == name
                  and e.device_type == torch.autograd.DeviceType.CPU]
        if not inside:
            raise AssertionError(f"no {name} range in the trace")

        def mm_us(e):
            return sum(c.device_time_total if c.name == "aten::mm"
                       else mm_us(c) for c in e.cpu_children)
        us = sum(e.device_time_total for e in inside)
        spans[name] = {"device_ms_per_call": us / steps / 1e3,
                       "share": us / busy if busy else None,
                       "matmul_share": sum(map(mm_us, inside)) / busy
                       if busy else None}
    log({"profile": f"{what}, {steps} calls",
         "path": tag, "card": card, "wall_ms_per_call": wall_us / steps / 1e3,
         "device_ms_per_call": busy / steps / 1e3,
         "device_busy_share": busy / wall_us if wall_us else None,
         "launches_per_call": sum(n for _, _, n in rows) / steps,
         "merge_kernel_launches_per_call": sum(
             n for _, k, n in rows if "merge_kernel" in k) / steps,
         "copy_launches_per_call": sum(copies.values()),
         "copy_kernels": copies, **({"ranges": spans} if spans else {}),
         "top": [{"kernel": k[:80], "ms_per_call": us / steps / 1e3,
                  "launches_per_call": n / steps}
                 for us, k, n in rows[:12]]})


def steady_decode(d, add, release, card: str, tag: str, ranges: tuple = ()):
    """Decode steps on the decode instance outside the scheduler, at B = 1
    and 4: the floor under TPOT.  ``add(rid)`` gives a request its cached
    context, ``release(rid)`` frees it; ``ranges`` go to the B = 4
    profile (:func:`profile_calls`)."""
    import numpy as np
    import torch
    steady = {}
    for B in (1, 4):
        rids = list(range(10_000, 10_000 + B))
        for rid in rids:
            add(rid)
        toks = np.zeros(B, np.int32)
        for _ in range(2):
            d.runner.decode(rids, toks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            d.runner.decode(rids, toks)
        steady[f"B={B}"] = (time.perf_counter() - t0) / 8 * 1e3
        if B == 4:
            profile_calls(lambda: d.runner.decode(rids, toks),
                          "steady decode step, B=4", card, tag, ranges=ranges)
        for rid in rids:
            release(rid)
    log({"steady_decode_ms_per_step": steady, "path": tag, "card": card})


def serve(seed: int, card: str):
    """LLaVA-1.5-7B, E1+P1+D1; returns the launch counts of its run."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core.request import SamplingParams
    from repro_torch.core.simulator import DisaggConfig
    from repro_torch.engine.api import Engine
    from repro_torch.models import model as M
    cfg = get_config("llava-1.5-7b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    eng = Engine(cfg, params, DisaggConfig({"E": 1, "P": 1, "D": 1}),
                 kv_blocks=256, img_blocks=8, device="cuda")
    log({"setup": "llava-1.5-7b full width, 32 layers, random bf16 weights",
         "weight_bytes": n_bytes, "setup_s": time.perf_counter() - t0})
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(5):
        media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
                 * 0.1).astype(np.float32)
        prompt = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
        sp = SamplingParams(max_tokens=16) if i < 4 else SamplingParams(
            temperature=0.8, top_k=50, top_p=0.95, seed=seed, max_tokens=16)
        reqs.append((prompt, media, sp))

    with timed_calls(wall_split_targets()) as split:
        K.reset_launches()
        rs, outs, wall = run_requests(eng, reqs, cfg.vocab_size)
        launches = dict(K.launches)
    for name in ("cache_write", "paged_attention", "paged_attention_split",
                 "paged_prefill_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"llava main path")
    srv = eng.server
    if srv.n_migrations < 2 * len(reqs):
        raise AssertionError(f"only {srv.n_migrations} migrations")
    check_reclaimed(srv)
    log({"main_path": "Engine E1+P1+D1, llava-1.5-7b bf16, 5 requests x "
                      "(576 image tokens + 32 prompt tokens), 16 new tokens",
         "card": card, "wall_s": wall, **request_metrics(rs),
         "migrations": srv.n_migrations, "migrated_bytes": srv.migrated_bytes,
         "launches": launches, "wall_split": split,
         "greedy_tokens_req0": outs[0]})

    d = next(i for i in srv.instances if i.role_name == "D")
    ctx = cfg.media_tokens + 32
    steady_decode(d, lambda rid: d.caches.kv.append(rid, torch.zeros(
        (2, cfg.num_layers, ctx, cfg.num_kv_heads * cfg.head_dim),
        dtype=torch.bfloat16, device="cuda")), d.caches.release, card,
        f"llava-1.5-7b, context {ctx}")
    return launches


def serve_mamba(seed: int, card: str):
    """falcon-mamba-7b, P1+D1; returns the launch counts of its run."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core.budgets import Budgets
    from repro_torch.core.simulator import DisaggConfig
    from repro_torch.engine.api import Engine
    from repro_torch.models import mamba
    from repro_torch.models import model as M
    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    # prefill chunks of up to 512 tokens per iteration
    eng = Engine(cfg, params, DisaggConfig({"P": 1, "D": 1}),
                 budgets=Budgets(512, 4), device="cuda")
    log({"setup": "falcon-mamba-7b full width, 64 layers, random bf16 "
                  "weights", "weight_bytes": n_bytes,
         "params": sum(p.numel() for p in params.parameters()),
         "setup_s": time.perf_counter() - t0})
    rng = np.random.default_rng(seed)
    reqs = text_requests(rng, cfg.vocab_size, seed)

    scan_shapes: dict = {}
    scan = mamba.selective_scan

    def recording_scan(dt, *a):
        key = f"B={dt.shape[0]} S={dt.shape[1]}"
        scan_shapes[key] = scan_shapes.get(key, 0) + 1
        return scan(dt, *a)

    with timed_calls(wall_split_targets()) as split:
        mamba.selective_scan = recording_scan
        try:
            K.reset_launches()
            rs, outs, wall = run_requests(eng, reqs, cfg.vocab_size)
            launches = dict(K.launches)
        finally:
            mamba.selective_scan = scan
    if launches["selective_scan"] <= 0:
        raise AssertionError("the selective scan never launched on the "
                             "falcon-mamba main path")
    srv = eng.server
    shapes = mamba.mamba1_cache_shape(cfg, 1)
    state_bytes = cfg.num_layers * (4 * int(np.prod(shapes["state"]))
                                    + 2 * int(np.prod(shapes["conv"])))
    if srv.n_migrations < len(reqs) or \
            srv.migrated_bytes != srv.n_migrations * state_bytes:
        raise AssertionError(f"{srv.n_migrations} migrations moved "
                             f"{srv.migrated_bytes} bytes; expected >= "
                             f"{len(reqs)} of {state_bytes} each")
    check_reclaimed(srv)
    log({"main_path": "Engine P1+D1, falcon-mamba-7b bf16 (f32 state), 5 "
                      "text requests of 200-600 prompt tokens, 16 new "
                      "tokens, token budget 512",
         "card": card, "wall_s": wall, **request_metrics(rs),
         "prompt_tokens": [len(p) for p, _, _ in reqs],
         "migrations": srv.n_migrations, "migrated_bytes": srv.migrated_bytes,
         "state_bytes_per_request": state_bytes, "launches": launches,
         "scan_calls_by_shape": scan_shapes, "wall_split": split,
         "greedy_tokens_req0": outs[0]})

    # one 512-token prefill chunk of a new request on the P instance, its
    # state freed after each call so every call starts from zero
    p = next(i for i in srv.instances if i.role_name == "P")
    chunk = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)

    def prefill_chunk():
        p.runner.prefill_chunks([(20_000, chunk, False)])
        p.caches.release(20_000)
    prefill_chunk()
    profile_calls(prefill_chunk, "prefill chunk of 512 tokens, B=1", card,
                  "falcon-mamba-7b")

    d = next(i for i in srv.instances if i.role_name == "D")
    zero = M.empty_state(cfg, dtype=torch.bfloat16, device="cuda")

    def add(rid):
        st = {f"mamba{i}": e for i, e in enumerate(zero["layers"])}
        d.caches.states.put(rid, {"ctx_len": 400, **st})
    steady_decode(d, add, d.caches.release, card,
                  "falcon-mamba-7b, context 400")
    return launches


def serve_moe(arch: str, seed: int, card: str):
    """granite-moe-1b-a400m at full width and depth, or DeepSeek-V2 at full
    width cut to 4 layers (one MLA_MLP, three MLA_MOE: 236 B parameters do
    not fit one card), P1+D1: five text requests of 200-600 prompt tokens,
    16 new tokens, four greedy and one seeded sampled; then one profiled
    decode step at B = 4 on the D instance.  Returns the launch counts of
    the run."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core.budgets import Budgets
    from repro_torch.core.simulator import DisaggConfig
    from repro_torch.engine.api import Engine
    from repro_torch.models import model as M
    from repro_torch.models import moe
    cfg = get_config(arch)
    mla = bool(cfg.kv_lora_rank)
    if mla:
        cfg = dataclasses.replace(cfg, num_layers=4)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    eng = Engine(cfg, params, DisaggConfig({"P": 1, "D": 1}),
                 budgets=Budgets(512, 4), device="cuda")
    log({"setup": f"{arch} full width, {cfg.num_layers} layers, random bf16 "
                  f"weights", "params": n_params,
         "weight_bytes": sum(p.numel() * p.element_size()
                             for p in params.parameters()),
         "setup_s": time.perf_counter() - t0})
    rng = np.random.default_rng(seed)
    reqs = text_requests(rng, cfg.vocab_size, seed)

    with timed_calls(wall_split_targets()) as split:
        K.reset_launches()
        rs, outs, wall = run_requests(eng, reqs, cfg.vocab_size)
        launches = dict(K.launches)
    # MLA's latent rows (bf16, D = 576) run on the latent-row kernels
    # only; the CUDA-core decode and the mma.sync prefill stay unlaunched
    attn = (("paged_attention_latent", "paged_prefill_attention_latent")
            if mla else ("paged_attention", "paged_prefill_attention"))
    for name in ("cache_write",) + attn:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{arch} main path")
    if mla and (launches["paged_attention"] or
                launches["paged_prefill_attention"]):
        raise AssertionError(f"{arch}: the latent rows went through the "
                             f"other paged kernels: {launches}")
    srv = eng.server
    d = next(i for i in srv.instances if i.role_name == "D")
    pool_name, pool = d.caches.seq_pools()[0]
    if [n for n, _ in d.caches.seq_pools()] != (["mla"] if mla else ["kv"]):
        raise AssertionError(f"{arch}: pools {d.caches.seq_pools()}")
    # each request's rows: its prompt (and first token) in every layer
    row_bytes = pool.spec.n_tensors * pool.spec.n_layers * pool.spec.width * 2
    if srv.n_migrations < len(reqs) or srv.migrated_bytes < sum(
            len(p) for p, _, _ in reqs) * row_bytes:
        raise AssertionError(f"{srv.n_migrations} migrations moved "
                             f"{srv.migrated_bytes} bytes")
    check_reclaimed(srv)
    log({"main_path": f"Engine P1+D1, {arch} bf16 ({cfg.num_layers} layers, "
                      f"{pool_name} pool of width {pool.spec.width}), 5 text "
                      f"requests of 200-600 prompt tokens, 16 new tokens, "
                      f"token budget 512",
         "card": card, "wall_s": wall, **request_metrics(rs),
         "prompt_tokens": [len(p) for p, _, _ in reqs],
         "migrations": srv.n_migrations, "migrated_bytes": srv.migrated_bytes,
         "launches": launches, "wall_split": split,
         "greedy_tokens_req0": outs[0]})

    # one decode step at B = 4 over random cached rows (context 400) and
    # random tokens, so the lanes route to different experts
    ctx, rids = 400, [10_000 + b for b in range(4)]
    spec = pool.spec
    for rid in rids:
        pool.append(rid, torch.randn((spec.n_tensors, spec.n_layers, ctx,
                                      spec.width), device="cuda")
                    .to(torch.bfloat16))
    toks = rng.integers(0, cfg.vocab_size, len(rids)).astype(np.int32)
    ffn = moe.moe_ffn

    def annotated(*a, **k):
        with torch.profiler.record_function("moe_ffn"):
            return ffn(*a, **k)
    d.runner.decode(rids, toks)
    moe.moe_ffn = annotated
    try:
        profile_calls(lambda: d.runner.decode(rids, toks),
                      "decode step, B=4", card,
                      f"{arch}, {cfg.num_layers} layers, context {ctx}",
                      ranges=("moe_ffn",))
    finally:
        moe.moe_ffn = ffn
    for rid in rids:
        d.caches.release(rid)
    return launches


def serve_zamba(seed: int, card: str):
    """zamba2-7b at full width and depth (68 Mamba-2 and 13 shared
    attention layers), P1+D1, with falcon-mamba's request mix: five text
    requests of 200-600 prompt tokens, 16 new tokens, four greedy and one
    seeded sampled.  The scan's per-head mode must launch 68 times in each
    decode step and a multiple of 68 in each prefill call, Mamba-1's scan
    never; every paged attention and cache-write kernel must launch; each
    request's KV and 127.8 MB of recurrent state must migrate P -> D.
    Then device time by kernel of one 512-token prefill chunk and of
    steady decode steps.  Returns the launch counts of the run."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA2
    from repro_torch.core.budgets import Budgets
    from repro_torch.core.simulator import DisaggConfig
    from repro_torch.engine import runner
    from repro_torch.engine.api import Engine
    from repro_torch.models import mamba
    from repro_torch.models import model as M
    cfg = get_config("zamba2-7b")
    n_mamba = cfg.layer_kinds().count(MAMBA2)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    eng = Engine(cfg, params, DisaggConfig({"P": 1, "D": 1}),
                 budgets=Budgets(512, 4), device="cuda")
    log({"setup": f"zamba2-7b full width, {cfg.num_layers} layers "
                  f"({n_mamba} Mamba-2), random bf16 weights",
         "params": sum(p.numel() for p in params.parameters()),
         "weight_bytes": sum(p.numel() * p.element_size()
                             for p in params.parameters()),
         "setup_s": time.perf_counter() - t0})
    rng = np.random.default_rng(seed)
    reqs = text_requests(rng, cfg.vocab_size, seed)

    # the per-head scan's launches inside each runner call, by stage
    stages = {n: {"calls": 0, "scan_launches": 0}
              for n in ("prefill_chunks", "decode")}
    saved = {}

    def counted(name):
        def call(*a, **k):
            n = K.launches["selective_scan_heads"]
            try:
                return saved[name](*a, **k)
            finally:
                stages[name]["calls"] += 1
                stages[name]["scan_launches"] += \
                    K.launches["selective_scan_heads"] - n
        return call
    with timed_calls(wall_split_targets()) as split:
        for n in stages:                # inside timed_calls' own wrappers
            saved[n] = getattr(runner.ModelRunner, n)
            setattr(runner.ModelRunner, n, counted(n))
        try:
            K.reset_launches()
            rs, outs, wall = run_requests(eng, reqs, cfg.vocab_size)
            launches = dict(K.launches)
        finally:
            for n, fn in saved.items():
                setattr(runner.ModelRunner, n, fn)
    for name in ("selective_scan_heads", "cache_write", "paged_attention",
                 "paged_prefill_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"zamba2-7b main path")
    if launches["selective_scan"]:
        raise AssertionError("zamba2-7b launched the Mamba-1 scan")
    dec, pre = stages["decode"], stages["prefill_chunks"]
    if not dec["calls"] or dec["scan_launches"] != n_mamba * dec["calls"] \
            or not pre["calls"] or pre["scan_launches"] % n_mamba \
            or pre["scan_launches"] < n_mamba * pre["calls"]:
        raise AssertionError(f"per-head scan launches by stage: {stages}")
    srv = eng.server
    shapes = mamba.mamba2_cache_shape(cfg, 1)
    state_bytes = n_mamba * (4 * int(np.prod(shapes["state"]))
                             + 2 * int(np.prod(shapes["conv"])))
    d = next(i for i in srv.instances if i.role_name == "D")
    spec = d.caches.kv.spec
    row_bytes = spec.n_tensors * spec.n_layers * spec.width * 2
    if srv.n_migrations < len(reqs) or \
            srv.migrated_bytes - srv.n_migrations * state_bytes < \
            sum(len(p) for p, _, _ in reqs) * row_bytes:
        raise AssertionError(f"{srv.n_migrations} migrations moved "
                             f"{srv.migrated_bytes} bytes; expected "
                             f"{state_bytes} of state each and every "
                             f"prompt's KV")
    check_reclaimed(srv)
    log({"main_path": f"Engine P1+D1, zamba2-7b bf16 (f32 state; KV pool of "
                      f"{spec.n_layers} attention layers, width "
                      f"{spec.width}), 5 text requests of 200-600 prompt "
                      f"tokens, 16 new tokens, token budget 512",
         "card": card, "wall_s": wall, **request_metrics(rs),
         "prompt_tokens": [len(p) for p, _, _ in reqs],
         "migrations": srv.n_migrations, "migrated_bytes": srv.migrated_bytes,
         "state_bytes_per_request": state_bytes,
         "kv_bytes_per_token": row_bytes, "launches": launches,
         "scan_heads_by_stage": stages, "wall_split": split,
         "greedy_tokens_req0": outs[0]})

    p = next(i for i in srv.instances if i.role_name == "P")
    chunk = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)

    def prefill_chunk():
        p.runner.prefill_chunks([(20_000, chunk, False)])
        p.caches.release(20_000)
    prefill_chunk()
    profile_calls(prefill_chunk, "prefill chunk of 512 tokens, B=1", card,
                  "zamba2-7b")

    ctx = 400
    zero = M.empty_state(cfg, dtype=torch.bfloat16, device="cuda")

    def add(rid):
        d.caches.kv.append(rid, torch.zeros(
            (spec.n_tensors, spec.n_layers, ctx, spec.width),
            dtype=torch.bfloat16, device="cuda"))
        d.caches.states.put(rid, {"ctx_len": ctx, **{
            f"mamba{i}": e for i, e in enumerate(zero["layers"]) if e}})
    # the step's gather of every lane's 68 states and conv prefixes into
    # batched tensors (torch.cat), timed on the device as its own range
    gather = runner.ModelRunner._batched_state

    def ranged(*a, **k):
        with torch.profiler.record_function("state_gather"):
            return gather(*a, **k)
    runner.ModelRunner._batched_state = ranged
    try:
        steady_decode(d, add, d.caches.release, card,
                      f"zamba2-7b, context {ctx}", ranges=("state_gather",))
    finally:
        runner.ModelRunner._batched_state = gather
    return launches


def serve_whisper(seed: int, card: str):
    """whisper-small, E1+P1+D1; returns the launch counts of its run."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core.request import SamplingParams
    from repro_torch.core.simulator import DisaggConfig
    from repro_torch.engine.api import Engine
    from repro_torch.models import model as M
    cfg = get_config("whisper-small")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    # prefix_cache: after each encode the server publishes the encoder
    # output to its embedding cache (a host copy of a device bf16 tensor)
    eng = Engine(cfg, params, DisaggConfig({"E": 1, "P": 1, "D": 1}),
                 prefix_cache=True, device="cuda")
    log({"setup": "whisper-small full width, 12 encoder + 12 decoder "
                  "layers, random bf16 weights", "weight_bytes": n_bytes,
         "params": sum(p.numel() for p in params.parameters()),
         "setup_s": time.perf_counter() - t0})
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(5):
        clip = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
                * 0.1).astype(np.float32)
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(8, 49))).astype(np.int32)
        sp = SamplingParams(max_tokens=16) if i < 4 else SamplingParams(
            temperature=0.8, top_k=50, top_p=0.95, seed=seed, max_tokens=16)
        reqs.append((prompt, clip, sp))

    with timed_calls(wall_split_targets()) as split:
        K.reset_launches()
        rs, outs, wall = run_requests(eng, reqs, cfg.vocab_size)
        launches = dict(K.launches)
    for name in ("cache_write", "paged_attention", "paged_prefill_attention",
                 "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"whisper main path")
    for stage in ("encode", "prefill_chunks", "decode"):
        if split[stage]["flash_launches"] <= 0:
            raise AssertionError(f"no flash-attention launch in {stage}")
    if split["decode"]["split_launches"] <= 0:
        raise AssertionError("decode's cross-attention never took split-KV")
    srv = eng.server
    row = cfg.media_tokens * cfg.d_model * 2          # one [T, d] bf16 row
    cross_bytes = (1 + 2 * cfg.num_layers) * row      # enc_out + xk/xv
    if srv.n_migrations != 2 * len(reqs) or \
            srv.migrated_bytes < len(reqs) * (row + cross_bytes):
        raise AssertionError(f"{srv.n_migrations} migrations moved "
                             f"{srv.migrated_bytes} bytes; expected "
                             f"{2 * len(reqs)} of >= {row + cross_bytes} "
                             f"per request")
    cached = list(srv.embed_cache.store.values())
    if len(cached) != len(reqs) or any(
            e.dtype != np.float32 or e.shape != (cfg.media_tokens,
                                                 cfg.d_model)
            for e in cached):
        raise AssertionError("the embedding cache did not take a host f32 "
                             "copy of every encoder output")
    check_reclaimed(srv)
    log({"main_path": "Engine E1+P1+D1, whisper-small bf16, 5 requests x "
                      "(one 1500x768 clip + 8-48 prompt tokens), 16 new "
                      "tokens",
         "card": card, "wall_s": wall, **request_metrics(rs),
         "prompt_tokens": [len(p) for p, _, _ in reqs],
         "migrations": srv.n_migrations, "migrated_bytes": srv.migrated_bytes,
         "migrated_bytes_per_request": srv.migrated_bytes / len(reqs),
         "cross_state_bytes_per_request": cross_bytes,
         "launches": launches, "wall_split": split,
         "greedy_tokens_req0": outs[0]})

    d = next(i for i in srv.instances if i.role_name == "D")
    kvd = cfg.num_kv_heads * cfg.head_dim
    zero = torch.zeros((1, cfg.media_tokens, kvd), dtype=torch.bfloat16,
                       device="cuda")
    ctx = 40

    def add(rid):
        d.caches.kv.append(rid, torch.zeros(
            (2, cfg.num_layers, ctx, kvd), dtype=torch.bfloat16,
            device="cuda"))
        st = {f"{n}{i}": zero for i in range(cfg.num_layers)
              for n in ("xk", "xv")}
        d.caches.states.put(rid, {"ctx_len": ctx, **st})
    steady_decode(d, add, d.caches.release, card,
                  f"whisper-small, context {ctx} + 1500 frames")
    return launches


# ---------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: needs a CUDA card; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log({"phase": "card", "torch": torch.__version__,
         "cuda": torch.version.cuda, "nvidia_smi": card})

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    jobs = start_no_merge_builds()
    logs = _build.build_all()
    finish_no_merge_builds(jobs)
    check_ptxas(logs)
    log({"phase": "build", "built": sorted(logs), "s": time.perf_counter() - t0})
    sass_hmma(card)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    results: dict = {}
    decode_cases(gen, dev, results)
    prefill_cases(gen, dev, results)
    cache_write_cases(gen, dev, results)
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import ref as scan_ref
    rate, fma = exp_rate(), fma_rate()
    scan_cases(gen, dev, results, "selective_scan", scan_ops.selective_scan,
               scan_ref.selective_scan_ref, scan_inputs,
               lambda B, S, isz: scan_bound(B, S, isz, rate),
               f"d={D_INNER} N={N_STATE}", torch.float32)
    torch.cuda.empty_cache()
    # the per-head mode (Mamba-2) at zamba2-7b's widths
    scan_cases(gen, dev, results, "selective_scan_heads",
               scan_ops.selective_scan_heads,
               scan_ref.selective_scan_heads_ref, heads_inputs,
               lambda B, S, isz: heads_bound(B, S, isz, fma, rate),
               f"H={ZH} P={ZP} N={ZN}", torch.bfloat16)
    torch.cuda.empty_cache()
    zamba_attention_cases(gen, dev, results)
    torch.cuda.empty_cache()
    flash_cases(gen, dev, results, rate)
    torch.cuda.empty_cache()
    latent_cases(gen, dev, results)
    torch.cuda.empty_cache()
    for name, r in results.items():
        log({"kernel": name, "card": card, **r})
    log({"phase": "kernels", "s": time.perf_counter() - t0})

    model_check(args.seed)
    mamba_model_check(args.seed)
    whisper_model_check(args.seed)
    for arch in ("granite-moe-1b-a400m", "deepseek-v2-236b", "zamba2-7b",
                 "gemma3-4b"):
        arch_model_check(arch, args.seed)
    launches = serve(args.seed, card)
    gc.collect()                      # LLaVA's weights and pools go first
    torch.cuda.empty_cache()
    launches["selective_scan"] = serve_mamba(args.seed,
                                             card)["selective_scan"]
    gc.collect()
    torch.cuda.empty_cache()
    whisper = serve_whisper(args.seed, card)
    for name in ("flash_attention", "flash_attention_split",
                 "flash_attention_merge"):
        launches[name] = whisper[name]
    gc.collect()
    torch.cuda.empty_cache()
    serve_moe("granite-moe-1b-a400m", args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    # the latent-row kernels and the 576-wide write count the DeepSeek-V2
    # path's launches
    deepseek = serve_moe("deepseek-v2-236b", args.seed, card)
    for name in ("paged_attention_latent", "paged_prefill_attention_latent"):
        launches[name] = deepseek[name]
    launches["cache_write_mla"] = deepseek["cache_write"]
    gc.collect()
    torch.cuda.empty_cache()
    # the per-head scan and the D = 112 attention rows count zamba2's
    zamba = serve_zamba(args.seed, card)
    launches["selective_scan_heads"] = zamba["selective_scan_heads"]
    for name in ("paged_attention", "paged_prefill_attention"):
        launches[f"{name}_zamba2"] = zamba[name]
    # a merge row's launches: the split calls, each merging in its last
    # blocks (the merge kernel alone never runs on the main paths)
    for name in ("paged_attention", "flash_attention"):
        if launches[f"{name}_merge"]:
            raise AssertionError(f"the {name} merge kernel launched on its "
                                 f"own on a main path")
        launches[f"{name}_merge"] = launches[f"{name}_split"]

    src = {"cache_write": ("src/repro_torch/csrc/cache_write.cu",
                           "src/repro/kernels/cache_write/kernel.py:25"),
           "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention/kernel.py:78"),
           "paged_attention_merge": (
               "src/repro_torch/csrc/attn_merge.cuh",
               "src/repro/kernels/paged_attention/kernel.py:78"),
           "paged_prefill_attention": (
               "src/repro_torch/csrc/paged_attention.cu",
               "src/repro/kernels/paged_attention/kernel.py:162"),
           "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                              "src/repro/kernels/selective_scan/kernel.py:51"),
           # the per-head mode: Mamba-2's recurrence (zamba2-7b)
           "selective_scan_heads": (
               "src/repro_torch/csrc/selective_scan.cu",
               "src/repro/kernels/selective_scan/kernel.py:51"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention/kernel.py:65"),
           "flash_attention_merge": (
               "src/repro_torch/csrc/attn_merge.cuh",
               "src/repro/kernels/flash_attention/kernel.py:65"),
           # MLA's latent rows (bf16, D = 576, one KV head, K = V)
           "paged_attention_latent": (
               "src/repro_torch/csrc/attn_latent.cuh",
               "src/repro/kernels/paged_attention/kernel.py:78"),
           "paged_prefill_attention_latent": (
               "src/repro_torch/csrc/attn_latent.cuh",
               "src/repro/kernels/paged_attention/kernel.py:162"),
           "cache_write_mla": ("src/repro_torch/csrc/cache_write.cu",
                               "src/repro/kernels/cache_write/kernel.py:25"),
           # zamba2-7b's shared attention (H = Kh = 32, D = 112)
           "paged_attention_zamba2": (
               "src/repro_torch/csrc/paged_attention.cu",
               "src/repro/kernels/paged_attention/kernel.py:78"),
           "paged_prefill_attention_zamba2": (
               "src/repro_torch/csrc/paged_attention.cu",
               "src/repro/kernels/paged_attention/kernel.py:162")}
    kernels = []
    for name, (source, replaces) in src.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        **{key: r[key] for key in (
                            "device_ms", "device_ms_cold_l2",
                            "library_device_ms", "bound_share",
                            "bound_share_cold_l2", "n_split",
                            "fused_into", "launches_are", "standalone_ms",
                            "standalone_device_ms", "fused", "decode_b8")
                           if key in r}})
    log({"total_s": time.perf_counter() - t_start, "card": card})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
