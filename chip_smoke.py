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
            (HMMA instructions; HGMMA, wgmma, in the latent-row kernel,
            in flash attention's bf16 backward, both bodies, all six
            (D, Dv) pairs, in its bf16 forward's wgmma body at the
            four wide pairs, and in the chunked prefill's wgmma body at
            D = 112, 128 and 160) and from ptxas that
            the latent-row kernel, every flash backward kernel, the
            forward's and the prefill's wgmma bodies (no C7520 either), the scan's
            per-head mode, its backward kernels (both modes) and the D =
            160 instances of decode and the chunked-prefill tile do not
            spill;
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
            with ragged valid rows), each bf16 chunk on the body its plan
            names (the profiler's kernel names and the wgmma counter;
            zamba2-7b's and stablelm-12b's 512-token chunks, later
            chunks of 1, 16, 32 and 64 rows, the CLI's 16-row chunks,
            and a window over 8-row pages, 32-row pages past the table
            and a padded lane at their widths, on the wgmma body
            paged_prefill_wgmma_kernel, bit-equal on repeat); the
            selective scan at falcon-mamba-7b widths (d = 8192, N = 16):
            prefill B = 1 and 4 at S = 512 from
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
            versions and SDPA, and the same at stablelm-12b's attention
            (H = 32, Kh = 8, D = 160) and at gemma3-4b's (H = 8, Kh = 4, D
            = 256; its chunks on the tile, logged, on no main path);
            flash attention's backward (csrc/flash_attention.cu,
            flash_attention_bwd) and the forward's new log-sum-exp against
            their plain versions at LLaVA-1.5-7B's training shape (B = 2,
            H = 32, S = 2624 = 2048 text + 576 image, D = 128, causal;
            bf16 and f32), llama3-8b's GQA (Kh = 8), whisper's encoder
            (D = 64, non-causal), a 256-key window, a ragged chunk after
            123 cached keys and a small f32 case (bf16 held against the
            f32 plain output; every call run twice, bit-equal), timed at
            LLaVA's, llama3-8b's and whisper's shapes beside each one's
            bound and SDPA's backward, and the forward with lse beside the
            forward row and SDPA's forward at the training shape;
            the selective scan's backward kernels against their plain
            backward: Mamba-1 at falcon-mamba-7b's training shape (B = 2,
            S = 2048, d = 8192, N = 16, bf16), in f32, and with h0 and
            dh_final at a ragged S; the per-head mode at zamba2-7b's
            widths (S = 2048, bf16; f32 with h0 and dh_final, ragged S);
            every call twice, bit-equal; the bf16 training shapes timed
            beside their bound and the plain backward;
            flash attention forward and backward at the other training
            widths, (D, Dv) = (112, 112), (160, 160), (256, 256) and MLA's
            (192, 128), f32 and bf16, causal GQA, window and kv_offset
            cases, the same in bf16 at head counts the plan sends to the
            forward's wgmma body, and the split path at D = 112 and 160
            (every call twice, bit-equal), and each at its model's
            training shape (zamba2-7b, stablelm-12b, gemma3-4b global and
            local layers, DeepSeek-V2; B = 2, S = 2048, bf16) timed beside
            the bound and SDPA's forward and backward; the profiler's
            kernel names show that the training shapes' and the wgmma
            cases' forward calls ran ``flash_fwd_wgmma_kernel`` and the
            split and decode-row calls ``flash_mma_kernel``;
4. model  - the port's runner on the card against the same runner on the
            CPU (plain versions) on reduced LLaVA, reduced falcon-mamba
            (batched chunks of different lengths) and reduced whisper-small
            (encoder output, batched chunks, decode over cross K/V),
            reduced granite-moe-1b-a400m, reduced DeepSeek-V2 (latent
            pool, D = 80), reduced zamba2-7b (Mamba-2 + shared attention)
            and reduced gemma3-4b (sliding window): logits per step;
   train  - reduced LLaVA-1.5-7B, falcon-mamba-7b, zamba2-7b and
            granite-moe-1b-a400m, and reduced DeepSeek-V2 (MLA at (192,
            128), an MLA + MLP and an MLA + MoE layer), zamba2-7b,
            stablelm-12b and gemma3-4b at their full head dims (112, 160,
            256) in f32: the loss and every gradient leaf
            of a training step on the card against the CPU (within 1e-4
            of the leaf's largest magnitude), each kernel's launches as
            remat makes them, and one train_step; then
            full-width LLaVA-1.5-7B cut to 16 layers, random bf16
            weights, 4 AdamW steps (lr 1e-4 after a 100-step warmup)
            with remat on one batch of B = 2 x
            (2048 text + 576 image) from train.data.batches: finite
            losses that fall, step time, tokens/s, peak memory, the
            flash forward (32) and backward (16) launches a step and no
            plain-version call on a CUDA tensor; then falcon-mamba-7b at
            full width cut to 32 layers and granite-moe-1b-a400m (24
            layers, not cut) the same way on B = 2 x 2048 text tokens:
            the scan forward (64) and backward (32) launches a step and
            the backward's share of a profiled step; the flash forward
            (48) and backward (24) launches, the aux loss and the share
            of dropped (token, expert) pairs a step; then zamba2-7b cut
            to 42 layers (35 Mamba-2, 7 shared-attention uses at D =
            112), gemma3-4b (34 layers, not cut, D = 256, 29 layers with a
            1,024-key window) and DeepSeek-V2 cut to its first layer (MLA
            at (192, 128) and the dense FFN) the same way, each step's
            flash (and zamba2's per-head scan) launches asserted, every
            flash forward call on the wgmma body; each
            phase's seconds logged; then the main of
            ``python -m repro_torch.train.train_mm`` at its mini config
            for 20 steps, its loss falling;
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
            (granite-moe's decode step must launch fewer kernels than
            the same step computing the MoE FFN's aux loss, which
            serving drops)
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
            every paged attention and cache-write kernel must launch, its
            512-token chunks on the chunked prefill's wgmma body, each
            request's KV and 127.8 MB of recurrent state must migrate P ->
            D; device time by kernel of a 512-token prefill chunk and of a
            steady decode step at B = 4); then the serving entry point
            ``repro_torch.launch.serve`` in process: the CLI on
            full-width LLaVA-1.5-7B E1+P1+D1 (its defaults: six requests,
            12 new tokens; every request's 12 tokens read from its
            printed lines, every attention and cache-write kernel must
            launch), its HTTP front on the same model (port 0: a
            non-streaming and a streaming greedy completion with an
            image part, their JSON body and SSE framing, the same tokens
            as ``Engine.generate`` on the same prompt ids and
            pseudo-embedding, ``/v1/models``, an unknown model's 404, TTFT
            over HTTP), the CLI on full-width 40-layer stablelm-12b P1+D1
            (every attention call a D = 160 instance), and ``--sim`` once
            (the simulator on the host); every path logs its chunked
            prefill's launches by body (``prefill_bodies``);
   dense  - (right after LLaVA's main path) the dense host-cache fallback
            (``device_cache=False``) on the same full-width LLaVA-1.5-7B:
            its runner against a paged runner on the same weights (3
            requests: encode, the image chunk, 32 prompt tokens, 8 decode
            steps fed the paged runner's greedy tokens; each step's
            logits within 2e-2 of the paged ones' largest), then
            ``Engine(..., device_cache=False)`` E1+P1+D1 with the main
            path's five requests, its TTFT, TPOT, wall and launches logged
            beside the main path's (the cache write, paged decode and
            flash attention must launch, the paged-prefill kernels never),
            then reduced f32 dense runners on the card against the CPU
            (LLaVA, gemma3-4b, whisper-small, falcon-mamba-7b, zamba2-7b,
            granite-moe-1b-a400m, DeepSeek-V2 at (192, 128)), 2e-4;
   sharded- (last) the sharded serving steps (``models/sharding.py``) on
            two ranks spawned on the one card, a (data, model) = (1, 2)
            mesh over gloo: full-width LLaVA-1.5-7B (one 576 x 4096
            image + 32 tokens, B = 2), granite-moe-1b-a400m (16 experts a
            rank) and falcon-mamba-7b, each rank drawing the full bf16
            weights from the seeded generator and keeping its cut;
            ``prefill`` and 8 ``decode_step``s fed the unsharded run's
            greedy tokens, against this process's unsharded run of the
            same weights on the card: in f32 (the weights upcast) within
            2e-4 of the largest logit with the same greedy tokens, in
            bf16 no farther from the f32 run than twice the unsharded
            bf16 run is; each rank must launch flash, decode and the cache
            write (the scan for falcon-mamba); each rank's weight bytes
            beside the whole tree's; then reduced f32 LLaVA, granite-moe
            and falcon-mamba at (1, 2) and (2, 1) on the card against
            their unsharded run on the CPU, 2e-4;
6. report - one JSON line of kernels (each split-KV merge keeps its own
            row: fused into its split kernel, its launches are the split
            calls, ``ms`` and ``standalone_*`` time the merge kernel alone,
            ``fused`` its share of the split calls; the ``*_latent`` rows
            are the latent-row kernels and ``cache_write_mla`` the
            576-wide write, at DeepSeek-V2's latent rows, their launches
            the DeepSeek-V2 path's; ``selective_scan_heads`` and the
            ``*_zamba2`` rows at zamba2-7b's widths, their launches the
            zamba2 path's; the ``*_d160`` rows at stablelm-12b's attention,
            their launches its CLI path's, ``cli_max_abs_err`` their error
            at the shapes of that path; ``selective_scan_bwd`` with the
            falcon-mamba training step's launches, and
            ``selective_scan_heads_bwd`` with the reduced zamba2 step's;
            ``flash_attention[_bwd]_d112``, ``_d160``, ``_d256`` and
            ``_mla`` at the wider training widths, their launches a
            training step's: zamba2-7b's, the reduced stablelm-12b
            step's, gemma3-4b's and DeepSeek-V2's; ``launches_dense`` on
            the rows of the kernels the dense phase runs: its Engine
            run's, the scans' its reduced falcon-mamba and zamba2
            checks'; ``launches_sharded`` on the rows of flash, decode,
            the cache write and the scan: each rank's over the sharded
            phase's three full-width bf16 runs), then the final status
            line.

Exits non-zero (and prints no status line) without a card or outside the
repository.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import re
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
# Decode over a few keys (the serve CLI's 17-27) keeps outputs up to ~3,
# where the bf16 store alone rounds by up to 2^-8 |o| (7.8e-3 at |o| = 2,
# past 4e-3 even when exactly rounded): there the decode bar is held on
# top of that rounding, |err| <= 4e-3 + |o| / 256.
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
SH, SKH, SD = 32, 8, 160                              # stablelm-12b heads,
#                                                       KV heads, head dim
WH, WD, WT = 12, 64, 1500                             # whisper-small heads,
#                                                       head dim, frames
GH, GKH, GD, GL = 16, 8, 64, 24                       # granite-moe-1b-a400m
#                                  heads, KV heads, head dim, layers
GMH, GMKH, GMD = 8, 4, 256                            # gemma3-4b heads, KV
#                                                       heads, head dim
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


PROFILER_TRIES = 3


def kernel_trace(run, found, cpu: bool = False):
    """A torch.profiler trace (CUDA activity, and CPU with ``cpu``) of
    ``run()`` in which ``found(prof)`` holds.  Now and then the profiler
    hands back a trace without the device events of kernels that did run;
    the trace is then taken anew, up to PROFILER_TRIES times.  Returns the
    profile and the wall seconds of ``run()``, or (None, None) when no try
    saw the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if cpu else []
    for attempt in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if found(prof):
            return prof, wall
        log({"profiler_miss": attempt + 1, "of": PROFILER_TRIES})
    return None, None


def device_us(prof, names: tuple) -> dict:
    """Summed device microseconds of the kernels whose names contain each
    of ``names``, in ``prof``."""
    import torch
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return {n: sum(e.self_device_time_total for e in events if n in e.key)
            for n in names}


def time_ms_cold(fn, kernels: tuple, reps: int = 20) -> float:
    """Device time of one call with the 50 MB L2 flushed before it (a 64 MB
    buffer is written before each call): the mean over ``reps`` calls of
    the summed time of the kernels whose names contain one of
    ``kernels``, from a torch.profiler trace, so neither the flush nor the
    host's issue time falls inside it.  Where no trace shows those
    kernels, CUDA events around each call after its flush time it (the
    host's issue time then falls inside)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()

    def run():
        for _ in range(reps):
            flush.zero_()
            fn()

    def total(prof):
        return sum(device_us(prof, kernels).values())
    prof, _ = kernel_trace(run, lambda p: total(p) > 0)
    if prof is not None:
        return total(prof) / reps / 1e3
    ms = 0.0
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms += a.elapsed_time(b)
    log({"timed_by_events": f"{kernels}, L2 flushed: no trace showed them"})
    return ms / reps


def device_ms_by_kernel(fn, names: tuple, reps: int = 5) -> dict:
    """Device time of one call of ``fn``, split by kernel: for each of
    ``names``, the summed time of the kernels whose names contain it, from
    a torch.profiler trace of ``reps`` calls (after a warm-up call).  A
    name that no trace showed reads None: not measured."""
    fn()

    def run():
        for _ in range(reps):
            fn()
    prof, _ = kernel_trace(
        run, lambda p: all(device_us(p, names).values()))
    if prof is None:
        log({"not_measured": f"device time of {names}: no trace showed "
                             "them"})
        return dict.fromkeys(names)
    return {n: us / reps / 1e3 for n, us in device_us(prof, names).items()}


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


def check(name, dtype, got, want, rows=None, rtol=0.0):
    """Max abs error of ``got`` against ``want``; fails unless every
    element is within the bar plus ``rtol`` |want|."""
    import torch
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if rows is not None:
        g, w = g[rows], w[rows]
    err = (g - w).abs().max().item()
    over = ((g - w).abs() - rtol * w.abs()).max().item()
    tol = TOL[name.split("/")[0]][dname(dtype)]
    log({"check": name, "dtype": dname(dtype), "max_abs_err": err,
         "tol": tol, **({"rtol": rtol, "max_err_over_rtol": over}
                        if rtol else {})})
    if not over <= tol:
        raise AssertionError(f"{name} {dname(dtype)}: max abs err {err} "
                             f"({over} over {rtol} |want|) > {tol}")
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
    from repro_torch.kernels.paged_attention.ops import (
        paged_prefill_attention, prefill_plan)
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
    errs, body_errs = [], []       # bf16; of those, on the wgmma body
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
                # the body the plan gives the call (its main paths' chunks)
                wgmma = prefill_plan(Dh, PAGE) == "wgmma"
                body = prefill_body(tag, lambda: paged_prefill_attention(
                    q, kp, vp, tables, ctx_t, window=window), wgmma)["want"]
                if wgmma:
                    body_errs.append(err)
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
                    "bound_ms": b_ms, "bound_by": b_by, "body": body}
                results["paged_prefill_attention"].update(
                    device_ms=time_ms_graph(lambda: paged_prefill_attention(
                        q, kp, vp, tables, ctx_t)),
                    library_device_ms=time_ms_graph(
                        lambda: F.scaled_dot_product_attention(
                            qq, k, v, is_causal=True)))
                row = results["paged_prefill_attention"]
                row["bound_share"] = row["bound_ms"] / row["device_ms"]
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
                           q, kp, vp, tables, ctx_t)), "body": body}
                if tag != "text-c32":  # the D = 64 tile: bound, SDPA
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
    if body_errs:
        results["paged_prefill_attention"]["wgmma_max_abs_err"] = \
            max(body_errs)


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


SCAN_CASES = (("prefill-b1-s512", 1, 512), ("prefill-b4-s512", 4, 512),
              ("decode-b4", 4, 1), ("decode-b8", 8, 1))
# the per-head mode also at B = 2 and at zamba2-7b's training shape
HEADS_CASES = SCAN_CASES[:1] + (("prefill-b2-s512", 2, 512),) + \
    SCAN_CASES[1:] + (("train-b2-s2048", 2, 2048),)
# Past 512 steps the f32 rounding of any evaluation order against the plain
# version's grows with the magnitudes it sums, not with |y|: y_t = h_t . C_t
# adds 64 products that cancel, and h carries its rounding over the memory
# of the slowest-decaying heads.  At 2,048 steps the per-head kernel misses
# 1e-4 absolute with f32 inputs (1.64e-4 and 2.48e-4 on two draws;
# tools/kernel_ab.py --scan-heads and this script, PERF.md).  So a row longer than LONG_SCAN_STEPS is held
# element-wise to 1e-4 plus LONG_SCAN_RTOL of the magnitude scale
# (scan_scale: the plain version on |x|, |B|, |C|, |h0|), a bar set between
# the sound kernels' largest reading and that of the plain version on
# TF32-rounded operands (tf32), which the f32 row must fail
LONG_SCAN_STEPS = 512
LONG_SCAN_RTOL = 2.0 ** -16


def tf32(t):
    """``t`` (f32) with its mantissa cut to TF32's 10 bits; other types as
    they are."""
    import torch
    if t.dtype != torch.float32:
        return t
    return (t.contiguous().view(torch.int32) & -(1 << 13)).view(torch.float32)


def scan_scale(ref, ins):
    """(y, h) of the plain version ``ref`` on |x|, |B|, |C| and |h0|:
    with dt >= 0 and A <= 0 each step's decay is in (0, 1], so these bound
    |y| and |h| element-wise and, for y, the sum of |h_n C_n| it cancels."""
    dt, x, A, Bm, Cm, h0 = ins
    return ref(dt, x.abs(), A, Bm.abs(), Cm.abs(),
               None if h0 is None else h0.abs())


def long_scan_reading(got, want, scale) -> dict:
    """The largest error of ``got`` against ``want``, absolute and over
    ``scale``, and how far the worst element lies past the long-scan bar
    (1e-4 + LONG_SCAN_RTOL scale; > 0 fails)."""
    err = (got.float() - want.float()).abs()
    sc = scale.float()
    return {"max_abs_err": err.max().item(),
            "max_err_over_scale": (err / sc.clamp_min(1e-30)).max().item(),
            "over_bar": (err - 1e-4 - LONG_SCAN_RTOL * sc).max().item()}


def long_scan_check(name, dtype, got, want, scale, control=None) -> float:
    """A scan output longer than LONG_SCAN_STEPS steps against the plain
    version's: fails unless every element is within 1e-4 +
    LONG_SCAN_RTOL ``scale``; and, given the plain version's output on
    TF32-rounded operands (``control``), unless that fails the bar.
    Returns the largest absolute error."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    read = long_scan_reading(got, want, scale)
    ctrl = None if control is None else long_scan_reading(control, want,
                                                          scale)
    log({"check": name, "dtype": dname(dtype), **read, "tol": 1e-4,
         "rtol_of_scale": LONG_SCAN_RTOL,
         **({"tf32_control": ctrl} if ctrl else {})})
    if not read["over_bar"] <= 0:
        raise AssertionError(f"{name} {dname(dtype)}: max abs err "
                             f"{read['max_abs_err']} past 1e-4 + "
                             f"{LONG_SCAN_RTOL} scale")
    if ctrl is not None and not ctrl["over_bar"] > 0:
        raise AssertionError(f"{name}: the bar does not catch TF32 operands")
    return read["max_abs_err"]


def scan_cases(gen, dev, results, name, fn, ref, inputs, bound, widths,
               tail_dtype, cases=SCAN_CASES):
    """One mode of the selective scan against its plain version at each
    (tag, B, S) of ``cases`` (prefill from a nonzero state, decode; the
    per-head mode also its training shape), f32 and bf16, timed beside
    ``bound(B, S, itemsize)``; then a tail of dt = 0 (what the prefill
    mask makes of padded positions) that must leave the state exactly as
    the valid head left it.  ``inputs(gen, dev, B, S, dtype)`` makes (dt,
    x, A, B, C, h0); the B = 1 bf16 prefill is the kernels line's row."""
    import torch
    errs = []
    for tag, B, S in cases:
        for dtype in (torch.float32, torch.bfloat16):
            ins = inputs(gen, dev, B, S, dtype)
            y, h = fn(*ins)
            y_ref, h_ref = ref(*ins)
            if S > LONG_SCAN_STEPS:
                scale = scan_scale(ref, ins)
                dt, x, A, Bm, Cm, h0 = ins
                ctrl = ref(dt, tf32(x), A, tf32(Bm), tf32(Cm), h0) \
                    if dtype == torch.float32 else (None, None)
                errs += [long_scan_check(f"{name}/{tag}/{part}", dtype, g, w,
                                         sc, c)
                         for part, g, w, sc, c in
                         (("y", y, y_ref, scale[0], ctrl[0]),
                          ("h", h, h_ref, scale[1], None))]
                del scale, ctrl
            else:
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


# The scan's backward against its plain backward on the same inputs,
# upcast, per output (ddt, dx, dA, dB, dC, dh0): f32 within 1e-4 of the
# output's largest magnitude (the same sums in another order: dB and dC
# over 8192 or 7168 channels, dA over B x S steps and lanes, the reverse
# recurrence with another rounding of its FMAs); bf16 the same plus
# |want| / 128 per element (ddt, dx, dB and dC are rounded once to bf16,
# 2^-8 relative at most, with a factor 2 of margin; dA and dh0 stay f32).
SCAN_BWD_TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-4, 1 / 128)}
SCAN_GRADS = ("ddt", "dx", "dA", "dB", "dC", "dh0")
# the scan backward's kernels, as ptxas and the profiler name them:
# Mamba-1's, the per-head mode's, and the fold of their partials
SCAN_BWD_KERNELS = ("selective_scan_bwd_kernel",
                    "selective_scan_heads_bwd_kernel", "fold_kernel")
# flash attention's forward instances that spill, keyed by (kernel, D,
# DV, NW or TM) as ptxas names them, with the bytes (stores + loads) it
# reported when they were built first (PERF.md run X2): the bf16 one-warp
# tiles above D = 128, the bf16 four-warp tile at D = 256, and the f32
# two-row tiles at D = 192 and 256.  Every other forward instance has none
FLASH_FWD_SPILL = {("flash_mma_kernel", 112, 112, 1): 568,
                   ("flash_mma_kernel", 160, 160, 1): 16,
                   ("flash_mma_kernel", 192, 128, 1): 32,
                   ("flash_mma_kernel", 256, 256, 1): 32,
                   ("flash_mma_kernel", 256, 256, 4): 192,
                   ("flash_kernel", 192, 128, 2): 8,
                   ("flash_kernel", 256, 256, 2): 16}


def scan_bwd_occupancy(heads: bool, dtype, grid_blocks=None,
                       N=None) -> dict:
    """One backward instance as the card runs it (the library's
    ``selective_scan_bwd_info``: threads and dynamic shared bytes a block,
    registers and local (spilled) bytes a thread, resident blocks an SM
    from the occupancy API; Mamba-1 at state size ``N`` (N_STATE when
    None), the per-head mode at ZN), and the waves a grid of
    ``grid_blocks`` takes on this card's SMs."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    fn = _build.function("selective_scan", "selective_scan_bwd_info",
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = (ctypes.c_int * 5)()
    err = fn(int(heads), 1 if dtype == torch.bfloat16 else 0,
             ZN if heads else (N or N_STATE), ctypes.addressof(out))
    if err:
        raise AssertionError(f"selective_scan_bwd_info failed: {err}")
    info = dict(zip(("threads", "smem_bytes", "registers", "local_bytes",
                     "blocks_per_sm"), out))
    if grid_blocks is not None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        info.update(grid_blocks=grid_blocks, sms=sms,
                    waves=-(-grid_blocks // (info["blocks_per_sm"] * sms)))
    return info


def scan_bwd_check(name, dtype, got, want) -> float:
    """Each gradient's largest error against its largest magnitude; fails
    unless every element is within the bar.  Returns the largest absolute
    error."""
    import torch
    tol, rtol = SCAN_BWD_TOL[dname(dtype)]
    errs = {}
    for part, g, w in zip(SCAN_GRADS, got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}/{part}: non-finite kernel output")
        err = (g - w).abs()
        top = w.abs().max().item()
        over = (err - tol * top - rtol * w.abs()).max().item()
        errs[part] = {"max_abs_err": err.max().item(), "max_abs_want": top,
                      "rel_to_max": err.max().item() / max(top, 1e-30)}
        if not over <= 0:
            raise AssertionError(f"{name}/{part} {dname(dtype)}: max abs err "
                                 f"{err.max().item()} against max |want| "
                                 f"{top}: over the bar by {over}")
    log({"check": name, "dtype": dname(dtype), "tol_rel_to_max": tol,
         "rtol": rtol, **errs})
    return max(e["max_abs_err"] for e in errs.values())


def scan_bwd_bound(B, S, d, N, isz, H=None, with_state=False) -> tuple:
    """The least time of one backward call: dt, x, B, C (inputs' type), A
    and dy (f32) read once, ddt, dx, dB, dC (inputs' type), dA and dh0
    (f32) written once (h0 and dh_final read once when given); against
    the larger of the f32 instructions per (step, channel, state) over
    the f32 lanes and one exponential per (step, channel, state) (Mamba-1;
    per-head mode: per step and head) over the special-function units.
    The instructions are the least the gradient needs, the state rebuilt
    from h_{t-1}: dt x B and its FMA into h_t (2), g a_{t+1} and its FMA
    with dy C into g_t (2), dC += dy h_t, dB += g dt x, dx += g B (3);
    then Mamba-1 takes q = g a h_{t-1} and adds dt q into dA and A q into
    ddt (3: 10 in all), the per-head mode, whose dA and ddt factor
    through one sum a step and head, adds g a h_{t-1} into it (1: 8)."""
    w = d if H is None else H
    a = d * N if H is None else H
    nbytes = 2 * (B * S * w + B * S * d + 2 * B * S * N) * isz \
        + 2 * a * 4 + B * S * d * 4 + B * d * N * 4 * (3 if with_state else 1)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    ops = 10 if H is None else 8
    t_ops = max(ops * B * S * d * N / fma_rate(),
                B * S * (d * N if H is None else H) / exp_rate()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bwd_cases(gen, dev, results):
    """Both backward kernels against their plain backward: Mamba-1 at
    falcon-mamba-7b's training shape (B = 2, S = 2048, d = 8192, N = 16,
    bf16), in f32 (S = 512), and with h0 and dh_final given at a ragged S;
    the per-head mode at zamba2-7b's widths (H = 112, P = 64, N = 64, S =
    2048, B = 1, bf16) and in f32 with h0 and dh_final at a ragged S.
    Every call twice, bit-equal; the bf16 training shapes timed (eager and
    CUDA-graph replay) beside the bound and the plain backward (no single
    PyTorch call computes this gradient: library none), with their
    instance's registers and blocks an SM and the waves of their grid.
    First logs every backward instance's occupancy (fails on local
    memory: a spill)."""
    import torch
    from repro_torch.kernels.selective_scan import ops as so
    from repro_torch.kernels.selective_scan import ref as sr
    for heads, N in ((False, 4), (False, 8), (False, 16), (True, ZN)):
        for dtype in (torch.float32, torch.bfloat16):
            info = scan_bwd_occupancy(heads, dtype, N=N)
            log({"scan_bwd_occupancy": "heads" if heads else "mamba1",
                 "N": N, "dtype": dname(dtype), **info})
            if info["local_bytes"]:
                raise AssertionError(f"scan backward spills: {info}")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    # (row, tag, B, S, H or None, dtype, h0 and dh_final given, timed)
    cases = [("selective_scan_bwd", "falcon-train", 2, TRAIN_S, None,
              torch.bfloat16, False, True),
             ("selective_scan_bwd", "f32", 1, 512, None, torch.float32,
              False, False),
             ("selective_scan_bwd", "h0-dhf-ragged", 2, 300, None,
              torch.bfloat16, True, False),
             ("selective_scan_heads_bwd", "zamba2-train", 1, TRAIN_S, ZH,
              torch.bfloat16, False, True),
             ("selective_scan_heads_bwd", "f32-h0-dhf-ragged", 1, 203, ZH,
              torch.float32, True, False)]
    errs = {}
    for row, tag, B, S, Hh, dtype, given, timed in cases:
        d, N = (D_INNER, N_STATE) if Hh is None else (ZH * ZP, ZN)
        w = d if Hh is None else Hh
        h_shape = (B, d, N) if Hh is None else (B, Hh, ZP, N)
        dt = (rnd(B, S, w).abs() * 0.1).to(dtype)
        x, Bm, Cm = rnd(B, S, d).to(dtype), rnd(B, S, N).to(dtype), \
            rnd(B, S, N).to(dtype)
        A = -(rnd(d, N) if Hh is None else rnd(Hh)).abs()
        dy = rnd(B, S, d)
        h0, dhf = (rnd(*h_shape), rnd(*h_shape)) if given else (None, None)
        fn = so.selective_scan_bwd if Hh is None else \
            so.selective_scan_heads_bwd
        ref = sr.selective_scan_bwd_ref if Hh is None else \
            sr.selective_scan_heads_bwd_ref

        def call():
            return fn(dt, x, A, Bm, Cm, h0, dy, dhf)
        got = call()
        torch.cuda.synchronize()
        want = ref(dt.float(), x.float(), A, Bm.float(), Cm.float(), h0, dy,
                   dhf)
        errs.setdefault(row, []).append(
            scan_bwd_check(f"{row}/{tag}", dtype, got, want))
        again = call()
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError(f"{row}/{tag}: not the same bits twice")
        log({"check": f"{row}/{tag}", "bit_equal_repeat": True})
        del got, want, again
        if timed:
            b_ms, b_by = scan_bwd_bound(B, S, d, N, dt.element_size(),
                                        Hh, given)
            r = {"shape": (f"B={B} S={S} d={d} N={N}" if Hh is None else
                           f"B={B} S={S} H={Hh} P={ZP} N={N}")
                 + f" {dname(dtype)} inputs, f32 dy ({tag})",
                 "ms": time_ms(call, reps=5, rounds=3),
                 "device_ms": time_ms_graph(call, reps=5, rounds=3),
                 "plain_ms": time_ms(lambda: ref(dt, x, A, Bm, Cm, h0, dy,
                                                 dhf), reps=1, rounds=2),
                 "library_ms": None, "library": "none: no single PyTorch "
                                                "call computes this gradient",
                 "bound_ms": b_ms, "bound_by": b_by}
            r["bound_share"] = b_ms / r["device_ms"]
            r["device_ms_by_kernel"] = device_ms_by_kernel(
                call, (SCAN_BWD_KERNELS[Hh is not None], "fold_kernel"))
            r["occupancy"] = scan_bwd_occupancy(
                Hh is not None, dtype,
                so.bwd_plan(B, S, d, N, Hh)["grid"][0] * B)
            results[row] = r
            log({"timing": f"{row}/{tag}", **r})
        del dt, x, Bm, Cm, A, dy, h0, dhf
        torch.cuda.empty_cache()
    for row, e in errs.items():
        results[row]["max_abs_err"] = max(e)


def width_attention_cases(gen, dev, results, tag, Hq, Kh, Dh, cli=False):
    """The paged kernels at one model's attention widths (``Hq`` query
    heads over ``Kh`` KV heads of ``Dh``; rows ``*_{tag}``): decode at B =
    8 (ctx 600-700) and a 512-token chunk (a first one and a later one at
    B = 2), f32 and bf16 (bf16 chunked prefill held against the plain
    version's f32 output); the bf16 calls timed beside their bound, plain
    version and SDPA on pre-gathered K/V; later bf16 chunks of
    ``SHORT_CHUNKS`` rows on the body the plan names.  zamba2-7b's shared
    attention (H = Kh = 32, D = 112) and stablelm-12b's (H = 32, Kh = 8, D
    = 160; ``cli``: also at the shapes its CLI run gives the kernels)."""
    import torch
    from repro_torch.kernels.paged_attention.ops import (
        PREFILL_WGMMA_DIMS, paged_attention, paged_prefill_attention,
        prefill_plan)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefill_attention_ref)
    dec, pre = f"paged_attention_{tag}", f"paged_prefill_attention_{tag}"
    errs = {dec: [], pre: []}
    body_errs = []                 # bf16 calls on the wgmma prefill body
    for dtype in (torch.float32, torch.bfloat16):
        lens = [600, 615, 631, 648, 656, 671, 689, 700]
        kp, vp, tables, _ = paged_case(gen, dev, dtype, lens=lens,
                                       n_pages_total=400, Kh=Kh, Dh=Dh)
        B = len(lens)
        q = torch.randn((B, Hq, Dh), generator=gen, device=dev).to(dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

        def call():
            return paged_attention(q, kp, vp, tables, lengths)

        def plain():
            return paged_attention_ref(q.float(), kp.float(), vp.float(),
                                       tables, lengths)
        errs[dec].append(check(f"paged_attention/{tag}-b8", dtype, call(),
                               plain()))
        if dtype == torch.bfloat16:
            row = {"shape": f"B={B} H={Hq} Kh={Kh} D={Dh} page={PAGE} "
                            f"ctx 600-700 bf16",
                   "ms": time_ms(call), "device_ms": time_ms_graph(call),
                   "plain_ms": time_ms(plain),
                   **paged_yardstick(q[:, None], kp, vp, tables, lens,
                                     (lengths.long() - 1)[:, None],
                                     4 * sum(lens) * Hq * Dh)}
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            results[dec] = row

        ctx, C, n_valid = [0, 512], 512, [512, 88]
        kp, vp, tables, _ = paged_case(
            gen, dev, dtype, lens=[c + n for c, n in zip(ctx, n_valid)],
            n_pages_total=400, Kh=Kh, Dh=Dh)
        q = torch.randn((len(ctx), C, Hq, Dh), generator=gen,
                        device=dev).to(dtype)
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)

        def chunk():
            return paged_prefill_attention(q, kp, vp, tables, ctx_t)

        def chunk_plain():
            return paged_prefill_attention_ref(q.float(), kp.float(),
                                               vp.float(), tables, ctx_t)
        got = chunk()
        errs[pre].append(check(f"paged_prefill_attention/{tag}-c512", dtype,
                               got, chunk_plain()))
        if dtype == torch.bfloat16:
            plan = prefill_plan(Dh, PAGE)
            if not torch.equal(got, chunk()):
                raise AssertionError(f"{pre} c512: two calls differ")
            body = prefill_body(f"{tag}-c512", chunk, plan == "wgmma")
            if plan == "wgmma":
                body_errs.append(errs[pre][-1])
            # bytes: q and out whole, the keys each table names; products:
            # the valid rows only (row i < n_valid[b] over its c + i + 1
            # keys), the work this chunk's data needs
            S = tables.shape[1] * PAGE
            qpos = ctx_t.long()[:, None] + torch.arange(C, device=dev)
            n_keys = [min(c + C, S) for c in ctx]
            pairs = sum(c + i + 1 for c, n in zip(ctx, n_valid)
                        for i in range(n))
            row = {"shape": f"B=2 C={C} (512 + 88 valid) ctx 0 / 512 "
                            f"H={Hq} Kh={Kh} D={Dh} bf16",
                   "ms": time_ms(chunk), "device_ms": time_ms_graph(chunk),
                   "plain_ms": time_ms(chunk_plain),
                   **paged_yardstick(q, kp, vp, tables, n_keys, qpos,
                                     4 * pairs * Hq * Dh),
                   "body": body["want"], "body_kernels": body["kernels"]}
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            results[pre] = row
            log({"timing": f"{pre}/c512", **row})
    # later chunks shorter than a 128-row block (a prompt's tail), on the
    # body the plan names
    for C in SHORT_CHUNKS:
        ctx, n_valid = [300, 500], [C, C // 2 + 1]
        kp, vp, tables, _ = paged_case(
            gen, dev, torch.bfloat16,
            lens=[c + n for c, n in zip(ctx, n_valid)], n_pages_total=400,
            Kh=Kh, Dh=Dh)
        q = torch.randn((len(ctx), C, Hq, Dh), generator=gen,
                        device=dev).bfloat16()
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)

        def short():
            return paged_prefill_attention(q, kp, vp, tables, ctx_t)
        got = short()
        err = check(f"paged_prefill_attention/{tag}-c{C}", torch.bfloat16,
                    got, paged_prefill_attention_ref(
                        q.float(), kp.float(), vp.float(), tables, ctx_t))
        if not torch.equal(got, short()):
            raise AssertionError(f"{pre} c{C}: two calls differ")
        wgmma = prefill_plan(Dh, PAGE) == "wgmma"
        prefill_body(f"{tag}-c{C}", short, wgmma)
        errs[pre].append(err)
        if wgmma:
            body_errs.append(err)
    if Dh in PREFILL_WGMMA_DIMS:
        body_errs.append(wgmma_prefill_cases(gen, dev, tag, Hq, Kh, Dh))
        errs[pre].append(body_errs[-1])
        results[pre]["wgmma_max_abs_err"] = max(body_errs)
    for name, e in errs.items():
        results[name]["max_abs_err"] = max(e)
    if cli:
        for name, e in cli_shape_cases(gen, dev, tag, Hq, Kh, Dh).items():
            results[name]["cli_max_abs_err"] = e


# later chunks under one 128-row block at each model's widths (ctx 300 /
# 500; a prompt's tail pads to a power of two)
SHORT_CHUNKS = (1, 16, 32, 64)

# bf16 chunks the plan sends to the wgmma body, beyond the timed c512 one:
# (C, ctx per lane, window, page, max_pages, padded lanes): a window over
# 8-row pages, 32-row pages with keys past the table, a padded lane and a
# lane whose window lies past its table
WGMMA_PREFILL = [(300, [30, 7], 40, 8, 42, ()),
                 (129, [0, 96], 0, 32, 4, ()),
                 (150, [10, 300, 0], 25, 16, 10, (2,))]


def wgmma_prefill_cases(gen, dev, tag, Hq, Kh, Dh) -> float:
    """The wgmma prefill body at one model's widths on WGMMA_PREFILL:
    against the plain version's f32 output (the bf16 bar) on the rows that
    see a key, exactly 0 on the rest, bit-equal on repeat, on the body
    (:func:`prefill_body`).  Returns the largest error."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention.ops import (
        paged_prefill_attention, prefill_plan)
    from repro_torch.kernels.paged_attention.ref import \
        paged_prefill_attention_ref
    worst = 0.0
    for C, ctx, window, page, max_pages, padded in WGMMA_PREFILL:
        n_pages = len(ctx) * max_pages + 1
        kp, vp = (torch.randn((n_pages, page, Kh, Dh), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        tables = np.full((len(ctx), max_pages), n_pages - 1, np.int32)
        free = list(np.random.default_rng(C).permutation(n_pages - 1))
        for b, c in enumerate(ctx):
            if b not in padded:
                for j in range(min(max_pages, -(-(c + C) // page))):
                    tables[b, j] = free.pop()
        tables = torch.from_numpy(tables).to(dev)
        q = torch.randn((len(ctx), C, Hq, Dh), generator=gen,
                        device=dev).bfloat16()
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
        case = f"{tag}-c{C}-p{page}-w{window}"
        if prefill_plan(Dh, page) != "wgmma":
            raise AssertionError(f"{case}: not planned on the wgmma body")

        def call():
            return paged_prefill_attention(q, kp, vp, tables, ctx_t,
                                           window=window)
        got = call()
        want = paged_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                           tables, ctx_t, window=window)
        qpos = ctx_t.long()[:, None] + torch.arange(C, device=dev)
        key = torch.arange(max_pages * page, device=dev)
        vis = key[None, None] <= qpos[:, :, None]
        if window:
            vis &= key[None, None] > qpos[:, :, None] - window
        seen = vis.any(-1)
        if got[~seen].any() or not torch.equal(got, call()):
            raise AssertionError(f"paged_prefill_attention/{case}: rows "
                                 f"without keys not 0, or two calls differ")
        worst = max(worst, check(f"paged_prefill_attention/{case}",
                                 torch.bfloat16, got[seen], want[seen]))
        prefill_body(case, call, True)
    return worst


# the shapes stablelm-12b's CLI run (six 16-token prompts, 12 new tokens)
# gives the paged kernels: decode at B = 2, 4 and 8 (the last with two
# padded lanes of length 1) over 17-27 keys in two table columns, and
# 16-row first chunks at B = 2 and 4
CLI_DECODE_LENS = [[27, 27], [17, 17, 17, 17],
                   [27, 27, 27, 27, 26, 26, None, None]]
CLI_CHUNK_B = [2, 4]


def cli_shape_cases(gen, dev, tag, Hq, Kh, Dh):
    """The paged kernels at the CLI run's shapes, f32 and bf16, held
    against their plain versions at the bars of the timed shapes (bf16
    decode on top of the store's rounding, see ``TOL``): decode in one
    split (``decode_plan`` must say 1, so the kernel writes out
    directly), chunks of 16 rows at ctx 0.  Returns the largest error of
    each kernel."""
    import torch
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefill_attention_ref)
    dec, pre = f"paged_attention_{tag}", f"paged_prefill_attention_{tag}"
    errs = {dec: [], pre: []}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for lens in CLI_DECODE_LENS:
            kp, vp, tables, P = paged_case(gen, dev, dtype, lens=lens,
                                           n_pages_total=32, Kh=Kh, Dh=Dh)
            B = len(lens)
            n_split = ops.decode_plan(B, Hq, Kh, Dh, P, PAGE, sms)
            if n_split != 1:
                raise AssertionError(f"{dec} cli-b{B}: {n_split} splits")
            q = torch.randn((B, Hq, Dh), generator=gen, device=dev).to(dtype)
            lengths = torch.tensor([n or 1 for n in lens], dtype=torch.int32,
                                   device=dev)
            errs[dec].append(check(
                f"paged_attention/{tag}-cli-b{B}", dtype,
                ops.paged_attention(q, kp, vp, tables, lengths),
                paged_attention_ref(q.float(), kp.float(), vp.float(),
                                    tables, lengths),
                rtol=2 ** -8 if dtype == torch.bfloat16 else 0.0))
        for B in CLI_CHUNK_B:
            kp, vp, tables, _ = paged_case(gen, dev, dtype, lens=[16] * B,
                                           n_pages_total=32, Kh=Kh, Dh=Dh)
            q = torch.randn((B, 16, Hq, Dh), generator=gen,
                            device=dev).to(dtype)
            ctx_t = torch.zeros(B, dtype=torch.int32, device=dev)
            errs[pre].append(check(
                f"paged_prefill_attention/{tag}-cli-b{B}-c16", dtype,
                ops.paged_prefill_attention(q, kp, vp, tables, ctx_t),
                paged_prefill_attention_ref(q.float(), kp.float(),
                                            vp.float(), tables, ctx_t)))
            if dtype == torch.bfloat16:
                prefill_body(f"{tag}-cli-b{B}-c16",
                             lambda: ops.paged_prefill_attention(
                                 q, kp, vp, tables, ctx_t),
                             ops.prefill_plan(Dh, PAGE) == "wgmma")
    return {name: max(e) for name, e in errs.items()}


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
    """[{"fn", "registers", "spill_bytes", "notes"}] for each kernel in an
    nvcc ``-Xptxas -v`` log (spill_bytes: stores + loads; notes: the count
    of each of ptxas's ``(C75xx)`` performance notes that names the
    kernel, such as C7520, ``wgmma.mma_async`` serialized)."""
    import re
    out, fn, notes = [], None, {}
    for line in text.splitlines():
        m = re.search(r"\((C75\d\d)\).*function '([^']+)'", line)
        if m:
            per = notes.setdefault(m.group(2), {})
            per[m.group(1)] = per.get(m.group(1), 0) + 1
            continue
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
    for k in out:
        k["notes"] = notes.get(k["fn"], {})
    return out


def sass_hmma(card: str):
    """Count the tensor-core instructions in each bf16 attention kernel's
    SASS (``cuobjdump -sass`` of the built libraries): HMMA (mma.sync) in
    the attn_mma.cuh tiles, HGMMA (wgmma) in the latent-row kernel, in
    flash attention's backward (``flash_bwd_*_wgmma_kernel``), in its
    forward's wgmma body (``flash_fwd_wgmma_kernel``) and in the chunked
    prefill's (``paged_prefill_wgmma_kernel``, D = 112, 128 and 160);
    fails when one has none of its kind, or when a backward or forward or
    prefill instance is missing."""
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
            if "latent_kernel" in name or "wgmma_kernel" in name:
                hgmma[name] = sum("HGMMA" in ln for ln in lines)
            elif "mma_kernel" in name:
                counts[name] = sum("HMMA" in ln for ln in lines)
    log({"sass_hmma": counts, "sass_hgmma": hgmma, "card": card})
    if not counts or not all(counts.values()):
        raise AssertionError(f"bf16 attention kernels without HMMA: {counts}")
    if not hgmma or not all(hgmma.values()):
        raise AssertionError(f"wgmma kernels without HGMMA: {hgmma}")
    bwd = [n for n in hgmma if "flash_bwd" in n]
    if len(bwd) != 12:
        # dK/dV and dQ x (D, Dv) = 64, 112, 128 (narrow body), 160, MLA's
        # (192, 128), 256 (wide body)
        raise AssertionError(f"flash backward wgmma kernels in SASS: {bwd}")
    fwd = [n for n in hgmma if "flash_fwd_wgmma_kernel" in n]
    if len(fwd) != 4:
        # (D, Dv) = (112, 112), (160, 160), (192, 128), (256, 256)
        raise AssertionError(f"flash forward wgmma kernels in SASS: {fwd}")
    pre = [n for n in hgmma if "paged_prefill_wgmma_kernel" in n]
    if len(pre) != 3:
        # D = 112, 128, 160
        raise AssertionError(f"paged prefill wgmma kernels in SASS: {pre}")


def check_ptxas(logs: dict):
    """Print each built kernel's registers and spills (``-Xptxas -v``);
    fails when the latent-row kernel, the scan's per-head mode (a 4 x 4
    tile of states a thread) or a D = 160 instance of the paged decode or
    chunked-prefill tile (stablelm-12b's head dim: ``paged_decode_kernel``
    or ``paged_prefill_mma_kernel`` with template argument ``Li160E`` in
    the mangled name) spills, or when no D = 160 instance of either was
    built; when a scan backward kernel (``selective_scan_bwd_kernel`` x 2
    types x 3 state sizes, ``selective_scan_heads_bwd_kernel`` x 2 types,
    ``fold_kernel`` x 2) spills or was not built;
    when a flash backward kernel spills, a flash backward ``wgmma`` kernel
    carries ptxas's note C7520 (its ``wgmma`` serialized), or one of its 26
    instances
    was not built (the delta kernel x 2 types; the bf16 wgmma kernels,
    ``flash_bwd_dkdv_wgmma_kernel`` and ``flash_bwd_dq_wgmma_kernel`` at D
    = 64, 112, 128 and the wide body's at (160, 160), (192, 128) and (256,
    256): ``_rows_`` (dQ at 160 and (192, 128), dK/dV at (192, 128)) or
    ``_wide_``; the f32 ones at all six (D, Dv) pairs); when the flash
    forward's wgmma body (``flash_fwd_wgmma_kernel`` at (112, 112), (160,
    160), (192, 128) and (256, 256)) spills, carries C7520 or lacks one of
    its four instances; when the chunked prefill's wgmma body
    (``paged_prefill_wgmma_kernel`` at D = 112, 128 and 160) spills,
    carries C7520 or lacks one of its three; and when a flash forward
    instance of the mma.sync
    tile or the f32 body spills more than :data:`FLASH_FWD_SPILL` allows
    it, or one of its 36 was not built (``flash_mma_kernel<D, NW, DV>`` at
    NW 1 and 4, ``flash_kernel<D, DV, TM>`` at TM 1, 2, 4 and 8, each at
    the six pairs)."""
    import re
    d160 = set()
    bwd, fwd_wgmma, pre_wgmma = [], [], []
    fwd = {}
    for name, text in logs.items():
        report = ptxas_report(text)
        log({"ptxas": name, "kernels": report})
        for k in report:
            m = re.search(r"(flash_mma_kernel|flash_kernel)ILi(\d+)ELi(\d+)"
                          r"ELi(\d+)EE", k["fn"])
            if m:
                a, b, c = (int(g) for g in m.groups()[1:])
                # flash_mma_kernel<D, NW, DV>, flash_kernel<D, DV, TM>
                key = ((m[1], a, c, b) if m[1] == "flash_mma_kernel" else
                       (m[1], a, b, c))
                fwd[key] = k["spill_bytes"]
            if "paged_prefill_wgmma_kernel" in k["fn"]:
                pre_wgmma.append(k)
                if k["spill_bytes"] or "C7520" in k["notes"]:
                    raise AssertionError(f"{k['fn']} spills or ptxas "
                                         f"serializes its wgmma: {k}")
            if "flash_bwd" in k["fn"] or \
                    "flash_fwd_wgmma_kernel" in k["fn"]:
                (bwd if "flash_bwd" in k["fn"] else fwd_wgmma).append(k)
                if k["spill_bytes"]:
                    raise AssertionError(f"{k['fn']} spills: {k}")
                if "wgmma_kernel" in k["fn"] and "C7520" in k["notes"]:
                    raise AssertionError(f"{k['fn']}: ptxas serializes its "
                                         f"wgmma (C7520): {k}")
            heads = "selective_scan_heads_kernel" in k["fn"]
            kind = ("decode" if "paged_decode_kernel" in k["fn"] else
                    "prefill" if "paged_prefill_mma_kernel" in k["fn"]
                    else None)
            wide = kind is not None and "Li160E" in k["fn"]
            if "latent_kernel" in k["fn"] or heads or wide:
                log({"ptxas_latent" if "latent_kernel" in k["fn"] else
                     "ptxas_scan_heads" if heads else "ptxas_d160": k})
                if k["spill_bytes"]:
                    raise AssertionError(f"{k['fn']} spills: {k}")
            if wide:
                d160.add(kind)
    if d160 != {"decode", "prefill"}:
        raise AssertionError(f"D = 160 instances built: {sorted(d160)}")
    scan_bwd = [k for text in logs.values() for k in ptxas_report(text)
                if any(n in k["fn"] for n in SCAN_BWD_KERNELS)]
    log({"ptxas_scan_bwd": scan_bwd})
    if any(k["spill_bytes"] for k in scan_bwd) or len(scan_bwd) != 10:
        # Mamba-1's backward x 2 types x N = 4, 8, 16; the per-head
        # mode's x 2 types (N = 64); the fold x 2 output types
        raise AssertionError(f"scan backward kernels built: {scan_bwd}")
    log({"ptxas_flash_bwd": bwd, "ptxas_flash_fwd_wgmma": fwd_wgmma,
         "ptxas_paged_prefill_wgmma": pre_wgmma})
    if len({k["fn"] for k in pre_wgmma}) != 3:
        raise AssertionError(f"paged prefill wgmma kernels built: "
                             f"{pre_wgmma}")
    if len({k["fn"] for k in fwd_wgmma}) != 4:
        raise AssertionError(f"flash forward wgmma kernels built: "
                             f"{fwd_wgmma}")
    names = {k["fn"] for k in bwd}
    if len(names) != 26 or sum("wgmma_kernel" in n for n in names) != 12:
        # delta x 2 types; dK/dV and dQ x 2 types (bf16 wgmma, f32) x 6
        # (D, Dv) pairs
        raise AssertionError(f"flash backward kernels built: {bwd}")
    worse = {str(key): (n, FLASH_FWD_SPILL.get(key, 0))
             for key, n in fwd.items() if n > FLASH_FWD_SPILL.get(key, 0)}
    log({"ptxas_flash_fwd_spills": {str(key): n for key, n in fwd.items()
                                    if n},
         "over_run_x2": worse})
    if len(fwd) != 36 or worse:
        # (spill bytes, the most allowed) of each instance over its amount
        raise AssertionError(f"flash forward instances: {len(fwd)} built "
                             f"of 36; spilling more than before: {worse}")


# ---------------------------------------------------------------------------
# training: flash attention's backward, the train step, train_mm
# ---------------------------------------------------------------------------
# bf16 backward held against the plain version run in f32 on the same
# (upcast) inputs: the forward's bar of 2e-2 (P rounded to bf16 on the
# tile, values of order 1), plus |want| / 128 per element: a gradient sums
# P- or dS-weighted rows over up to Sq queries (and G heads for dK/dV) and
# reaches |g| ~ 5-10 at these shapes, where the bf16 store alone rounds by
# up to |g| / 512 and the bf16 P and dS operands (2^-9 relative each) add
# as much again, twice over (a CPU emulation of those roundings at H = 8,
# Kh = 2, S = 1024 gave 1.8e-2 at |g| = 7.4).  f32 differs in summation
# order only: 1e-4.  lse: f32 1e-4; bf16 4e-3 (the tile sums l from P
# rounded to bf16, 2^-9 relative at most, so lse moves by under 2e-3).
BWD_TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 1 / 128)}
LSE_TOL = {"float32": 1e-4, "bfloat16": 4e-3}
TRAIN_LAYERS = 16        # LLaVA-1.5-7B's depth cut for one card (PERF.md)
FM_TRAIN_LAYERS = 32     # falcon-mamba-7b's depth cut for one card (PERF.md)
TRAIN_B, TRAIN_S = 2, 2048


def bwd_check(name, dtype, got, want):
    """Max abs error of each of (dq, dk, dv) against the plain version's;
    fails unless every element is within the bar plus rtol |want|."""
    import torch
    tol, rtol = BWD_TOL[dname(dtype)]
    errs = {}
    for part, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}/{part}: non-finite kernel output")
        err = (g - w).abs()
        over = (err - rtol * w.abs()).max().item()
        errs[part] = {"max_abs_err": err.max().item(),
                      "max_abs_want": w.abs().max().item(), "over": over}
        if not over <= tol:
            raise AssertionError(f"{name}/{part} {dname(dtype)}: max abs err "
                                 f"{err.max().item()} ({over} over {rtol} "
                                 f"|want|) > {tol}")
    log({"check": name, "dtype": dname(dtype), "tol": tol, "rtol": rtol,
         **errs})
    return max(e["max_abs_err"] for e in errs.values())


def flash_bwd_cases(gen, dev, results, rate):
    """Flash attention's backward kernel (and the forward's lse) against
    their plain versions: LLaVA-1.5-7B's training shape, llama3-8b's GQA,
    whisper's encoder (D = 64, non-causal), a window, f32 at a small shape
    and a ragged chunk after cached keys; timed at LLaVA's, llama3-8b's and
    whisper's shapes beside each one's bound and SDPA's backward.  Also the
    forward with lse at the training shape (with SDPA's forward beside it)
    and at the forward row's (whisper encoder) shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_fwd,
        split_plan)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    S = TRAIN_S + 576
    # the bf16 shapes timed beside their bound and SDPA's backward
    TIMED = {"llava-train": f"LLaVA-1.5-7B training: {TRAIN_S} text + 576 "
                            f"image positions",
             "llama3-gqa": "llama3-8b's GQA",
             "whisper-enc": "whisper-small's encoder, D = 64"}
    others = []
    # (tag, B, H, Kh, Sq, Sk, D, causal, window, kv_offset, dtypes)
    cases = [("llava-train", TRAIN_B, H, KH, S, S, D, True, 0, 0,
              (torch.bfloat16, torch.float32)),
             ("llama3-gqa", 1, 32, 8, 2048, 2048, 128, True, 0, 0,
              (torch.bfloat16,)),
             ("whisper-enc", 4, WH, WH, WT, WT, WD, False, 0, 0,
              (torch.bfloat16,)),
             ("window256", 1, 32, 8, 1024, 1024, 128, True, 256, 0,
              (torch.bfloat16,)),
             ("ragged-offset", 2, 8, 2, 77, 200, 64, True, 0, 123,
              (torch.float32, torch.bfloat16)),
             ("small-f32", 2, 4, 2, 130, 130, 128, True, 40, 0,
              (torch.float32,))]
    errs = []
    for tag, B, Hq, Kh, Sq, Sk, Dh, causal, window, off, dtypes in cases:
        kw = dict(causal=causal, window=window, kv_offset=off)
        for dtype in dtypes:
            q = torch.randn((B, Hq, Sq, Dh), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, Kh, Sk, Dh), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, Kh, Sk, Dh), generator=gen, device=dev).to(dtype)
            do = torch.randn((B, Hq, Sq, Dh), generator=gen, device=dev).to(dtype)
            out, lse = flash_attention_fwd(q, k, v, **kw)
            want_o, want_lse = flash_attention_fwd_ref(q.float(), k.float(),
                                                       v.float(), **kw)
            seen = torch.isfinite(want_lse)
            lse_err = (lse[seen] - want_lse[seen]).abs().max().item()
            if not (lse_err <= LSE_TOL[dname(dtype)]
                    and torch.equal(torch.isposinf(lse), ~seen)):
                raise AssertionError(f"flash lse/{tag} {dname(dtype)}: {lse_err}")
            check(f"flash_attention/train-{tag}", dtype, out, want_o)
            got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
            want = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                           want_o, want_lse, do.float(), **kw)
            err = bwd_check(f"flash_attention_bwd/{tag}", dtype, got, want)
            again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash bwd/{tag}: not deterministic")
            log({"check": f"flash_attention_fwd_lse/{tag}",
                 "dtype": dname(dtype), "max_abs_err": lse_err,
                 "tol": LSE_TOL[dname(dtype)]})
            errs.append(err)
            del got, want, again, want_o, want_lse
            if tag not in TIMED or dtype != torch.bfloat16:
                continue
            qpos = off + torch.arange(Sq, device=dev)[:, None]
            kpos = torch.arange(Sk, device=dev)[None, :]
            vis = kpos <= qpos if causal else torch.ones(
                (Sq, Sk), dtype=torch.bool, device=dev)
            pairs = int(vis.sum()) * B * Hq
            # the five products (2 FLOP a multiply-add) and one exponential
            # a pair; bytes: q k v out dout read, dq dk dv written, lse
            nbytes = (3 * q.numel() + 2 * k.numel()) * 2 + \
                (q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = max(10 * pairs * Dh / PEAK_OPS["bfloat16"],
                        pairs / rate) * 1e3
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            gqa = {"enable_gqa": True} if Kh != Hq else {}
            so = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                                **gqa)

            def sdpa_bwd():
                torch.autograd.grad(so, (ql, kl, vl), do, retain_graph=True)

            def bwd():
                return flash_attention_bwd(q, k, v, out, lse, do, **kw)
            row = {"shape": f"B={B} H={Hq} Kh={Kh} S={Sq} D={Dh} "
                            f"{'causal' if causal else 'non-causal'} bf16 "
                            f"({TIMED[tag]})",
                   "ms": time_ms(bwd),
                   "device_ms": time_ms_graph(bwd, reps=5),
                   "library_ms": time_ms(sdpa_bwd),
                   # its kernels' device time (torch.profiler): the eager
                   # time above includes autograd's host work
                   "library_device_ms": device_ms_by_kernel(
                       sdpa_bwd, ("",))[""],
                   "library": "autograd over F.scaled_dot_product_attention"
                              " (its backward only)",
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "pairs": pairs}
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            row["device_ms_by_kernel"] = device_ms_by_kernel(
                bwd, ("flash_bwd_delta", "flash_bwd_dkdv_wgmma",
                      "flash_bwd_dq_wgmma"))
            if tag == "llava-train":
                row.update({
                    "plain_ms": time_ms(lambda: flash_attention_bwd_ref(
                        q, k, v, out, lse, do, **kw), reps=1, rounds=3),
                    "fwd_lse_ms": time_ms(lambda: flash_attention_fwd(
                        q, k, v, **kw)),
                    "fwd_lse_device_ms": time_ms_graph(
                        lambda: flash_attention_fwd(q, k, v, **kw), reps=5),
                    "fwd_device_ms": time_ms_graph(
                        lambda: flash_attention(q, k, v, **kw), reps=5),
                    # the forward's two products (Q K^T, P V) at the bf16
                    # peak, or one exponential a pair
                    "fwd_bound_ms": max(4 * pairs * Dh / PEAK_OPS["bfloat16"],
                                        pairs / rate) * 1e3,
                    # SDPA's forward at the training shape, beside the
                    # flash forward's row
                    "library_fwd_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True)),
                    "library_fwd_device_ms": time_ms_graph(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True), reps=5)})
                results["flash_attention_bwd"] = row
            else:
                others.append(row)
            log({"timing": f"flash_attention_bwd/{tag}", **row})
            del ql, kl, vl, so
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    results["flash_attention_bwd"]["other_shapes"] = others
    results["flash_attention_bwd"]["max_abs_err"] = max(errs)
    # lse from the split path's merge: a decode row (one-warp tiles,
    # merge_rows) and a 64-row chunk (the last block's registers), both
    # over whisper's 1500 frames
    for tag, B, Sq in (("split-row", 8, 1), ("split-chunk", 4, 64)):
        q = torch.randn((B, WH, Sq, WD), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, WH, WT, WD), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, WH, WT, WD), generator=gen, device=dev).bfloat16()
        n_split = split_plan(B, WH, Sq, WT, WD, 0)[1]
        out, lse = flash_attention_fwd(q, k, v, causal=False)
        want_o, want_lse = flash_attention_fwd_ref(q.float(), k.float(),
                                                   v.float(), causal=False)
        check(f"flash_attention/lse-{tag}", torch.bfloat16, out, want_o)
        lse_err = (lse - want_lse).abs().max().item()
        log({"check": f"flash_attention_fwd_lse/{tag}", "n_split": n_split,
             "dtype": "bfloat16", "max_abs_err": lse_err,
             "tol": LSE_TOL["bfloat16"]})
        if n_split <= 1 or not lse_err <= LSE_TOL["bfloat16"]:
            raise AssertionError(f"flash lse/{tag}: {n_split} splits, "
                                 f"err {lse_err}")
    # the forward row's own shape (whisper's encoder at B = 4), with lse
    q = torch.randn((4, WH, WT, WD), generator=gen, device=dev).bfloat16()
    k = torch.randn((4, WH, WT, WD), generator=gen, device=dev).bfloat16()
    v = torch.randn((4, WH, WT, WD), generator=gen, device=dev).bfloat16()
    kw = dict(causal=False)
    fwd = results["flash_attention"]
    fwd["lse_ms"] = time_ms(lambda: flash_attention_fwd(q, k, v, **kw))
    fwd["lse_device_ms"] = time_ms_graph(
        lambda: flash_attention_fwd(q, k, v, **kw))
    log({"timing": "flash_attention/enc-self-b4 with lse",
         "lse_ms": fwd["lse_ms"], "lse_device_ms": fwd["lse_device_ms"],
         "device_ms": fwd["device_ms"]})


# the training attention widths beyond 64 and 128: (tag, row suffix,
# model, B, H, Kh, S, D, Dv, window); gemma3-4b's local layers (window
# 1,024) are the d256 rows' second shape
WIDTHS = [("zamba2-train", "d112", "zamba2-7b's shared attention", 2, 32, 32,
           2048, 112, 112, 0),
          ("stablelm-train", "d160", "stablelm-12b", 2, 32, 8, 2048, 160, 160,
           0),
          ("gemma3-global", "d256", "gemma3-4b's global layers", 2, 8, 4, 2048,
           256, 256, 0),
          ("gemma3-local", "d256", "gemma3-4b's local layers", 2, 8, 4, 2048,
           256, 256, 1024),
          ("mla-train", "mla", "DeepSeek-V2's MLA, queries and keys 128 + 64 "
           "wide, values 128", 2, 128, 128, 2048, 192, 128, 0)]
# (B, H, Kh, Sq, Sk, causal, window, kv_offset): GQA, a window, a ragged
# chunk after cached keys; f32 and bf16 at every width
WIDTH_MASKS = [(1, 4, 2, 200, 200, True, 0, 0), (2, 4, 4, 130, 130, True, 40, 0),
               (1, 4, 1, 77, 200, True, 0, 123), (1, 2, 2, 150, 150, False, 0, 0)]
# the same masks (and rows that see no key) with enough heads that the
# plan sends the bf16 forward to its wgmma body (no split): bf16 at every
# width
WGMMA_MASKS = [(2, 64, 16, 200, 200, True, 0, 0),
               (2, 64, 64, 130, 130, True, 40, 0),
               (1, 128, 32, 77, 200, True, 0, 123),
               (2, 64, 64, 150, 150, False, 0, 0),
               (1, 128, 64, 70, 100, True, 8, -20)]


def kernels_run(fn, reps: int = 5, part: str = "flash") -> set:
    """Names of the kernels whose names hold ``part`` (flash attention's by
    default) that ``fn`` launches, from a torch.profiler trace of ``reps``
    calls (after a warm-up call), as :func:`device_ms_by_kernel` traces
    them: within the smoke's run, traces of one call came back without
    their kernel every time.  None when no try of :func:`kernel_trace`
    showed such a kernel."""
    import torch

    def names(prof):
        return {e.key for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and part in e.key}

    def run():
        for _ in range(reps):
            fn()
    fn()
    prof, _ = kernel_trace(run, lambda p: bool(names(p)))
    return None if prof is None else names(prof)


def check_body(tag: str, fn, wgmma: bool) -> dict:
    """Which forward body ``fn`` (a bf16 flash forward) runs, by the launch
    counter ``flash_attention_wgmma`` over one call and by the profiler's
    kernel names (:func:`kernels_run`): ``flash_fwd_wgmma_kernel``
    when ``wgmma``, else ``flash_mma_kernel``; fails otherwise, and when
    no trace showed a flash kernel."""
    from repro_torch import kernels as K
    n = K.launches["flash_attention_wgmma"]
    fn()
    routed = K.launches["flash_attention_wgmma"] - n
    ran = kernels_run(fn)
    want, other = (("flash_fwd_wgmma_kernel", "flash_mma_kernel") if wgmma
                   else ("flash_mma_kernel", "flash_fwd_wgmma_kernel"))
    seen = ran is not None and (any(want in k for k in ran)
                                and not any(other in k for k in ran))
    row = {"flash_body": tag, "want": want, "wgmma_launches": routed,
           "kernels": None if ran is None else sorted(ran)}
    log(row)
    if routed != int(wgmma) or not seen:
        raise AssertionError(f"flash forward {tag}: ran {ran}, wgmma "
                             f"launches {routed}, want {want}")
    return row


def prefill_split(launches: dict) -> dict:
    """A path's bf16 chunked-prefill launches by body: the wgmma body's
    (``paged_prefill_attention_wgmma``) and the rest of
    ``paged_prefill_attention``'s (the mma.sync tile, or f32)."""
    w = launches.get("paged_prefill_attention_wgmma", 0)
    return {"wgmma": w, "tile_or_f32": launches["paged_prefill_attention"] - w}


def prefill_body(tag: str, fn, wgmma: bool) -> dict:
    """Which body ``fn`` (a bf16 chunked prefill) runs, by the launch
    counter ``paged_prefill_attention_wgmma`` over one call and by the
    profiler's kernel names: ``paged_prefill_wgmma_kernel`` when
    ``wgmma``, else ``paged_prefill_mma_kernel``; fails otherwise, and when
    no trace showed a paged-prefill kernel."""
    from repro_torch import kernels as K
    n = K.launches["paged_prefill_attention_wgmma"]
    fn()
    routed = K.launches["paged_prefill_attention_wgmma"] - n
    ran = kernels_run(fn, part="paged_prefill")
    want, other = (("paged_prefill_wgmma_kernel", "paged_prefill_mma_kernel")
                   if wgmma else
                   ("paged_prefill_mma_kernel", "paged_prefill_wgmma_kernel"))
    seen = ran is not None and (any(want in k for k in ran)
                                and not any(other in k for k in ran))
    row = {"prefill_body": tag, "want": want, "wgmma_launches": routed,
           "kernels": None if ran is None else sorted(ran)}
    log(row)
    if routed != int(wgmma) or not seen:
        raise AssertionError(f"paged prefill {tag}: ran {ran}, wgmma "
                             f"launches {routed}, want {want}")
    return row


def width_bounds(pairs, B, H, Kh, Sq, Sk, D, Dv, rate) -> dict:
    """Forward and backward bounds of bf16 flash attention over ``pairs``
    visible (query, key) pairs: the products at the bf16 tensor-core peak
    (forward Q K^T at D and P V at Dv; backward S and dQ and dK at D, dP
    and dV at Dv; 2 FLOP a multiply-add) or one exponential a pair,
    against the bytes (forward: q k v read, out and lse written;
    backward: q k v out dout lse read, dq dk dv written)."""
    fwd_ops = max(2 * pairs * (D + Dv) / PEAK_OPS["bfloat16"], pairs / rate)
    bwd_ops = max(2 * pairs * (3 * D + 2 * Dv) / PEAK_OPS["bfloat16"],
                  pairs / rate)
    q, k, v, o = B * H * Sq * D, B * Kh * Sk * D, B * Kh * Sk * Dv, \
        B * H * Sq * Dv
    fwd_bytes = 2 * (q + k + v + o) + 4 * B * H * Sq
    bwd_bytes = 2 * (2 * q + 2 * k + 2 * v + 2 * o) + 4 * B * H * Sq
    out = {}
    for tag, nbytes, ops in (("fwd", fwd_bytes, fwd_ops),
                             ("bwd", bwd_bytes, bwd_ops)):
        t_bytes = nbytes / PEAK_BYTES * 1e3
        out[tag] = (max(t_bytes, ops * 1e3),
                    "bytes" if t_bytes >= ops * 1e3 else "operations")
    return out


def width_flash_cases(gen, dev, results, rate):
    """Flash attention's forward and backward at the (D, Dv) pairs the
    repo's other configs train at: against their plain versions (bf16
    held against the f32 plain output, f32 at the masks' small shapes),
    every call twice and bit-equal, at each model's training shape (bf16,
    timed beside the bound and SDPA's forward and backward where SDPA takes
    the shape) and at GQA, window and kv_offset shapes (WIDTH_MASKS, and in
    bf16 WGMMA_MASKS, whose forward the plan sends to the wgmma body); the
    split path at a decode row and a 64-row chunk at D = 112 and 160.  The
    training shapes' and WGMMA_MASKS' forward calls must run
    ``flash_fwd_wgmma_kernel``, the split calls ``flash_mma_kernel``
    (:func:`check_body`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        WGMMA_ROWS, flash_attention, flash_attention_bwd,
        flash_attention_fwd, split_plan)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref,
        flash_attention_ref)

    def run_checks(tag, dtype, B, Hq, Kh, Sq, Sk, Dqk, Dv, kw):
        """(fwd err, bwd err, tensors) of one case, checked and bit-equal."""
        q = torch.randn((B, Hq, Sq, Dqk), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Kh, Sk, Dqk), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Kh, Sk, Dv), generator=gen, device=dev).to(dtype)
        do = torch.randn((B, Hq, Sq, Dv), generator=gen, device=dev).to(dtype)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        out2, lse2 = flash_attention_fwd(q, k, v, **kw)
        want_o, want_lse = flash_attention_fwd_ref(q.float(), k.float(),
                                                   v.float(), **kw)
        seen = torch.isfinite(want_lse)
        lse_err = (lse[seen] - want_lse[seen]).abs().max().item()
        if not (lse_err <= LSE_TOL[dname(dtype)]
                and torch.equal(torch.isposinf(lse), ~seen)):
            raise AssertionError(f"flash lse/{tag} {dname(dtype)}: {lse_err}")
        f_err = check(f"flash_attention/{tag}", dtype, out, want_o)
        got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       want_o, want_lse, do.float(), **kw)
        b_err = bwd_check(f"flash_attention_bwd/{tag}", dtype, got, want)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(got, again))):
            raise AssertionError(f"flash/{tag} {dname(dtype)}: two calls "
                                 f"differ")
        log({"check": f"flash_attention_fwd_lse/{tag}", "dtype": dname(dtype),
             "max_abs_err": lse_err, "tol": LSE_TOL[dname(dtype)],
             "bit_equal_across_calls": True})
        del got, again, want, want_o, want_lse, out2, lse2
        return f_err, b_err, (q, k, v, do, out, lse)

    errs = {}
    for Dqk, Dv in sorted({(w[7], w[8]) for w in WIDTHS}):
        for B, Hq, Kh, Sq, Sk, causal, window, off in WIDTH_MASKS:
            kw = dict(causal=causal, window=window, kv_offset=off)
            for dtype in (torch.float32, torch.bfloat16):
                tag = (f"D{Dqk}x{Dv}-B{B}-H{Hq}-Kh{Kh}-{Sq}x{Sk}-c{int(causal)}"
                       f"-w{window}-o{off}")
                f_err, b_err, _ = run_checks(tag, dtype, B, Hq, Kh, Sq, Sk,
                                             Dqk, Dv, kw)
                errs.setdefault((Dqk, Dv), []).append((f_err, b_err))
        # the wgmma body at the same masks (and rows without keys)
        for B, Hq, Kh, Sq, Sk, causal, window, off in WGMMA_MASKS:
            kw = dict(causal=causal, window=window, kv_offset=off)
            tag = (f"wgmma-D{Dqk}x{Dv}-B{B}-H{Hq}-Kh{Kh}-{Sq}x{Sk}-"
                   f"c{int(causal)}-w{window}-o{off}")
            plan = split_plan(B, Hq, Sq, Sk, Dqk, 0, Dv)
            if plan != (WGMMA_ROWS, 1):
                raise AssertionError(f"flash {tag}: plan {plan}")
            f_err, b_err, (q, k, v, *_r) = run_checks(
                tag, torch.bfloat16, B, Hq, Kh, Sq, Sk, Dqk, Dv, kw)
            check_body(tag, lambda: flash_attention_fwd(q, k, v, **kw), True)
            errs[(Dqk, Dv)].append((f_err, b_err))
            del q, k, v, _r
    # the split path where the grid is short: a decode row and a 64-row
    # chunk over 1,500 keys, at the widths whose merge was added
    for Dqk in (112, 160):
        for B, Sq in ((8, 1), (4, 64)):
            Hq = 8
            q = torch.randn((B, Hq, Sq, Dqk), generator=gen,
                            device=dev).bfloat16()
            k = torch.randn((B, Hq, 1500, Dqk), generator=gen,
                            device=dev).bfloat16()
            v = torch.randn((B, Hq, 1500, Dqk), generator=gen,
                            device=dev).bfloat16()
            n_split = split_plan(B, Hq, Sq, 1500, Dqk, 0)[1]
            out, lse = flash_attention_fwd(q, k, v, causal=False)
            want_o, want_lse = flash_attention_fwd_ref(
                q.float(), k.float(), v.float(), causal=False)
            err = check(f"flash_attention/split-D{Dqk}-B{B}-Sq{Sq}",
                        torch.bfloat16, out, want_o)
            lse_err = (lse - want_lse).abs().max().item()
            log({"check": f"flash_attention_fwd_lse/split-D{Dqk}-Sq{Sq}",
                 "n_split": n_split, "max_abs_err": lse_err,
                 "tol": LSE_TOL["bfloat16"]})
            if n_split <= 1 or not lse_err <= LSE_TOL["bfloat16"]:
                raise AssertionError(f"flash split D={Dqk} Sq={Sq}: {n_split} "
                                     f"splits, lse err {lse_err}")
            check_body(f"split-D{Dqk}-B{B}-Sq{Sq}",
                       lambda: flash_attention_fwd(q, k, v, causal=False),
                       False)
            errs[(Dqk, Dqk)].append((err, 0.0))

    # the training shapes: checked, then timed beside the bound and SDPA
    for tag, sfx, model, B, Hq, Kh, S, Dqk, Dv, window in WIDTHS:
        kw = dict(causal=True, window=window)
        f_err, b_err, (q, k, v, do, out, lse) = run_checks(
            tag, torch.bfloat16, B, Hq, Kh, S, S, Dqk, Dv, kw)
        errs[(Dqk, Dv)].append((f_err, b_err))
        body = check_body(tag, lambda: flash_attention_fwd(q, k, v, **kw),
                          True)
        qpos = torch.arange(S, device=dev)[:, None]
        kpos = torch.arange(S, device=dev)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        pairs = int(mask.sum()) * B * Hq
        bnd = width_bounds(pairs, B, Hq, Kh, S, S, Dqk, Dv, rate)
        shape = (f"B={B} H={Hq} Kh={Kh} S={S} D={Dqk} Dv={Dv} causal "
                 f"window={window} bf16 ({model} training)")
        sdpa_kw = {"enable_gqa": Kh != Hq}
        if window:
            sdpa_kw["attn_mask"] = mask
        else:
            sdpa_kw["is_causal"] = True

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, **sdpa_kw)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lib, so = {}, None
        try:
            so = F.scaled_dot_product_attention(ql, kl, vl, **sdpa_kw)

            def sdpa_bwd():
                torch.autograd.grad(so, (ql, kl, vl), do, retain_graph=True)
            lib = {"library_ms": time_ms(sdpa),
                   "library_device_ms": time_ms_graph(sdpa, reps=5),
                   "library_bwd_ms": time_ms(sdpa_bwd),
                   "library_bwd_device_ms": device_ms_by_kernel(
                       sdpa_bwd, ("",))[""]}
        except RuntimeError as e:          # a shape SDPA does not take
            lib = {"library_ms": None, "library_error": str(e)[:200]}
        fwd = {"shape": shape,
               "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
               "device_ms": time_ms_graph(
                   lambda: flash_attention(q, k, v, **kw), reps=5),
               "lse_device_ms": time_ms_graph(
                   lambda: flash_attention_fwd(q, k, v, **kw), reps=5),
               "plain_ms": time_ms(lambda: flash_attention_ref(
                   q, k, v, **kw), reps=1, rounds=3),
               "bound_ms": bnd["fwd"][0], "bound_by": bnd["fwd"][1],
               "pairs": pairs, "library": "F.scaled_dot_product_attention",
               "library_ms": lib.get("library_ms"),
               "library_device_ms": lib.get("library_device_ms"),
               "body": "flash_fwd_wgmma_kernel",
               "body_kernels": body["kernels"]}
        fwd["bound_share"] = fwd["bound_ms"] / fwd["device_ms"]

        def bwd():
            return flash_attention_bwd(q, k, v, out, lse, do, **kw)
        bwd_row = {"shape": shape, "ms": time_ms(bwd),
                   "device_ms": time_ms_graph(bwd, reps=5),
                   "plain_ms": time_ms(lambda: flash_attention_bwd_ref(
                       q, k, v, out, lse, do, **kw), reps=1, rounds=3),
                   "bound_ms": bnd["bwd"][0], "bound_by": bnd["bwd"][1],
                   "pairs": pairs,
                   "library": "autograd over F.scaled_dot_product_attention "
                              "(its backward only)",
                   "library_ms": lib.get("library_bwd_ms"),
                   "library_device_ms": lib.get("library_bwd_device_ms")}
        bwd_row["bound_share"] = bwd_row["bound_ms"] / bwd_row["device_ms"]
        bwd_row["device_ms_by_kernel"] = device_ms_by_kernel(
            bwd, ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"))
        if "library_error" in lib:
            fwd["library_error"] = bwd_row["library_error"] = \
                lib["library_error"]
        for name, row in ((f"flash_attention_{sfx}", fwd),
                          (f"flash_attention_bwd_{sfx}", bwd_row)):
            log({"timing": f"{name}/{tag}", "card_kernel": name, **row})
            if name in results:            # gemma3's local layers
                results[name].setdefault("other_shapes", []).append(row)
            else:
                results[name] = row
        del q, k, v, do, out, lse, ql, kl, vl, so
        torch.cuda.empty_cache()
    for tag, sfx, *_rest in WIDTHS:
        Dqk, Dv = _rest[5], _rest[6]
        results[f"flash_attention_{sfx}"]["max_abs_err"] = max(
            e[0] for e in errs[(Dqk, Dv)])
        results[f"flash_attention_bwd_{sfx}"]["max_abs_err"] = max(
            e[1] for e in errs[(Dqk, Dv)])


def grads_of(cfg, params, batch):
    """(loss, {path: gradient}) of the port's loss_fn, remat on."""
    import torch
    from repro_torch.train.train import loss_fn
    leaves = params.leaves()
    loss, _ = loss_fn(cfg, params, batch, remat=True)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


def _flash_launches(n):
    return {"flash_attention": 2 * n["attn"], "flash_attention_bwd": n["attn"]}


def _zamba_launches(n):
    return {"selective_scan_heads": 2 * n["mamba2"],
            "selective_scan_heads_bwd": n["mamba2"], **_flash_launches(n)}


def _wide_launches(launches):
    """A full-width bf16 step's launches at a wide head dim: every flash
    forward call on the wgmma body too."""
    def want(n):
        out = launches(n)
        return {**out, "flash_attention_wgmma": out["flash_attention"]}
    return want


# (arch, overrides of its reduced config, {kernel: launches a remat'd step
# as a function of its layer counts}) of the reduced f32 card-vs-CPU check;
# the last four run the widths the full models train at: MLA's (192, 128)
# with both MLA layer kinds, zamba2-7b's 112, stablelm-12b's 160 and
# gemma3-4b's 256 (its reduced window of 16 on the local layers)
TRAIN_CHECKS = (
    ("llava-1.5-7b", {}, _flash_launches),
    ("falcon-mamba-7b", {}, lambda n: {"selective_scan": 2 * n["mamba1"],
                                       "selective_scan_bwd": n["mamba1"]}),
    ("zamba2-7b", {}, _zamba_launches),
    ("granite-moe-1b-a400m", {}, _flash_launches),
    ("deepseek-v2-236b", {"qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                          "v_head_dim": 128}, _flash_launches),
    ("zamba2-7b", {"head_dim": ZD}, _zamba_launches),
    ("stablelm-12b", {"head_dim": SD}, _flash_launches),
    ("gemma3-4b", {"head_dim": 256}, _flash_launches))


def layer_counts(cfg) -> dict:
    """Layers by what they launch: attention (ATTN_*, MLA_*, SHARED_ATTN),
    Mamba-1, Mamba-2."""
    kinds = cfg.layer_kinds()
    return {"attn": sum(k.startswith(("attn", "mla")) or k == "shared_attn"
                        for k in kinds),
            "mamba1": kinds.count("mamba1"), "mamba2": kinds.count("mamba2")}


def train_check(seed: int) -> dict:
    """Reduced LLaVA-1.5-7B, falcon-mamba-7b (Mamba-1), zamba2-7b (Mamba-2
    and shared attention) and granite-moe-1b-a400m (the MoE FFN's capacity
    path, which drops pairs at its capacity factor of 1.25, and its aux
    loss), then DeepSeek-V2 (MLA + MLP and MLA + MoE at MLA's full (192,
    128) attention widths), zamba2-7b, stablelm-12b and gemma3-4b at their
    full head dims (112, 160, 256) in f32: the loss and every gradient
    leaf of one training step on the card (the f32 flash and scan kernels,
    forward and backward) against the same on the CPU (their plain
    versions), within 1e-4 of the leaf's largest magnitude; each kernel
    launched as often as remat makes it; then one train_step on the card.
    Returns each row's launches by its label (the arch, then any
    overrides: "zamba2-7b" is the per-head backward's main path,
    "stablelm-12b head_dim=160" the D = 160 instances')."""
    import dataclasses
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train.data import DataConfig, batches, to_device
    from repro_torch.train.optim import AdamWConfig, init_opt_state
    from repro_torch.train.train import train_step
    runs = {}
    for arch, overrides, expect in TRAIN_CHECKS:
        cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
        label = " ".join([arch] + [f"{k}={v}" for k, v in overrides.items()])
        b = next(batches(cfg, DataConfig(batch_size=2, seq_len=64,
                                         seed=seed)))
        out = {}
        for dev in ("cpu", "cuda"):
            params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                                   trainable=True).to(dev)
            K.reset_launches()
            out[dev] = grads_of(cfg, params, to_device(b, dev))
            if dev == "cuda":
                launches = {n: c for n, c in K.launches.items() if c}
        (lc, gc_), (lg, gg) = out["cpu"], out["cuda"]
        loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
        worst, worst_leaf = 0.0, None
        for k, want in gc_.items():
            rel = ((gg[k].cpu() - want).abs().max()
                   / want.abs().max().clamp_min(1e-30)).item()
            if rel > worst:
                worst, worst_leaf = rel, k
        if not (loss_err <= 1e-4 and worst <= 1e-4):
            raise AssertionError(f"train check {label}: loss off by "
                                 f"{loss_err}, grad leaf {worst_leaf} by "
                                 f"{worst} (rel)")
        want = expect(layer_counts(cfg))
        if any(launches.get(n, 0) != c for n, c in want.items()):
            raise AssertionError(f"train check {label} launches {launches}, "
                                 f"expected {want}")
        params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                               trainable=True).to("cuda")
        opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        _, _, stats = train_step(cfg, opt, params, init_opt_state(params),
                                 to_device(b, "cuda"))
        if not torch.isfinite(stats["loss"]):
            raise AssertionError(f"train check {label}: train_step loss not "
                                 f"finite")
        log({"train_check": f"reduced {label} f32, loss and gradients on "
                            f"cuda vs cpu", "loss": float(lc),
             "loss_rel_err": loss_err, "max_rel_grad_err": worst,
             "worst_leaf": worst_leaf, "tol": 1e-4, "launches": launches,
             "aux": float(stats["aux"]),
             "train_step_loss": float(stats["loss"])})
        runs[label] = launches
    return runs


def train_run(cfg, label: str, card: str, seed: int, want: dict,
              plain: tuple, watch=None) -> dict:
    """4 AdamW steps at full width with remat on one fixed batch of B = 2
    rows of 2048 tokens (and the model's media positions) from
    ``train.data.batches``, random bf16 weights, lr 1e-4 after the
    schedule's linear warmup over 100 steps (so 1e-6 to 4e-6 here).
    Without warmup, Adam's first steps move every weight by lr * sign(g),
    a change that adds up coherently over a 4096-wide layer's inputs: at
    1e-4 the loss rises (tools/train_lr_sweep.py).  The loss must be
    finite and fall; every step must launch each kernel of ``want`` as
    often as it says, and no plain version named in ``plain`` ((module,
    function name) pairs) may be handed a CUDA tensor.  Then one more
    step, profiled.  ``watch()``, when given, returns extra numbers to log
    after each step.  Returns (launches of one step, profile summary)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.models import model as M
    from repro_torch.train.data import DataConfig, batches, to_device
    from repro_torch.train.optim import AdamWConfig, init_opt_state
    from repro_torch.train.train import make_train_step
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), dtype=torch.bfloat16, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    state = init_opt_state(params)
    step = make_train_step(cfg, AdamWConfig(lr=1e-4, warmup_steps=100,
                                            total_steps=10_000))
    batch = to_device(next(batches(cfg, DataConfig(
        batch_size=TRAIN_B, seq_len=TRAIN_S, seed=seed))), "cuda",
        torch.bfloat16)
    # the plain versions, counted when handed CUDA tensors (never, if the
    # wrappers dispatch right)
    saved = {(m, n): getattr(m, n) for m, n in plain}
    counts = {n: 0 for _, n in plain}

    def count(name, fn):
        def wrapped(*a, **k):
            if a[0].is_cuda:
                counts[name] += 1
            return fn(*a, **k)
        return wrapped
    for (m, n), fn in saved.items():
        setattr(m, n, count(n, fn))
    losses, times, per_step, extra = [], [], [], []
    try:
        for _ in range(4):
            torch.cuda.synchronize()
            K.reset_launches()
            t = time.perf_counter()
            params, state, stats = step(params, state, batch)
            losses.append(float(stats["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            per_step.append({n: K.launches[n] for n in K.launches
                             if K.launches[n]})
            extra.append({"aux": float(stats["aux"]),
                          **(watch() if watch else {})})
            log({"train_step": len(losses), "path": label,
                 "loss": losses[-1], **extra[-1],
                 "grad_norm": float(stats["grad_norm"]),
                 "lr": float(stats["lr"]), "s": times[-1],
                 "launches": per_step[-1]})
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    peak = torch.cuda.max_memory_allocated()
    # where a step's device time goes: one more step, profiled, with the
    # optimizer update in a range of its own
    from repro_torch.train import train as T
    update = T.adamw_update

    def annotated(*a, **k):
        with torch.profiler.record_function("adamw_update"):
            return update(*a, **k)
    T.adamw_update = annotated
    try:
        prof = profile_calls(lambda: step(params, state, batch),
                             "train step", card, label, steps=1,
                             ranges=("adamw_update",))
    finally:
        T.adamw_update = update
    positions = TRAIN_B * (TRAIN_S + cfg.media_tokens)
    steady = statistics.median(times[1:])
    log({"train_full": label, "params": n_params, "losses": losses,
         "per_step": extra, "step_s": times, "steady_step_s": steady,
         "text_tokens_per_s": TRAIN_B * TRAIN_S / steady,
         "positions_per_s": positions / steady,
         "max_memory_allocated_gb": peak / 1e9,
         "launches_per_step": per_step[-1], "plain_calls_on_cuda": counts,
         "card": card})
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses}")
    if any(s.get(n, 0) != c for s in per_step for n, c in want.items()) \
            or any(counts.values()):
        raise AssertionError(f"{label}: launches {per_step}, want {want}; "
                             f"plain versions on CUDA tensors {counts}")
    del params, state, batch, stats
    return per_step[-1], prof


def train_full(seed: int, card: str) -> dict:
    """LLaVA-1.5-7B at full width, depth cut to 16 layers, B = 2 rows of
    2048 tokens and 576 image positions (:func:`train_run`): the step must
    run the flash forward (twice a layer: remat) and backward kernels on
    every layer and never their plain versions.  Returns the launch counts
    of one step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = dataclasses.replace(get_config("llava-1.5-7b"),
                              num_layers=TRAIN_LAYERS)
    launches, _ = train_run(
        cfg, f"llava-1.5-7b, {TRAIN_LAYERS} of 32 layers, full width, bf16, "
             f"remat, B={TRAIN_B} x ({TRAIN_S} text + {cfg.media_tokens} "
             f"image)", card, seed,
        {"flash_attention": 2 * TRAIN_LAYERS,
         "flash_attention_bwd": TRAIN_LAYERS, "flash_attention_wgmma": 0},
        tuple((fa, n) for n in ("flash_attention_ref",
                                "flash_attention_fwd_ref",
                                "flash_attention_bwd_ref")))
    return launches


def train_full_mamba(seed: int, card: str) -> dict:
    """falcon-mamba-7b at full width (d 4096, d_inner 8192, N 16, vocab
    65,024), depth cut from 64 to FM_TRAIN_LAYERS, B = 2 rows of 2048
    tokens (:func:`train_run`): every step must run the scan's forward
    twice a layer (remat) and its backward kernel once, never their plain
    versions.  Also the backward's share of the profiled step's device
    time.  Returns the launch counts of one step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan import ops as so
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              num_layers=FM_TRAIN_LAYERS)
    label = (f"falcon-mamba-7b, {FM_TRAIN_LAYERS} of 64 layers, full width, "
             f"bf16, remat, B={TRAIN_B} x {TRAIN_S} text")
    launches, prof = train_run(
        cfg, label, card, seed,
        {"selective_scan": 2 * FM_TRAIN_LAYERS,
         "selective_scan_bwd": FM_TRAIN_LAYERS},
        tuple((so, n) for n in ("selective_scan_ref",
                                "selective_scan_bwd_ref")))
    by, step = prof["device_ms_by_kernel"], prof["device_ms_per_call"]
    bwd = sum(ms for k, ms in by.items()
              if any(n in k for n in SCAN_BWD_KERNELS))
    fwd = sum(ms for k, ms in by.items() if "selective_scan_kernel" in k)
    log({"train_full_mamba_profile": label, "card": card,
         "step_device_ms": step,
         "scan_bwd_device_ms": bwd,
         "scan_bwd_share": step and bwd / step,
         "scan_fwd_device_ms": fwd,
         "scan_fwd_share": step and fwd / step})
    return launches


def train_full_moe(seed: int, card: str) -> dict:
    """granite-moe-1b-a400m at full width and depth (24 layers, 32 experts
    top-8 at capacity factor 1.25), B = 2 rows of 2048 tokens
    (:func:`train_run`): every step must run the flash forward twice a
    layer and its backward once at D = 64, never their plain versions;
    the loss, the aux loss and the share of (token, expert) pairs the
    capacity dropped, per step.  Returns the launch counts of one step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m")
    if cfg.head_dim != GD or cfg.num_layers != GL:
        raise AssertionError("granite-moe's widths moved")
    dropped = []
    inner = moe._capacity_dropping

    def recording(p, xt, gates, flat, counts, cfg_, act):
        C = moe.capacity(cfg_, xt.shape[0])
        dropped.append(((counts - C).clamp(min=0).sum()
                        / flat.numel()).item())
        return inner(p, xt, gates, flat, counts, cfg_, act)

    def watch():
        share = statistics.fmean(dropped) if dropped else None
        dropped.clear()
        return {"dropped_pair_share": share}
    moe._capacity_dropping = recording
    try:
        launches, _ = train_run(
            cfg, f"granite-moe-1b-a400m, 24 layers (not cut), bf16, remat, "
                 f"B={TRAIN_B} x {TRAIN_S} text, capacity factor "
                 f"{cfg.moe_capacity_factor}", card, seed,
            {"flash_attention": 2 * GL, "flash_attention_bwd": GL,
             "flash_attention_wgmma": 0},
            tuple((fa, n) for n in ("flash_attention_ref",
                                    "flash_attention_fwd_ref",
                                    "flash_attention_bwd_ref")), watch)
    finally:
        moe._capacity_dropping = inner
    torch.cuda.empty_cache()
    return launches


ZAMBA_TRAIN_LAYERS = 42  # zamba2-7b's depth cut for one card (PERF.md)
FLASH_PLAIN = ("flash_attention_ref", "flash_attention_fwd_ref",
               "flash_attention_bwd_ref")


def train_full_zamba2(seed: int, card: str) -> dict:
    """zamba2-7b at full width (d 3,584, 112 Mamba-2 heads of 64, N 64;
    the shared block's attention H = Kh = 32 at D = 112), depth cut from
    81 to ZAMBA_TRAIN_LAYERS (35 Mamba-2 layers and 7 uses of the shared
    block), B = 2 rows of 2048 tokens (:func:`train_run`): every step must
    run the per-head scan forward twice a Mamba-2 layer and its backward
    once, and the flash forward twice a shared-attention use and its
    backward once at D = 112, never their plain versions.  Returns the
    launch counts of one step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as so
    cfg = dataclasses.replace(get_config("zamba2-7b"),
                              num_layers=ZAMBA_TRAIN_LAYERS)
    n = layer_counts(cfg)
    if cfg.head_dim != ZD or (n["attn"], n["mamba2"]) != (7, 35):
        raise AssertionError(f"zamba2-7b's cut: {n}, head dim {cfg.head_dim}")
    launches, _ = train_run(
        cfg, f"zamba2-7b, {ZAMBA_TRAIN_LAYERS} of 81 layers (35 Mamba-2, 7 "
             f"shared-attention uses), full width, bf16, remat, B={TRAIN_B} "
             f"x {TRAIN_S} text", card, seed,
        _wide_launches(_zamba_launches)(n),
        tuple((fa, f) for f in FLASH_PLAIN)
        + tuple((so, f) for f in ("selective_scan_heads_ref",
                                  "selective_scan_heads_bwd_ref")))
    return launches


def train_full_gemma3(seed: int, card: str) -> dict:
    """gemma3-4b at full width and depth (34 layers: 29 local with a
    1,024-key window and 5 global; H 8, Kh 4, D 256; d 2,560; a tied
    vocabulary of 262,144), B = 2 rows of 2048 tokens (:func:`train_run`):
    every step must run the flash forward twice a layer and its backward
    once at D = 256, never their plain versions.  Returns the launch
    counts of one step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = get_config("gemma3-4b")
    n = layer_counts(cfg)
    local = sum(cfg.is_local_layer(i) for i in range(cfg.num_layers))
    if (cfg.head_dim, n["attn"], local, cfg.sliding_window) != \
            (256, 34, 29, 1024):
        raise AssertionError(f"gemma3-4b's widths moved: {n}, {local} local")
    launches, _ = train_run(
        cfg, f"gemma3-4b, 34 layers (not cut; 29 local, window 1024), bf16, "
             f"remat, B={TRAIN_B} x {TRAIN_S} text", card, seed,
        _wide_launches(_flash_launches)(n),
        tuple((fa, f) for f in FLASH_PLAIN))
    return launches


def train_full_mla(seed: int, card: str) -> dict:
    """DeepSeek-V2 at full width, depth cut from 60 to its first layer (MLA
    with 128 heads, queries and keys 128 + 64 wide, values 128, and the
    dense FFN of width 12,288; the MLA + MoE layers' 160 experts do not fit
    one card with their moments), B = 2 rows of 2048 tokens
    (:func:`train_run`): every step must run the flash forward twice and
    its backward once at (192, 128), never their plain versions.  Returns
    the launch counts of one step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), num_layers=1)
    if cfg.layer_kinds() != ["mla_mlp"] or (
            cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
            cfg.v_head_dim) != (192, 128):
        raise AssertionError("DeepSeek-V2's first layer moved")
    launches, _ = train_run(
        cfg, f"deepseek-v2-236b, 1 of 60 layers (MLA + dense FFN), full "
             f"width, bf16, remat, B={TRAIN_B} x {TRAIN_S} text", card, seed,
        _wide_launches(_flash_launches)(layer_counts(cfg)),
        tuple((fa, f) for f in FLASH_PLAIN))
    return launches


def train_mm_run(card: str):
    """``train_mm.main`` at its mini config (f32 on the card) for 20
    steps: the loss must fall."""
    from repro_torch.train import train_mm
    path = ROOT / "build" / "train_mm.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    losses, text = captured(train_mm.main,
                            ["--steps", "20", "--ckpt", str(path)])
    wall = time.perf_counter() - t
    if "checkpoint ->" not in text:
        raise AssertionError("train_mm: no checkpoint line")
    log({"train_mm": "mini config (4 layers, d 512, vocab 32000, 64 image "
                     "positions), f32, 20 steps", "losses": losses,
         "wall_s": wall, "card": card})
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train_mm: losses {losses}")
    path.unlink()


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
    (``aten::mm``) among them, as shares of the busy time.  Returns
    {"device_ms_per_call", "launches_per_call", "device_ms_by_kernel":
    {kernel name: ms a call}}."""
    import torch

    def run():
        for _ in range(steps):
            fn()

    def kernels_seen(p):
        return any(e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key not in ranges and e.self_device_time_total > 0
                   for e in p.key_averages())
    prof, wall_s = kernel_trace(run, kernels_seen, cpu=True)
    if prof is None:
        log({"profile": f"{what}, {steps} calls", "path": tag, "card": card,
             "not_measured": "no trace showed a kernel"})
        return {"device_ms_per_call": None, "launches_per_call": None,
                "device_ms_by_kernel": {}}
    wall_us = wall_s * 1e6
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
    summary = {"device_ms_per_call": busy / steps / 1e3,
               "launches_per_call": sum(n for _, _, n in rows) / steps,
               "device_ms_by_kernel": {k: us / steps / 1e3
                                       for us, k, _ in rows}}
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
    return summary


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


def llava_requests(cfg, seed: int) -> list:
    """The LLaVA paths' mix: five requests of one image (576 x 4096
    pseudo-embedding) and 32 prompt tokens, 16 new tokens, four greedy and
    one seeded sampled; [(prompt, media, params)]."""
    import numpy as np
    from repro_torch.core.request import SamplingParams
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(5):
        media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
                 * 0.1).astype(np.float32)
        prompt = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
        sp = SamplingParams(max_tokens=16) if i < 4 else SamplingParams(
            temperature=0.8, top_k=50, top_p=0.95, seed=seed, max_tokens=16)
        reqs.append((prompt, media, sp))
    return reqs


def serve(seed: int, card: str):
    """LLaVA-1.5-7B, E1+P1+D1; returns the launch counts of its run and
    its end-to-end reading (for the dense path's line)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
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
    reqs = llava_requests(cfg, seed)
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
    reading = {"wall_s": wall, **request_metrics(rs),
               "migrations": srv.n_migrations,
               "migrated_bytes": srv.migrated_bytes, "launches": launches,
               "prefill_bodies": prefill_split(launches),
               "greedy_tokens_req0": outs[0]}
    log({"main_path": "Engine E1+P1+D1, llava-1.5-7b bf16, 5 requests x "
                      "(576 image tokens + 32 prompt tokens), 16 new tokens",
         "card": card, **reading, "wall_split": split})

    d = next(i for i in srv.instances if i.role_name == "D")
    ctx = cfg.media_tokens + 32
    steady_decode(d, lambda rid: d.caches.kv.append(rid, torch.zeros(
        (2, cfg.num_layers, ctx, cfg.num_kv_heads * cfg.head_dim),
        dtype=torch.bfloat16, device="cuda")), d.caches.release, card,
        f"llava-1.5-7b, context {ctx}")
    return launches, reading


# ---------------------------------------------------------------------------
# phase 5b: the dense host-cache fallback (``device_cache=False``)
# ---------------------------------------------------------------------------
DENSE_REL = 2e-2       # full-width bf16 dense vs paged runner, per step
DENSE_ATTN = ("cache_write", "paged_attention", "flash_attention")
PAGED_PREFILL = ("paged_prefill_attention", "paged_prefill_attention_latent")
DENSE_CHECKS = (("llava-1.5-7b", {}), ("gemma3-4b", {}),
                ("whisper-small", {}), ("falcon-mamba-7b", {}),
                ("zamba2-7b", {}), ("granite-moe-1b-a400m", {}),
                ("deepseek-v2-236b", {"qk_nope_head_dim": 128,
                                      "qk_rope_head_dim": 64,
                                      "v_head_dim": 128}))


def rss_gb() -> float:
    """This process's resident memory (VmRSS), GB."""
    with open("/proc/self/status") as f:
        kb = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS"))
    return kb * 1024 / 1e9


def dense_launched(launches: dict, what: str, scan: bool, attn: bool):
    """Fail unless the dense path launched its kernels: with attention
    layers the cache write, paged decode (or its latent-row kernel) and
    flash attention, with Mamba layers the scan (either mode); and never a
    paged-prefill kernel (a dense chunk attends through flash)."""
    need = [("cache_write",), ("paged_attention", "paged_attention_latent"),
            ("flash_attention",)] if attn else []
    if scan:
        need.append(("selective_scan", "selective_scan_heads"))
    for names in need:
        if not sum(launches[n] for n in names):
            raise AssertionError(f"{what}: {' / '.join(names)} never "
                                 f"launched")
    if any(launches[n] for n in PAGED_PREFILL):
        raise AssertionError(f"{what}: a paged-prefill kernel launched on "
                             f"the dense path: {launches}")


def dense_model_check(arch: str, overrides: dict, seed: int) -> dict:
    """Reduced ``arch`` in f32 through the dense host-cache runner on the
    card against the same runner on the CPU: media first (encode, then a
    media chunk on vision models, encoder clips on whisper), a first chunk
    of three prompts of different lengths, a second chunk for two of
    them, four decode steps; logits within 2e-4 of the CPU's largest each
    step.  Returns the card run's launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.engine import runner as R
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    runners = {}
    for dev in ("cpu", "cuda"):
        p = M.init_params(cfg, torch.Generator().manual_seed(seed)).to(dev)
        runners[dev] = R.ModelRunner(cfg, p, R.RunnerCaches(
            cfg, kv_blocks=32, img_blocks=4, device=dev,
            device_cache=False), device=dev)
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
            raise AssertionError(f"dense {arch} check: logits off by {rel}")
        return want

    K.reset_launches()
    if cfg.frontend != "none":
        for rid in range(3):
            media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
                     * 0.1).astype(np.float32)
            for r in runners.values():
                r.encode([(rid, media)])
        if not cfg.cross_attention:
            compare(lambda r: r.prefill_chunks([(i, None, True)
                                                for i in range(3)]))
    first = compare(lambda r: r.prefill_chunks([(0, prompts[0][:8], False),
                                                (1, prompts[1], False),
                                                (2, prompts[2][:5], False)]))
    last = compare(lambda r: r.prefill_chunks([(0, prompts[0][8:], False),
                                               (2, prompts[2][5:], False)]))
    toks = np.argmax(np.stack([last[0], first[1], last[1]]), -1)
    for _ in range(4):
        toks = np.argmax(compare(lambda r: r.decode([0, 1, 2], toks)), -1)
    torch.cuda.synchronize()
    launches = {n: c for n, c in K.launches.items() if c}
    kinds = cfg.layer_kinds()
    dense_launched(K.launches, f"dense {arch} check",
                   scan=any(k.startswith("mamba") for k in kinds),
                   attn=any(not k.startswith("mamba") for k in kinds))
    label = " ".join([arch] + [f"{k}={v}" for k, v in overrides.items()])
    log({"dense_check": f"reduced {label} f32, dense host-cache runner on "
                        f"cuda vs cpu", "steps": steps,
         "max_rel_logit_err": worst, "tol": 2e-4, "launches": launches})
    return launches


def dense_vs_paged(cfg, params, seed: int, card: str, dtype=None) -> dict:
    """Full-width LLaVA-1.5-7B, bf16 (or ``dtype``, the weights' type): a
    paged and a dense (host-cache) runner on the same weights take the
    same encode, two prefill chunks (the image, then 32 prompt tokens) and
    8 decode steps for 3 requests, each step fed the paged runner's greedy
    tokens; the dense logits held within ``DENSE_REL`` of the paged ones'
    largest magnitude each step (and, in f32, logged against the f32
    model checks' bar of 2e-4).  Returns the dense runner's launches; logs
    each step's error and both runners' wall time a call."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.engine import runner as R
    dtype = dtype or torch.bfloat16
    runners = {dc: R.ModelRunner(cfg, params, R.RunnerCaches(
        cfg, kv_blocks=128, img_blocks=4, dtype=dtype,
        device="cuda", device_cache=dc), device="cuda")
        for dc in (True, False)}      # 3 requests of 40 blocks at most
    reqs = llava_requests(cfg, seed)[:3]
    rids = list(range(len(reqs)))
    launches = dict.fromkeys(K.launches, 0)
    errs, wall = [], {"paged": {}, "dense": {}}

    def step(label, fn):
        outs = {}
        for dc in (True, False):
            before = dict(K.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs[dc] = fn(runners[dc])
            torch.cuda.synchronize()
            w = wall["paged" if dc else "dense"]
            w[label] = w.get(label, 0.0) + time.perf_counter() - t
            if not dc:
                for n in launches:
                    launches[n] += K.launches[n] - before[n]
        if outs[True] is None:
            return None
        rel = float(np.abs(outs[False] - outs[True]).max()
                    / np.abs(outs[True]).max())
        errs.append(rel)
        if not rel <= DENSE_REL:
            raise AssertionError(f"dense vs paged, {label}: logits off by "
                                 f"{rel} (rel), bar {DENSE_REL}")
        return outs[True]

    step("encode", lambda r: r.encode([(i, m) for i, (_, m, _) in
                                       enumerate(reqs)]))
    step("prefill_image", lambda r: r.prefill_chunks(
        [(i, None, True) for i in rids]))
    toks = np.argmax(step("prefill_text", lambda r: r.prefill_chunks(
        [(i, p, False) for i, (p, _, _) in enumerate(reqs)])), -1)
    for _ in range(8):
        toks = np.argmax(step("decode", lambda r: r.decode(rids, toks)), -1)
    dense_launched(launches, "dense runner", scan=False, attn=True)
    log({"dense_vs_paged": f"llava-1.5-7b {dname(dtype)} full width "
                           f"({cfg.num_layers} layers), 3 requests: "
                           "encode, image chunk, 32-token chunk, 8 decode "
                           "steps teacher-forced by the paged runner",
         "card": card, "rel_logit_err_by_step": errs,
         "max_rel_logit_err": max(errs), "bar": DENSE_REL,
         **({"within_f32_bar_2e-4": max(errs) <= 2e-4}
            if dtype == torch.float32 else {}),
         "wall_s_by_call": wall,
         "dense_launches": {n: c for n, c in launches.items() if c}})
    for r in runners.values():
        for rid in rids:
            r.caches.release(rid)
    return launches


def serve_dense(seed: int, card: str, paged: dict) -> dict:
    """The dense host-cache fallback: ``dense_vs_paged`` on full-width
    LLaVA-1.5-7B, then ``Engine(..., device_cache=False)`` E1+P1+D1 on the
    same weights with ``serve``'s five requests and its 256 blocks an
    instance (f32 host pools, 4.3 GB each allocated, committed as rows are
    written), logged beside the paged main path's reading ``paged``, then the reduced f32 card-vs-CPU checks of
    ``DENSE_CHECKS``.  Returns the Engine run's launches, with the scan's
    from the reduced falcon-mamba and zamba2 checks."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import DisaggConfig
    from repro_torch.engine.api import Engine
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg = get_config("llava-1.5-7b")
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), dtype=torch.bfloat16)
    t_pair = time.perf_counter()
    dense_vs_paged(cfg, params, seed, card)
    t_eng = time.perf_counter()
    rss0 = rss_gb()
    eng = Engine(cfg, params, DisaggConfig({"E": 1, "P": 1, "D": 1}),
                 kv_blocks=256, img_blocks=8, device="cuda",
                 device_cache=False)
    reqs = llava_requests(cfg, seed)
    with timed_calls(wall_split_targets()) as split:
        K.reset_launches()
        rs, outs, wall = run_requests(eng, reqs, cfg.vocab_size)
        launches = dict(K.launches)
    dense_launched(launches, "dense llava main path", scan=False, attn=True)
    srv = eng.server
    if srv.n_migrations < 2 * len(reqs):
        raise AssertionError(f"only {srv.n_migrations} migrations")
    check_reclaimed(srv)
    # the pools are allocated zero and lazily committed: the rows written
    # are what the host holds (the process's resident growth)
    host_gb = {"allocated": sum(c.data.nbytes for i in srv.instances
                                for c in (i.caches.kv, i.caches.img)) / 1e9,
               "resident_growth": rss_gb() - rss0}
    log({"dense_path": "Engine E1+P1+D1 device_cache=False, llava-1.5-7b "
                       "bf16, serve's 5 requests, host f32 pools",
         "card": card, "wall_s": wall, **request_metrics(rs),
         "migrations": srv.n_migrations,
         "migrated_bytes": srv.migrated_bytes, "launches": launches,
         "prefill_bodies": prefill_split(launches),
         "wall_split": split, "greedy_tokens_req0": outs[0],
         "host_pool_gb": host_gb,
         "greedy_req0_equal_paged": outs[0] == paged["greedy_tokens_req0"],
         "paged_main_path": {k: paged[k] for k in (
             "wall_s", "ttft_mean_s", "tpot_mean_s", "tpot_p90_s",
             "decode_tok_per_s", "migrations", "launches")}})
    del eng, srv, params
    gc.collect()
    torch.cuda.empty_cache()
    t_checks = time.perf_counter()
    for arch, overrides in DENSE_CHECKS:
        got = dense_model_check(arch, overrides, seed)
        for name in ("selective_scan", "selective_scan_heads"):
            launches[name] += got.get(name, 0)
    log({"phase_s": "serve_dense parts", "setup_s": t_pair - t0,
         "dense_vs_paged_s": t_eng - t_pair, "engine_s": t_checks - t_eng,
         "reduced_checks_s": time.perf_counter() - t_checks})
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
         "prefill_bodies": prefill_split(launches),
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
         "launches": launches,
         "prefill_bodies": prefill_split(launches), "wall_split": split,
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
    # serving drops the MoE FFN's aux loss, so its step must not compute
    # it: every call of moe_ffn and of aux_loss in the profiled step is
    # counted, and the step must make some of the first and none of the
    # second.  The step's launches are logged beside an earlier run's
    # (5,248, PERF.md run Z4) as a reading only: they follow the routing
    # of the random rows (an expert with no pair launches nothing)
    ffn, aux = moe.moe_ffn, moe.aux_loss
    calls = {"moe_ffn": 0, "aux_loss": 0}

    def annotated(*a, **k):
        calls["moe_ffn"] += 1
        with torch.profiler.record_function("moe_ffn"):
            return ffn(*a, **k)

    def counted_aux(*a, **k):
        calls["aux_loss"] += 1
        return aux(*a, **k)
    d.runner.decode(rids, toks)
    moe.moe_ffn, moe.aux_loss = annotated, counted_aux
    try:
        step = profile_calls(lambda: d.runner.decode(rids, toks),
                             "decode step, B=4", card,
                             f"{arch}, {cfg.num_layers} layers, context {ctx}",
                             ranges=("moe_ffn",))
    finally:
        moe.moe_ffn, moe.aux_loss = ffn, aux
    log({"decode_launches_per_step": step["launches_per_call"],
         **({} if mla else {"run_z4": 5248}),
         "moe_ffn_calls": calls["moe_ffn"],
         "aux_loss_calls": calls["aux_loss"], "path": arch, "card": card})
    if not calls["moe_ffn"] or calls["aux_loss"]:
        raise AssertionError(f"{arch}: the decode steps called moe_ffn "
                             f"{calls['moe_ffn']} times and aux_loss "
                             f"{calls['aux_loss']} times")
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
                 "paged_prefill_attention", "paged_prefill_attention_wgmma"):
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
         "prefill_bodies": prefill_split(launches),
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
         "launches": launches,
         "prefill_bodies": prefill_split(launches), "wall_split": split,
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
# phase 5, continued: the serving entry point repro_torch.launch.serve
# ---------------------------------------------------------------------------
ATTN_KERNELS = ("cache_write", "paged_attention", "paged_prefill_attention")


def captured(fn, *a):
    """fn(*a) with its standard output caught, then echoed: (result,
    text)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def serve_cli(argv: list, card: str) -> dict:
    """``repro_torch.launch.serve.main(argv)`` in process, as a user runs
    the CLI on the card (full width, bf16 weights from a generator seeded
    with 0), the launch counters set to 0 just before it and read just
    after.  Checks from its printed lines that every request generated
    ``--max-new-tokens`` tokens from the vocabulary, and that every
    attention and cache-write kernel launched; returns the launches."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch import serve as S
    args = S.parse_args(argv)
    K.reset_launches()
    t0 = time.perf_counter()
    srv, text = captured(S.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    cfg = srv.cfg
    streams = [json.loads(m) for m in
               re.findall(r"^req \d+: (\[.*\])$", text, re.M)]
    if len(streams) != args.requests or any(
            len(t) != args.max_new_tokens
            or not all(0 <= x < cfg.vocab_size for x in t) for t in streams):
        raise AssertionError(f"{cfg.name}: streams {streams}")
    m = re.search(r"^(\d+) requests in ([0-9.]+)s, (\d+) migrations "
                  r"\(([0-9.]+) MB\)$", text, re.M)
    if m is None or int(m[1]) != args.requests or int(m[3]) < 1:
        raise AssertionError(f"{cfg.name}: no migration line in {text!r}")
    for name in ATTN_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{cfg.name} CLI path")
    check_reclaimed(srv)
    log({"cli": "python -m repro_torch.launch.serve " + " ".join(argv),
         "card": card, "arch": cfg.name, "layers": cfg.num_layers,
         "d_model": cfg.d_model, "heads": cfg.num_heads,
         "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
         "wall_s_with_weights": wall, "serve_wall_s": float(m[2]),
         "migrations": int(m[3]), "migrated_mb": float(m[4]),
         "launches": launches,
         "prefill_bodies": prefill_split(launches)})
    return launches


def http_call(port: int, method: str, path: str, body=None):
    """(status, headers, body text) of one request to the front."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, resp.getheader("Content-Type"), resp.read().decode()
    conn.close()
    return out


def serve_http(card: str) -> dict:
    """The port's HTTP front on full-width LLaVA-1.5-7B, E1+P1+D1, started
    on port 0 through ``build_http`` as ``--http`` starts it: one
    non-streaming and one streaming greedy completion of an image and a
    text part (the JSON body, the SSE framing ending in ``data: [DONE]``,
    the same 12 tokens in both and from ``Engine.generate`` on the same
    prompt ids and pseudo-embedding), ``/v1/models`` and an unknown
    model's 404; TTFT over HTTP (POST to the first token event).  Returns
    the launches of the two completions."""
    import threading
    import torch
    from repro_torch import kernels as K
    from repro_torch.core.request import SamplingParams
    from repro_torch.launch import serve as S
    t0 = time.perf_counter()
    httpd, engine = S.build_http(S.parse_args(
        ["--http", "--arch", "llava-1.5-7b", "--disagg", "E1,P1,D1",
         "--host", "127.0.0.1", "--port", "0"]))
    setup_s = time.perf_counter() - t0
    cfg = engine.server.cfg
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    url, n_new = "http://x/cat.png", 12
    body = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "describe this image"},
        {"type": "image_url", "image_url": {"url": url}}]}],
        "max_tokens": n_new, "temperature": 0}
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        status, ctype, text = http_call(port, "POST",
                                        "/v1/chat/completions", body)
        complete_s = time.perf_counter() - t0
        out = json.loads(text)
        choice = out["choices"][0]
        toks = [int(t) for t in re.findall(r"<(\d+)>",
                                           choice["message"]["content"])]
        if (status != 200 or out["object"] != "chat.completion"
                or choice["finish_reason"] != "length"
                or out["usage"]["completion_tokens"] != n_new
                or len(toks) != n_new):
            raise AssertionError(f"completion: {status} {text}")

        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/v1/chat/completions",
                     json.dumps({**body, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200 or not resp.getheader(
                "Content-Type", "").startswith("text/event-stream"):
            raise AssertionError(f"stream: {resp.status}")
        lines, ttft = [], None
        while line := resp.readline().decode():
            lines.append(line)
            if ttft is None and '"content"' in line:
                ttft = time.perf_counter() - t0
        stream_s = time.perf_counter() - t0
        conn.close()
        launches = dict(K.launches)
        # SSE framing: "data: <event>" lines, each closed by a blank line
        if (lines[1::2] != ["\n"] * (len(lines) // 2) or len(lines) % 2
                or not all(ln.startswith("data: ") for ln in lines[::2])
                or lines[-2] != "data: [DONE]\n"):
            raise AssertionError(f"SSE framing: {lines}")
        events = [json.loads(ln[6:]) for ln in lines[:-2:2]]
        deltas = [e["choices"][0]["delta"] for e in events]
        stoks = [int(d["content"][1:-1]) for d in deltas if "content" in d]
        if (deltas[0].get("role") != "assistant"
                or events[-1]["choices"][0]["finish_reason"] != "length"):
            raise AssertionError(f"SSE events: {events}")

        stream = engine.generate(S.encode_text("describe this image",
                                               cfg.vocab_size),
                                 media=[S.media_from_url(url, cfg)],
                                 sampling=SamplingParams(max_tokens=n_new))
        etoks = stream.tokens()
        engine.release(stream.rid)
        if not toks == stoks == etoks:
            raise AssertionError(f"greedy tokens differ: HTTP {toks}, SSE "
                                 f"{stoks}, Engine.generate {etoks}")
        status, _, text = http_call(port, "GET", "/v1/models")
        if status != 200 or json.loads(text)["data"][0]["id"] != cfg.name:
            raise AssertionError(f"/v1/models: {status} {text}")
        status, _, text = http_call(port, "POST", "/v1/chat/completions",
                                    {"model": "gpt-oss-419b",
                                     "messages": [{"content": "hi"}]})
        if status != 404 or json.loads(text)["error"]["type"] != \
                "model_not_found":
            raise AssertionError(f"unknown model: {status} {text}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close(drain_timeout=0)
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the HTTP front's thread did not stop")
    for name in ATTN_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched behind the "
                                 f"HTTP front")
    torch.cuda.synchronize()
    log({"http_front": "repro_torch.launch.serve --http, llava-1.5-7b "
                       "E1+P1+D1 bf16, one image + 3 words, 12 greedy tokens",
         "card": card, "setup_s": setup_s, "complete_s": complete_s,
         "ttft_http_s": ttft, "stream_s": stream_s, "tokens": toks,
         "launches": launches,
         "prefill_bodies": prefill_split(launches)})
    return launches


def serve_sim(card: str):
    """``--sim`` once: the simulator on the host, as the JAX CLI runs it."""
    from repro_torch.launch import serve as S
    argv = ["--sim", "--arch", "llava-next-7b", "--dataset", "textcaps",
            "--rate", "8", "--n", "60"]
    t0 = time.perf_counter()
    _, text = captured(S.main, argv)
    m = re.fullmatch(r"rate=8.0 attainment=([0-9.]+)% p90_ttft=[0-9.]+s "
                     r"p90_tpot=[0-9.]+ms tok/s=\d+\n", text)
    if m is None or not 0.0 <= float(m[1]) <= 100.0:
        raise AssertionError(f"--sim printed {text!r}")
    log({"sim": " ".join(argv), "card": card, "line": text.strip(),
         "s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# sharded serving steps: two ranks on the card over gloo
# ---------------------------------------------------------------------------
SHARD_ARCHS = ("llava-1.5-7b", "granite-moe-1b-a400m", "falcon-mamba-7b")
# Full width, a step's logits: in f32 (the bf16-drawn weights upcast) the
# sharded run within SHARD_F32_REL of the unsharded one's largest logit, the
# same greedy tokens; in bf16 no farther from that f32 run than
# SHARD_BF16_FACTOR times the unsharded bf16 run's own distance from it.
# bf16 rounding alone moves these random-weight models' logits by 2-7% of
# the largest (the unsharded bf16 run against its own f32 run, which this
# phase logs as ``bf16_unsharded_vs_f32``), so two bf16 runs that round in
# another order cannot be held to a fixed bar or to equal greedy tokens;
# the bf16 run is what checks the bf16-only f32-output product of the
# partial sums (``sharding.row_parallel``).
SHARD_F32_REL = 2e-4   # also reduced f32: sharded on the card vs the CPU
SHARD_BF16_FACTOR = 2.0
SHARD_STEPS = 8        # teacher-forced decode steps after the prefill
SHARD_MESHES = ((1, 2), (2, 1))      # the reduced checks' (data, model)
SHARD_TIMEOUT_S = 600
SHARD_KERNELS = ("flash_attention", "paged_attention", "cache_write",
                 "selective_scan")


def shard_inputs(cfg, seed: int):
    """B = 2 prompts of 32 tokens and, for a vision model, one 576 x 4096
    image pseudo-embedding each (numpy, from ``seed``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    media = None
    if cfg.frontend == "vision":
        media = (rng.standard_normal((2, cfg.media_tokens, cfg.d_model))
                 * 0.1).astype(np.float32)
    return tokens, media


def shard_steps(cfg, params, tokens, media, fed=None, rows=slice(None)):
    """The dense serving steps (``prefill``, ``build_cache_from_prefill``,
    then ``SHARD_STEPS`` ``decode_step``s) on rows ``rows`` of the batch,
    fed the tokens ``fed`` ([B, 1] a step, the unsharded run's) or their
    own greedy tokens.  Returns (each step's logits, f32 on the host; the
    tokens fed)."""
    import torch
    from repro_torch.models import model as M
    dev = params.device
    t = torch.from_numpy(tokens[rows]).to(dev)
    m = None if media is None else torch.from_numpy(media[rows]).to(dev)
    n_in = t.shape[1] + (0 if m is None else m.shape[1])
    with torch.no_grad():
        last, cache = M.prefill(cfg, params, t, media=m)
        cache = M.build_cache_from_prefill(cfg, cache,
                                           n_in + SHARD_STEPS + 1)
        steps, given = [last.float().cpu()], []
        for i in range(SHARD_STEPS):
            tok = steps[-1].argmax(-1, keepdim=True).to(torch.int32) \
                if fed is None else fed[i][rows]
            given.append(tok)
            out, cache = M.decode_step(cfg, params, cache, n_in + i,
                                       tok.to(dev))
            steps.append(out.float().cpu())
    return steps, given


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in params.parameters())


def sharded_rank(rank: int, world: int, port: int, seed: int, tmp: str):
    """One rank of the ``sharded`` phase (spawned): joins the gloo group,
    draws each model's full bf16 weights from the seeded generator, keeps
    its cut (``shard_params``) and runs the dense steps under a (1, 2) mesh
    fed the unsharded run's tokens, its kernel launches counted from 0,
    then the same in f32 (its cut upcast); then the reduced f32 models at
    each of ``SHARD_MESHES``.  Writes its results to ``tmp``."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as SH
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=SHARD_TIMEOUT_S))
    try:
        fed = torch.load(Path(tmp) / "fed.pt", weights_only=False)
        out = {}
        mesh = make_host_mesh(model=world)
        for arch in SHARD_ARCHS:
            t0 = time.perf_counter()
            cfg = get_config(arch)
            full = M.init_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(seed), dtype=torch.bfloat16)
            local = SH.shard_params(full, cfg, mesh)
            del full
            gc.collect()
            torch.cuda.empty_cache()
            inputs = shard_inputs(cfg, seed)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            K.reset_launches()
            with SH.use_mesh(mesh):
                steps, _ = shard_steps(cfg, local, *inputs, fed[arch])
            torch.cuda.synchronize()
            res = {"steps": steps, "bytes": param_bytes(local),
                   "launches": {n: c for n, c in K.launches.items() if c},
                   "setup_s": t1 - t0, "steps_s": time.perf_counter() - t1}
            with SH.use_mesh(mesh):
                res["steps_f32"], _ = shard_steps(cfg, local.float(),
                                                  *inputs, fed[arch])
            out[arch] = res
            del local
            gc.collect()
            torch.cuda.empty_cache()
        for shape in SHARD_MESHES:
            m = make_host_mesh(model=shape[1])
            for arch in SHARD_ARCHS:
                cfg = get_config(arch).reduced()
                full = M.init_params(cfg, torch.Generator().manual_seed(
                    seed)).to("cuda")
                with SH.use_mesh(m):
                    local = SH.shard_params(full, cfg)
                    n, r = SH.dp_size(), SH.dp_rank()
                    rows = slice(r * 2 // n, (r + 1) * 2 // n)
                    K.reset_launches()
                    steps, _ = shard_steps(cfg, local, *shard_inputs(
                        cfg, seed), fed[f"{arch} reduced"], rows)
                out[(arch, shape)] = {
                    "steps": steps, "rows": (rows.start, rows.stop),
                    "launches": {n: c for n, c in K.launches.items() if c}}
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def max_rel(got: list, want: list, rows=slice(None)) -> list:
    """Each step's largest error over the reference's largest logit."""
    return [float((g - w[rows]).abs().max() / w[rows].abs().max())
            for g, w in zip(got, want)]


def same_greedy(got: list, want: list) -> bool:
    """The same greedy token at every step and lane."""
    return all(bool((g.argmax(-1) == w.argmax(-1)).all())
               for g, w in zip(got, want))


def spawn_ranks(fn, world: int, args: tuple, timeout_s: float):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes; a
    rank that fails fails the call (its traceback raised here), and ranks
    still running after ``timeout_s`` are stopped."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world,) + args, nprocs=world,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1):          # raises if a rank failed
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)


def sharded(seed: int, card: str) -> dict:
    """The sharded serving steps (``models/sharding.py``) on two ranks of
    one card over gloo, mesh (data, model) = (1, 2): full-width
    LLaVA-1.5-7B (one image + 32 tokens, B = 2), granite-moe-1b-a400m (16
    experts a rank) and falcon-mamba-7b, bf16 weights drawn from the
    seeded generator; prefill and ``SHARD_STEPS`` decode steps fed the
    unsharded bf16 run's greedy tokens, against this process's unsharded
    run of the same weights and inputs on the card, in f32 (the weights
    upcast; ``SHARD_F32_REL``, the same greedy tokens) and in bf16
    (``SHARD_BF16_FACTOR``); each rank's launches of flash, decode and the
    cache write, or of the scan; then the reduced f32 models at (1, 2) and
    (2, 1) against their unsharded run on the CPU (``SHARD_F32_REL``).
    Returns each rank's launches of ``SHARD_KERNELS`` over the three
    full-width bf16 runs."""
    import socket
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    want = {}
    for arch in SHARD_ARCHS:             # the unsharded runs, on the card
        cfg = get_config(arch)
        params = M.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(seed), dtype=torch.bfloat16)
        inputs = shard_inputs(cfg, seed)
        steps, fed = shard_steps(cfg, params, *inputs)
        want[arch] = {"steps": steps, "fed": fed,
                      "bytes": param_bytes(params)}
        want[arch]["steps_f32"], _ = shard_steps(cfg, params.float(),
                                                 *inputs, fed)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for arch in SHARD_ARCHS:             # reduced f32, on the CPU
        cfg = get_config(arch).reduced()
        params = M.init_params(cfg, torch.Generator().manual_seed(seed))
        steps, fed = shard_steps(cfg, params, *shard_inputs(cfg, seed))
        want[f"{arch} reduced"] = {"steps": steps, "fed": fed}
    t_spawn = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({a: w["fed"] for a, w in want.items()},
                   Path(tmp) / "fed.pt")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        spawn_ranks(sharded_rank, 2, (port, seed, tmp), SHARD_TIMEOUT_S)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
    launches = {n: [0, 0] for n in SHARD_KERNELS}
    for arch in SHARD_ARCHS:
        cfg = get_config(arch)
        w = want[arch]
        got = [r[arch] for r in ranks]
        need = ("selective_scan",) if arch == "falcon-mamba-7b" else \
            ("flash_attention", "paged_attention", "cache_write")
        for i, g in enumerate(got):
            missing = [n for n in need if not g["launches"].get(n)]
            if missing:
                raise AssertionError(f"sharded {arch}: rank {i} never "
                                     f"launched {missing}")
            for n in SHARD_KERNELS:
                launches[n][i] += g["launches"].get(n, 0)
        reading = {
            "f32": max(max(max_rel(g["steps_f32"], w["steps_f32"]))
                       for g in got),
            "bf16": max(max(max_rel(g["steps"], w["steps"])) for g in got),
            "bf16_sharded_vs_f32": max(max(max_rel(g["steps"],
                                                   w["steps_f32"]))
                                       for g in got),
            "bf16_unsharded_vs_f32": max(max_rel(w["steps"],
                                                 w["steps_f32"]))}
        greedy = {"f32": all(same_greedy(g["steps_f32"], w["steps_f32"])
                             for g in got),
                  "bf16": all(same_greedy(g["steps"], w["steps"])
                              for g in got)}
        log({"sharded": f"{arch} full width ({cfg.num_layers} layers), "
                        f"mesh (data, model) = (1, 2): two ranks on one "
                        f"card over gloo, prefill + {SHARD_STEPS} decode "
                        f"steps fed the unsharded bf16 run's tokens, bf16 "
                        f"and f32",
             "card": card,
             "rel_logit_err_by_step": {
                 "f32": max_rel(got[0]["steps_f32"], w["steps_f32"]),
                 "bf16": max_rel(got[0]["steps"], w["steps"])},
             "max_rel_logit_err": reading, "bar_f32": SHARD_F32_REL,
             "bar_bf16_sharded_vs_f32": SHARD_BF16_FACTOR
             * reading["bf16_unsharded_vs_f32"],
             "greedy_equal": greedy,
             "weight_bytes_by_rank": [g["bytes"] for g in got],
             "weight_bytes_unsharded": w["bytes"],
             "launches_by_rank": [g["launches"] for g in got],
             "setup_s_by_rank": [g["setup_s"] for g in got],
             "steps_s_by_rank": [g["steps_s"] for g in got]})
        if not reading["f32"] <= SHARD_F32_REL or not greedy["f32"]:
            raise AssertionError(f"sharded {arch}, f32: logits off by "
                                 f"{reading['f32']} (rel), bar "
                                 f"{SHARD_F32_REL}; greedy tokens equal: "
                                 f"{greedy['f32']}")
        if not reading["bf16_sharded_vs_f32"] <= \
                SHARD_BF16_FACTOR * reading["bf16_unsharded_vs_f32"]:
            raise AssertionError(f"sharded {arch}, bf16: {reading}")
    for shape in SHARD_MESHES:
        for arch in SHARD_ARCHS:
            w = want[f"{arch} reduced"]["steps"]
            worst = max(max(max_rel(r[(arch, shape)]["steps"], w,
                                    slice(*r[(arch, shape)]["rows"])))
                        for r in ranks)
            log({"sharded_check": f"reduced {arch} f32, mesh (data, model) "
                                  f"= {shape} on the card vs unsharded on "
                                  f"the cpu, prefill + {SHARD_STEPS} "
                                  f"decode steps",
                 "max_rel_logit_err": worst, "tol": SHARD_F32_REL,
                 "launches_by_rank": [r[(arch, shape)]["launches"]
                                      for r in ranks]})
            if not worst < SHARD_F32_REL:
                raise AssertionError(f"sharded {arch} {shape} check: "
                                     f"logits off by {worst} (rel)")
    log({"phase_s": "sharded parts", "unsharded_runs_s": t_spawn - t0,
         "ranks_s": time.perf_counter() - t_spawn})
    return launches


def timed(label: str, fn, *args):
    """fn(*args), its wall seconds logged under ``label``."""
    t = time.perf_counter()
    out = fn(*args)
    log({"phase_s": label, "s": time.perf_counter() - t})
    return out


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
    timed("decode_cases", decode_cases, gen, dev, results)
    timed("prefill_cases", prefill_cases, gen, dev, results)
    timed("cache_write_cases", cache_write_cases, gen, dev, results)
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import ref as scan_ref
    rate, fma = exp_rate(), fma_rate()
    timed("scan_cases", scan_cases, gen, dev, results, "selective_scan",
          scan_ops.selective_scan, scan_ref.selective_scan_ref, scan_inputs,
          lambda B, S, isz: scan_bound(B, S, isz, rate),
          f"d={D_INNER} N={N_STATE}", torch.float32)
    torch.cuda.empty_cache()
    # the per-head mode (Mamba-2) at zamba2-7b's widths
    timed("scan_heads_cases", scan_cases, gen, dev, results,
          "selective_scan_heads", scan_ops.selective_scan_heads,
          scan_ref.selective_scan_heads_ref, heads_inputs,
          lambda B, S, isz: heads_bound(B, S, isz, fma, rate),
          f"H={ZH} P={ZP} N={ZN}", torch.bfloat16, HEADS_CASES)
    torch.cuda.empty_cache()
    timed("width_attention_zamba2", width_attention_cases, gen, dev, results,
          "zamba2", ZAH, ZAH, ZD)
    torch.cuda.empty_cache()
    timed("width_attention_d160", width_attention_cases, gen, dev, results,
          "d160", SH, SKH, SD, True)
    torch.cuda.empty_cache()
    # gemma3-4b's attention (H = 8 over Kh = 4, D = 256): its chunks stay
    # on the tile; logged as kernel lines, not on a main path
    timed("width_attention_d256", width_attention_cases, gen, dev, results,
          "d256", GMH, GMKH, GMD)
    torch.cuda.empty_cache()
    timed("flash_cases", flash_cases, gen, dev, results, rate)
    torch.cuda.empty_cache()
    timed("flash_bwd_cases", flash_bwd_cases, gen, dev, results, rate)
    torch.cuda.empty_cache()
    timed("width_flash_cases", width_flash_cases, gen, dev, results, rate)
    torch.cuda.empty_cache()
    timed("scan_bwd_cases", scan_bwd_cases, gen, dev, results)
    torch.cuda.empty_cache()
    timed("latent_cases", latent_cases, gen, dev, results)
    torch.cuda.empty_cache()
    for name, r in results.items():
        log({"kernel": name, "card": card, **r})
    log({"phase": "kernels", "s": time.perf_counter() - t0})

    timed("model_check", model_check, args.seed)
    timed("mamba_model_check", mamba_model_check, args.seed)
    timed("whisper_model_check", whisper_model_check, args.seed)
    for arch in ("granite-moe-1b-a400m", "deepseek-v2-236b", "zamba2-7b",
                 "gemma3-4b"):
        timed(f"arch_model_check {arch}", arch_model_check, arch, args.seed)
    # training: reduced f32 card vs CPU (LLaVA, falcon-mamba, zamba2,
    # granite-moe; DeepSeek-V2, zamba2, stablelm-12b and gemma3-4b at their
    # full attention widths), then full-width LLaVA (16 layers),
    # falcon-mamba-7b (32 layers), granite-moe-1b-a400m, zamba2-7b (42
    # layers), gemma3-4b and DeepSeek-V2 (1 layer), and train_mm
    checks = timed("train_check", train_check, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    trained = timed("train_full", train_full, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    trained_mamba = timed("train_full_mamba", train_full_mamba, args.seed,
                          card)
    gc.collect()
    torch.cuda.empty_cache()
    timed("train_full_moe", train_full_moe, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    trained_widths = {}
    for sfx, fn in (("d112", train_full_zamba2), ("d256", train_full_gemma3),
                    ("mla", train_full_mla)):
        trained_widths[sfx] = timed(fn.__name__, fn, args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()
    trained_widths["d160"] = checks[f"stablelm-12b head_dim={SD}"]
    timed("train_mm", train_mm_run, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches, paged_reading = timed("serve", serve, args.seed, card)
    gc.collect()                      # LLaVA's weights and pools go first
    torch.cuda.empty_cache()
    dense_launches = timed("serve_dense", serve_dense, args.seed, card,
                           paged_reading)
    gc.collect()
    torch.cuda.empty_cache()
    launches["selective_scan"] = timed("serve_mamba", serve_mamba, args.seed,
                                       card)["selective_scan"]
    gc.collect()
    torch.cuda.empty_cache()
    whisper = timed("serve_whisper", serve_whisper, args.seed, card)
    for name in ("flash_attention", "flash_attention_split",
                 "flash_attention_merge"):
        launches[name] = whisper[name]
    gc.collect()
    torch.cuda.empty_cache()
    timed("serve_moe granite", serve_moe, "granite-moe-1b-a400m", args.seed,
          card)
    gc.collect()
    torch.cuda.empty_cache()
    # the latent-row kernels and the 576-wide write count the DeepSeek-V2
    # path's launches
    deepseek = timed("serve_moe deepseek", serve_moe, "deepseek-v2-236b",
                     args.seed, card)
    for name in ("paged_attention_latent", "paged_prefill_attention_latent"):
        launches[name] = deepseek[name]
    launches["cache_write_mla"] = deepseek["cache_write"]
    gc.collect()
    torch.cuda.empty_cache()
    # the per-head scan and the D = 112 attention rows count zamba2's
    zamba = timed("serve_zamba", serve_zamba, args.seed, card)
    launches["selective_scan_heads"] = zamba["selective_scan_heads"]
    for name in ("paged_attention", "paged_prefill_attention"):
        launches[f"{name}_zamba2"] = zamba[name]
    # the wgmma prefill body: its launches on each main path
    wgmma_by_path = {"llava-1.5-7b": launches["paged_prefill_attention_wgmma"],
                     "zamba2-7b": zamba["paged_prefill_attention_wgmma"]}
    if not all(wgmma_by_path.values()):
        raise AssertionError(f"the wgmma prefill body did not launch on a "
                             f"main path: {wgmma_by_path}")
    gc.collect()
    torch.cuda.empty_cache()
    # the serving entry point: the CLI and the HTTP front on full-width
    # LLaVA-1.5-7B (the JAX CLI's defaults), then the CLI on full-width
    # stablelm-12b, whose every attention call runs a D = 160 instance
    timed("serve_cli llava", serve_cli,
          ["--arch", "llava-1.5-7b", "--disagg", "E1,P1,D1", "--requests",
           "6", "--max-new-tokens", "12"], card)
    gc.collect()
    torch.cuda.empty_cache()
    timed("serve_http", serve_http, card)
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    if get_config("stablelm-12b").head_dim != SD:
        raise AssertionError("stablelm-12b's head dim is not 160")
    stablelm = timed("serve_cli stablelm", serve_cli,
                     ["--arch", "stablelm-12b", "--disagg", "P1,D1"], card)
    for name in ("paged_attention", "paged_prefill_attention"):
        launches[f"{name}_d160"] = stablelm[name]
    wgmma_by_path["stablelm-12b cli"] = stablelm["paged_prefill_attention_wgmma"]
    launches["paged_prefill_attention_wgmma"] = sum(wgmma_by_path.values())
    for sfx, path in (("zamba2", zamba), ("d160", stablelm)):
        results[f"paged_prefill_attention_{sfx}"]["wgmma_launches"] = \
            path["paged_prefill_attention_wgmma"]
    # the body's row: zamba2-7b's timed chunk, stablelm-12b's and LLaVA's
    # image chunk beside it
    rows = [results[f"paged_prefill_attention{sfx}"]
            for sfx in ("_zamba2", "_d160", "")]
    results["paged_prefill_attention_wgmma"] = {
        **rows[0], "launches_by_path": wgmma_by_path,
        "max_abs_err": max(r["wgmma_max_abs_err"] for r in rows
                           if "wgmma_max_abs_err" in r),
        "other_shapes": rows[1:]}
    gc.collect()
    torch.cuda.empty_cache()
    timed("serve_sim", serve_sim, card)
    gc.collect()
    torch.cuda.empty_cache()
    sharded_launches = timed("sharded", sharded, args.seed, card)
    # a merge row's launches: the split calls, each merging in its last
    # blocks (the merge kernel alone never runs on the main paths)
    for name in ("paged_attention", "flash_attention"):
        if launches[f"{name}_merge"]:
            raise AssertionError(f"the {name} merge kernel launched on its "
                                 f"own on a main path")
        launches[f"{name}_merge"] = launches[f"{name}_split"]
    # the backward's launches: one train_full step's; the scan's backward:
    # one falcon-mamba train_full step's, and the per-head mode's the
    # reduced zamba2 step's (its only training path on the card)
    launches["flash_attention_bwd"] = trained["flash_attention_bwd"]
    launches["selective_scan_bwd"] = trained_mamba["selective_scan_bwd"]
    launches["selective_scan_heads_bwd"] = \
        checks["zamba2-7b"]["selective_scan_heads_bwd"]
    # the wider flash instances: a training step of the model that runs
    # them (stablelm-12b's D = 160: the reduced f32 step, its only
    # training path on the card)
    for sfx, counts in trained_widths.items():
        launches[f"flash_attention_{sfx}"] = counts["flash_attention"]
        launches[f"flash_attention_bwd_{sfx}"] = counts["flash_attention_bwd"]
        # of those, the bf16 calls on the wgmma body (the full-width
        # steps'; stablelm-12b's reduced step is f32: none)
        results[f"flash_attention_{sfx}"]["wgmma_launches"] = counts.get(
            "flash_attention_wgmma", 0)

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
           # its gradient (the JAX package differentiates jnp attention)
           "flash_attention_bwd": (
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:65"),
           # the scan's gradient, both modes (the JAX package
           # differentiates lax.scan over _ssm1_step / _ssm2_step)
           "selective_scan_bwd": (
               "src/repro_torch/csrc/selective_scan.cu",
               "src/repro/kernels/selective_scan/kernel.py:51"),
           "selective_scan_heads_bwd": (
               "src/repro_torch/csrc/selective_scan.cu",
               "src/repro/kernels/selective_scan/kernel.py:51"),
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
               "src/repro/kernels/paged_attention/kernel.py:162"),
           # stablelm-12b's attention (H = 32, Kh = 8, D = 160)
           "paged_attention_d160": (
               "src/repro_torch/csrc/paged_attention.cu",
               "src/repro/kernels/paged_attention/kernel.py:78"),
           "paged_prefill_attention_d160": (
               "src/repro_torch/csrc/paged_attention.cu",
               "src/repro/kernels/paged_attention/kernel.py:162"),
           # bf16 chunks at D = 112, 128 and 160 (pages of 8-32 rows) on the
           # wgmma body (attn_wgmma.cuh), K/V read from the pages by TMA
           "paged_prefill_attention_wgmma": (
               "src/repro_torch/csrc/paged_attention.cu",
               "src/repro/kernels/paged_attention/kernel.py:162"),
           # flash attention and its gradient at the other training widths:
           # zamba2-7b's D = 112, stablelm-12b's 160, gemma3-4b's 256 and
           # DeepSeek-V2's MLA (192, 128)
           **{f"flash_attention{part}_{sfx}": (
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:65")
              for sfx in ("d112", "d160", "d256", "mla")
              for part in ("", "_bwd")}}
    # the dense phase's launches (its full-width LLaVA Engine run; the
    # scans' from its reduced falcon-mamba and zamba2 checks), on the rows
    # of the kernels its path runs
    dense_rows = {n: dense_launches[n] for n in (
        "cache_write", "paged_attention", "paged_prefill_attention",
        "flash_attention", "selective_scan", "selective_scan_heads")}
    dense_rows["paged_attention_merge"] = dense_launches[
        "paged_attention_split"]
    dense_rows["flash_attention_merge"] = dense_launches[
        "flash_attention_split"]
    kernels = []
    for name, (source, replaces) in src.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        **({"launches_dense": dense_rows[name]}
                           if name in dense_rows else {}),
                        **({"launches_sharded": sharded_launches[name]}
                           if name in sharded_launches else {}),
                        **{key: r[key] for key in (
                            "device_ms", "device_ms_cold_l2",
                            "library_device_ms", "bound_share",
                            "bound_share_cold_l2", "n_split",
                            "fused_into", "launches_are", "standalone_ms",
                            "standalone_device_ms", "fused", "decode_b8",
                            "cli_max_abs_err", "lse_ms", "lse_device_ms",
                            "fwd_lse_ms", "fwd_lse_device_ms",
                            "fwd_device_ms", "pairs", "library",
                            "device_ms_by_kernel", "library_fwd_ms",
                            "library_fwd_device_ms", "other_shapes",
                            "occupancy", "fwd_bound_ms", "library_error",
                            "body", "wgmma_launches", "body_kernels",
                            "launches_by_path", "wgmma_max_abs_err")
                           if key in r}})
    log({"total_s": time.perf_counter() - t_start, "card": card})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
