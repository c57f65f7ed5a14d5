"""Serving metrics: TTFT / TPOT / SLO attainment / goodput (paper §2.3,
DESIGN.md §8).  ``goodput`` here is the exhaustive bisection; the autotuner
(DESIGN.md §7.1) wraps a warm-started, cached variant of the same search."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable


def slo_attainment(requests) -> float:
    done = [r for r in requests if r.first_token_time is not None]
    if not done:
        return 0.0
    return sum(1 for r in done if r.meets_slo()) / len(done)


def quantile(xs, q):
    if not xs:
        return float("nan")
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))
    return xs[i]


@dataclass
class RunStats:
    rate: float
    attainment: float
    p50_ttft: float
    p90_ttft: float
    p50_tpot: float
    p90_tpot: float
    throughput_rps: float
    tokens_per_s: float


def summarize(requests, rate: float, horizon: float) -> RunStats:
    fin = [r for r in requests if r.finish_time is not None]
    ttfts = [r.ttft() for r in fin if r.ttft() is not None]
    tpots = [t for r in fin for t in r.tpots()]
    toks = sum(r.tokens_out for r in fin)
    return RunStats(
        rate=rate,
        attainment=slo_attainment(fin),
        p50_ttft=quantile(ttfts, 0.5),
        p90_ttft=quantile(ttfts, 0.9),
        p50_tpot=quantile(tpots, 0.5),
        p90_tpot=quantile(tpots, 0.9),
        throughput_rps=len(fin) / horizon if horizon else 0.0,
        tokens_per_s=toks / horizon if horizon else 0.0,
    )


def goodput(run_at_rate: Callable[[float], float], *, lo: float = 0.25,
            hi: float = 64.0, target: float = 0.9, tol: float = 0.125,
            max_iters: int = 12, grow_to: float = 512.0) -> float:
    """Max request rate with SLO attainment >= target (bisection sweep).

    ``run_at_rate(rate) -> attainment``.  The bracket grows past ``hi`` on
    success, up to ``grow_to``; pass ``grow_to=hi`` to make ``hi`` a hard
    cap (the disaggregation searches do, so exhaustive and autotuned runs
    explore the same rate range).
    """
    if run_at_rate(lo) < target:
        return 0.0
    # grow hi until failure (or the cap, which then needs no bisection)
    while run_at_rate(hi) >= target:
        if hi >= grow_to:
            return hi
        lo = hi
        hi = min(hi * 2, grow_to)
    for _ in range(max_iters):
        if hi - lo <= tol:
            break
        mid = 0.5 * (lo + hi)
        if run_at_rate(mid) >= target:
            lo = mid
        else:
            hi = mid
    return lo
