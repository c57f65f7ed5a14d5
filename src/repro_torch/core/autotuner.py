"""Disaggregation autotuner (DESIGN.md §7): fast profile-driven search for
the goodput-maximizing disaggregation method + instance ratio, including
heterogeneous clusters where each role group runs on its own hardware.

Replaces the naive serial grid of ``hybrid_epd.search_disaggregation``
(every candidate scored with a full goodput bisection) with four
optimizations that preserve the argmax:

  1. cost-model upper bounds — a candidate's goodput can never exceed the
     aggregate per-stage service capacity of its instances (roofline, no
     queueing/interference), so candidates whose bound falls below the best
     goodput found so far are pruned without a single simulation;
  2. warm-started bisection — candidates are visited in descending-bound
     order and each bisection brackets around the incumbent best rate
     instead of restarting from the full [lo, max_rate] interval;
  3. simulation caching — results are memoized on (disagg, rate, seed, …)
     with probe rates quantized to the bisection tolerance grid;
  4. ``concurrent.futures`` fan-out — surviving candidates are evaluated in
     waves of worker threads, with pruning re-applied between waves.  Note
     the simulator is pure Python, so on CPython the threads are GIL-bound:
     the measured speedup comes from (1)-(3) running *fewer* simulations,
     not from parallelism; the wave structure exists so a free-threaded or
     subinterpreter runtime can exploit it.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.costmodel import BatchWork, Hardware, batch_time
from repro_torch.core.request import SLO, Stage
from repro_torch.core.simulator import ROLE_SETS, DisaggConfig, RoleSpec
from repro_torch.data.workload import WorkloadProfile


# ---------------------------------------------------------------------------
# candidate enumeration (heterogeneous)
# ---------------------------------------------------------------------------
def _compositions(n: int, k: int):
    """All ways to write n = c_1 + ... + c_k with every c_i >= 1."""
    if k == 1:
        yield (n,)
        return
    for first in range(1, n - k + 2):
        for rest in _compositions(n - first, k - 1):
            yield (first,) + rest


def enumerate_hetero_disaggs(pools, *, multimodal: bool = True,
                             methods: Optional[list] = None
                             ) -> list[DisaggConfig]:
    """Enumerate disaggregations over a heterogeneous cluster.

    ``pools`` is a list of ``(Hardware, count)`` device pools.  Each role
    group of a method (e.g. ``EP`` and ``D`` for method ``EP+D``) is pinned
    to exactly one pool; groups sharing a pool split its devices in every
    ratio; every device of every pool is used.  This is the paper-relevant
    shape (encode/prefill on compute-heavy chips vs decode on
    bandwidth-heavy ones) without the combinatorial blowup of per-instance
    assignment.
    """
    methods = methods or (["EP+D", "ED+P", "E+P+D"] if multimodal
                          else ["P+D"])
    out, seen = [], set()
    for method in methods:
        groups = method.split("+")
        if len(groups) < 2 and len(pools) > 1:
            continue  # a single group cannot span two hardware types
        for assign in itertools.product(range(len(pools)),
                                        repeat=len(groups)):
            if set(assign) != set(range(len(pools))):
                continue  # use every pool
            per_pool = {p: [g for g, a in zip(groups, assign) if a == p]
                        for p in range(len(pools))}
            if any(len(gs) > pools[p][1] for p, gs in per_pool.items()):
                continue  # more groups than devices in the pool
            splits = [list(_compositions(pools[p][1], len(gs)))
                      for p, gs in per_pool.items() if gs]
            pool_ids = [p for p, gs in per_pool.items() if gs]
            for combo in itertools.product(*splits):
                counts = {}
                for p, split in zip(pool_ids, combo):
                    hw = pools[p][0]
                    for g, c in zip(per_pool[p], split):
                        counts[g] = RoleSpec(count=c, hw=hw)
                dc = DisaggConfig(counts)
                if dc.name not in seen:
                    seen.add(dc.name)
                    out.append(dc)
    return out


# ---------------------------------------------------------------------------
# cost-model goodput upper bound
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class WorkloadStats:
    """Mean per-request work, estimated by sampling the profile."""
    prefill_tokens: float
    decode_tokens: float
    images: float
    decode_context: float


def workload_stats(profile: WorkloadProfile, image_tokens_per_image: int,
                   *, n: int = 512, seed: int = 0,
                   cache=None) -> WorkloadStats:
    """Mean per-request stage work sampled from the profile.  ``cache``
    (a ``costmodel.CacheFeedback``) discounts prefill tokens and encode
    images by their measured hit rates — decode context is NOT discounted:
    cache-adopted pages are still read every decode step."""
    rng = np.random.default_rng(seed)
    pre, dec, img = [], [], []
    for _ in range(n):
        n_img, prompt, out = profile.sample_lengths(rng)
        pre.append(prompt + n_img * image_tokens_per_image)
        dec.append(out)
        img.append(n_img)
    pre_m, dec_m = float(np.mean(pre)), float(np.mean(dec))
    img_m = float(np.mean(img))
    ctx = pre_m + dec_m / 2
    if cache is not None:
        pre_m = cache.effective_prefill(pre_m)
        img_m = cache.effective_images(img_m)
    return WorkloadStats(prefill_tokens=pre_m, decode_tokens=dec_m,
                         images=img_m, decode_context=ctx)


def _stage_rate(cfg: ModelConfig, hw: Hardware, tp: int, stage: Stage,
                stats: WorkloadStats) -> float:
    """Best-case requests/s one instance can serve for one stage.

    Evaluated at large, efficiency-friendly batch compositions, so it upper
    bounds what the simulator (finite batches, mixed work, queueing) attains.
    """
    if stage == Stage.ENCODE:
        if stats.images <= 0:
            return float("inf")
        B = 64
        t = batch_time(cfg, hw, BatchWork(encode_images=B), tp=tp)
        return B / t / stats.images
    if stage == Stage.PREFILL:
        N = 8192
        t = batch_time(cfg, hw, BatchWork(
            prefill_tokens=N, prefill_batch=4,
            prefill_context=max(1, int(stats.prefill_tokens))), tp=tp)
        return N / t / stats.prefill_tokens
    # decode: bandwidth-bound; rate grows with batch toward an asymptote
    B = 1024
    ctx = max(1, int(stats.decode_context))
    t = batch_time(cfg, hw, BatchWork(decode_batch=B, decode_context=ctx),
                   tp=tp)
    return B / t / stats.decode_tokens


def _horizon_corrected(cap_rate: float, ttft_slack: float,
                       n_requests: int) -> float:
    """Finite-horizon TTFT bound for a work-conserving stage.

    With ``n`` requests arriving at rate ``r``, the k-th request's
    time-to-first-token satisfies TTFT_k >= k * (1/cap - 1/r) (total work
    k/cap processed at aggregate capacity, arrival at k/r).  Attainment
    >= 90% forces the 0.9n-th request under the TTFT SLO, so

        r <= 1 / (1/cap - ttft / (0.9 n))

    and the stage is unconstrained over this horizon when the right-hand
    denominator is non-positive (the queue never outlives the SLO slack).
    """
    if cap_rate <= 0:
        return 0.0
    inv = 1.0 / cap_rate - ttft_slack / (0.9 * n_requests)
    return float("inf") if inv <= 0 else 1.0 / inv


def _decode_batch_cap(cfg: ModelConfig, hw: Hardware, tp: int,
                      stats: WorkloadStats) -> int:
    """Max concurrent decodes one instance admits (KV-capacity bound),
    mirroring ``Instance.__init__``'s capacity computation."""
    per_tok = max(cm.kv_bytes_per_token(cfg), 1)
    weight_bytes = cm.active_param_count(cfg) * cm.BYTES
    free = max(hw.mem_bytes * tp * 0.9 - weight_bytes, per_tok * 4096)
    per_req = (stats.prefill_tokens + stats.decode_tokens) * per_tok
    return max(1, int(free / max(per_req, 1)))


def _decode_bound(cfg: ModelConfig, hw_default: Hardware,
                  disagg: DisaggConfig, stats: WorkloadStats, slo: SLO, *,
                  n_requests: int, tp: int, slack: float) -> float:
    """TPOT-side upper bound on goodput over the simulated horizon.

    A finished request fails its TPOT SLO only if >10% of its token gaps
    exceed the budget, and a gap is one decode iteration at the current
    batch size.  Admission control caps that batch at the KV capacity, so:
    if some decode group's capped pile-up batch still iterates within the
    TPOT budget, decode cannot produce violations at all (requests queue —
    harming only TTFT, which the prefill bound already covers) and the
    stage is unconstrained.  Otherwise the pile-up stays below the largest
    TPOT-compliant batch B* only while the arrival rate is at most the
    aggregate service rate at B*.
    """
    ctx = max(1, int(stats.decode_context))
    dec_groups = [(s.hw if s.hw is not None else hw_default,
                   s.tp if s.tp is not None else tp, s.count)
                  for role, s in disagg.roles
                  if Stage.DECODE in ROLE_SETS[role]]
    if not dec_groups:
        return 0.0           # nothing can decode: no request ever finishes
    n_dec = sum(c for _, _, c in dec_groups)
    rate = 0.0
    for hw, itp, count in dec_groups:
        b_eff = min(_decode_batch_cap(cfg, hw, itp, stats),
                    max(1, -(-n_requests // n_dec)))
        def t_iter(b):
            return batch_time(cfg, hw, BatchWork(decode_batch=b,
                                                 decode_context=ctx), tp=itp)

        if t_iter(b_eff) <= slo.tpot:
            return float("inf")
        # largest TPOT-compliant batch B* (t_iter is monotone in batch);
        # service rate peaks there since b/t_iter(b) is increasing
        lo, hi = 1, b_eff
        if t_iter(lo) > slo.tpot:
            continue                 # even B=1 violates TPOT: contributes 0
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if t_iter(mid) <= slo.tpot:
                lo = mid
            else:
                hi = mid - 1
        rate += count * (lo / t_iter(lo)) / stats.decode_tokens
    return rate * slack


def upper_bound_goodput(cfg: ModelConfig, hw_default: Hardware,
                        disagg: DisaggConfig, stats: WorkloadStats,
                        slo: SLO, *, n_requests: int, tp: int = 1,
                        slack: float = 1.25) -> float:
    """Upper bound on a candidate's simulated goodput.

    Encode/prefill are TTFT-bound: aggregate roofline capacity with the
    finite-horizon correction of :func:`_horizon_corrected`.  Decode is
    TPOT-bound: see :func:`_decode_bound`.  ``slack`` inflates the capacity
    estimates so cost-model vs simulator discrepancy never prunes the true
    argmax.
    """
    cap = {Stage.ENCODE: 0.0, Stage.PREFILL: 0.0}
    for role, s in disagg.roles:
        hw = s.hw if s.hw is not None else hw_default
        itp = s.tp if s.tp is not None else tp
        for stage in ROLE_SETS[role]:
            # shared-role instances are granted to each stage in full —
            # generous, but that is what keeps this a true upper bound
            if stage in cap:
                cap[stage] += s.count * _stage_rate(cfg, hw, itp, stage,
                                                    stats)
    bounds = [_horizon_corrected(cap[Stage.PREFILL] * slack, slo.ttft,
                                 n_requests)]
    if stats.images > 0:
        bounds.append(_horizon_corrected(cap[Stage.ENCODE] * slack,
                                         slo.ttft, n_requests))
    bounds.append(_decode_bound(cfg, hw_default, disagg, stats, slo,
                                n_requests=n_requests, tp=tp, slack=slack))
    return min(bounds)


# ---------------------------------------------------------------------------
# autotuner
# ---------------------------------------------------------------------------
@dataclass
class CandidateResult:
    disagg: DisaggConfig
    bound: float
    goodput: Optional[float]      # None if pruned without simulation
    pruned: bool


@dataclass
class AutotuneResult:
    disagg: DisaggConfig
    goodput: float
    details: list                 # [CandidateResult], bound-descending
    n_sims: int                   # simulator invocations actually run
    n_pruned: int
    wall_s: float

    @property
    def scored(self) -> list:
        """(DisaggConfig, goodput) pairs, naive-search-compatible."""
        return [(c.disagg, c.goodput) for c in self.details
                if c.goodput is not None]


class _SimCache:
    """Memoized, counted attainment probes; thread-safe."""

    def __init__(self, simulate):
        self._simulate = simulate
        self._cache: dict = {}
        self._lock = threading.Lock()
        self.n_sims = 0

    def attain(self, disagg: DisaggConfig, rate: float) -> float:
        key = (disagg.name, rate)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        val = self._simulate(disagg, rate)
        with self._lock:
            if key not in self._cache:
                self._cache[key] = val
                self.n_sims += 1
        return self._cache[key]


def _quantize(rate: float, tol: float) -> float:
    return max(tol, round(rate / tol) * tol)


def _bisect_goodput(attain, *, hi_cap: float, guess: Optional[float],
                    target: float, tol: float,
                    lo_floor: float = 0.25) -> float:
    """Goodput bisection on the tol-grid with a warm-start first probe.

    ``attain(rate) -> attainment``; returns the largest grid rate observed
    to meet ``target`` (0.0 if none).  The first probe lands on the warm
    guess, so a candidate no better than the incumbent is typically
    rejected after a single simulation; a candidate that cannot even serve
    ``lo_floor`` is rejected after two.
    """
    lo, hi = 0.0, _quantize(hi_cap, tol) + tol
    probe = _quantize(min(guess, hi_cap) if guess else hi_cap, tol)
    first = True
    while hi - lo > tol:
        if not (lo < probe < hi):
            probe = _quantize((lo + hi) / 2, tol)
            if not (lo < probe < hi):
                break
        if attain(probe) >= target:
            lo = probe
        else:
            hi = probe
            if first and hi > lo_floor >= tol:
                fl = _quantize(lo_floor, tol)
                if attain(fl) < target:
                    return 0.0   # dead: fails even at the floor rate
                lo = fl
        first = False
        probe = _quantize((lo + hi) / 2, tol)
    return lo


def autotune_disaggregation(cfg: ModelConfig, hw: Hardware,
                            profile: WorkloadProfile, slo: SLO, *,
                            n_gpus: int = 8, policy: str = "hydra",
                            n_requests: int = 120,
                            candidates: Optional[list] = None,
                            image_tokens: Optional[int] = None,
                            max_rate: float = 64.0, target: float = 0.9,
                            tol: float = 0.125, bound_slack: float = 1.25,
                            max_workers: int = 4, tp: int = 1,
                            seed: int = 0, cache=None) -> AutotuneResult:
    """Bound-pruned, warm-started, cached, fanned-out disaggregation search.

    Drop-in accelerator for ``hybrid_epd.search_disaggregation``: same
    candidate space and simulator, same argmax (bound pruning only discards
    candidates provably below the incumbent), far fewer simulations.
    """
    from repro_torch.core.hybrid_epd import enumerate_disaggs, simulate_once

    t0 = time.perf_counter()
    multimodal = profile.p_image > 0
    cands = candidates or enumerate_disaggs(n_gpus, multimodal=multimodal)
    img = image_tokens if image_tokens is not None else cfg.media_tokens
    # measured cache hit rates tilt the stage-rate bounds: prefix hits
    # shrink prefill work, encode hits shrink encode work (DESIGN.md §14)
    stats = workload_stats(profile, img, seed=seed, cache=cache)

    def simulate(disagg, rate):
        s, _, _ = simulate_once(cfg, hw, disagg, profile, slo, rate=rate,
                                n_requests=n_requests, policy=policy,
                                image_tokens=image_tokens, seed=seed, tp=tp)
        return s.attainment

    cache = _SimCache(simulate)
    bounds = [(dc, min(max_rate,
                       upper_bound_goodput(cfg, hw, dc, stats, slo,
                                           n_requests=n_requests, tp=tp,
                                           slack=bound_slack)))
              for dc in cands]
    bounds.sort(key=lambda x: -x[1])

    results: dict = {}
    best_g, best_dc = 0.0, bounds[0][0]

    def evaluate(dc, bound, guess):
        g = _bisect_goodput(lambda r: cache.attain(dc, r),
                            hi_cap=bound, guess=guess, target=target, tol=tol)
        return dc, bound, g

    # incumbent first (highest bound), then waves of surviving candidates
    dc0, b0 = bounds[0]
    _, _, g0 = evaluate(dc0, b0, None)
    results[dc0.name] = CandidateResult(dc0, b0, g0, pruned=False)
    if g0 > best_g:
        best_g, best_dc = g0, dc0

    rest = bounds[1:]
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        for i in range(0, len(rest), max_workers):
            wave = rest[i:i + max_workers]
            live = []
            for dc, b in wave:
                if b <= best_g:
                    results[dc.name] = CandidateResult(dc, b, None,
                                                       pruned=True)
                else:
                    live.append((dc, b))
            futs = [ex.submit(evaluate, dc, b, best_g or None)
                    for dc, b in live]
            for f in futs:
                dc, b, g = f.result()
                results[dc.name] = CandidateResult(dc, b, g, pruned=False)
                if g > best_g:
                    best_g, best_dc = g, dc

    details = [results[dc.name] for dc, _ in bounds]
    return AutotuneResult(disagg=best_dc, goodput=best_g, details=details,
                          n_sims=cache.n_sims,
                          n_pruned=sum(1 for c in details if c.pruned),
                          wall_s=time.perf_counter() - t0)
