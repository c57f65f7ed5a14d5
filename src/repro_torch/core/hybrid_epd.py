"""Hybrid EPD Disaggregation (paper §4.4, DESIGN.md §7): enumerate
disaggregation methods and instance ratios, simulate each under the
workload + SLO profile, and select the configuration maximizing goodput.

``search_disaggregation`` is the exhaustive reference: every candidate gets
a full serial goodput bisection.  ``core.autotuner`` finds the same argmax
with cost-model pruning, warm starts, caching, and parallel fan-out — use
it for anything bigger than a toy grid (DESIGN.md §7.1)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import Hardware
from repro_torch.core.metrics import goodput, slo_attainment, summarize
from repro_torch.core.request import SLO
from repro_torch.core.simulator import Cluster, DisaggConfig, Simulator
from repro_torch.data.workload import WorkloadProfile, make_requests


def enumerate_disaggs(n_gpus: int = 8, *, multimodal: bool = True,
                      methods: Optional[list] = None) -> list[DisaggConfig]:
    out = []
    methods = methods or (["EPD", "EP+D", "ED+P", "E+P+D"] if multimodal
                          else ["PD", "P+D"])
    if "EPD" in methods:
        out.append(DisaggConfig({"EPD": n_gpus}))
    if "PD" in methods:
        out.append(DisaggConfig({"PD": n_gpus}))
    if "EP+D" in methods:
        out += [DisaggConfig({"EP": k, "D": n_gpus - k})
                for k in range(1, n_gpus)]
    if "ED+P" in methods:
        out += [DisaggConfig({"ED": k, "P": n_gpus - k})
                for k in range(1, n_gpus)]
    if "P+D" in methods:
        out += [DisaggConfig({"P": k, "D": n_gpus - k})
                for k in range(1, n_gpus)]
    if "E+P+D" in methods:
        for e in range(1, n_gpus - 1):
            for p in range(1, n_gpus - e):
                d = n_gpus - e - p
                if d >= 1:
                    out.append(DisaggConfig({"E": e, "P": p, "D": d}))
    return out


def simulate_once(cfg: ModelConfig, hw: Hardware, disagg: DisaggConfig,
                  profile: WorkloadProfile, slo: SLO, *, rate: float,
                  n_requests: int = 150, policy: str = "hydra",
                  image_tokens: Optional[int] = None, seed: int = 0,
                  tp: int = 1):
    image_tokens = image_tokens if image_tokens is not None else cfg.media_tokens
    reqs = make_requests(profile, rate=rate, n=n_requests,
                         image_tokens_per_image=image_tokens, slo=slo,
                         seed=seed)
    cluster = Cluster(cfg, hw, disagg, slo, policy_name=policy, tp=tp)
    sim = Simulator(cluster)
    horizon = reqs[-1].arrival + 120.0
    done = sim.run(reqs, until=horizon)
    return summarize(done, rate, reqs[-1].arrival), done, cluster


@dataclass
class SearchResult:
    disagg: DisaggConfig
    goodput: float
    details: list  # (DisaggConfig, goodput) for every candidate
    n_sims: int = 0  # simulator invocations spent by the search


def search_disaggregation(cfg: ModelConfig, hw: Hardware,
                          profile: WorkloadProfile, slo: SLO, *,
                          n_gpus: int = 8, policy: str = "hydra",
                          n_requests: int = 120,
                          candidates: Optional[list] = None,
                          image_tokens: Optional[int] = None,
                          max_rate: float = 64.0, seed: int = 0) -> SearchResult:
    """Exhaustive profile-driven search (one full bisection per candidate)."""
    multimodal = profile.p_image > 0
    cands = candidates or enumerate_disaggs(n_gpus, multimodal=multimodal)
    scored = []
    n_sims = 0
    for dc in cands:
        def attain(rate, _dc=dc):
            nonlocal n_sims
            n_sims += 1
            stats, _, _ = simulate_once(cfg, hw, _dc, profile, slo, rate=rate,
                                        n_requests=n_requests, policy=policy,
                                        image_tokens=image_tokens, seed=seed)
            return stats.attainment
        g = goodput(attain, hi=max_rate, grow_to=max_rate)
        scored.append((dc, g))
    best = max(scored, key=lambda x: x[1])
    return SearchResult(disagg=best[0], goodput=best[1], details=scored,
                        n_sims=n_sims)
