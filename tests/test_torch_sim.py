"""The port's host copies of the scheduling side (``core.metrics``,
``data.workload``, ``core.simulator``, ``core.hybrid_epd``,
``core.autotuner``) against the JAX package's on the same arguments.

Both run the same pure-Python arithmetic over identical inputs (the port's
``core.request``, ``batch_scheduler``, ``budgets`` and ``costmodel`` are the
reference's with the package renamed), so every result is held to
equality, not to a tolerance: each request's fields after a simulation
(stage, token times, stage log), the ``summarize`` numbers, the best
candidate and every candidate's goodput, bound and pruning.  The cases
mirror the sizes of tests/test_system.py and tests/test_autotuner.py.
"""
import dataclasses
import math
from enum import Enum

import pytest

from repro.configs import get_config as jget_config
from repro.core import autotuner as JA
from repro.core import costmodel as JC
from repro.core import hybrid_epd as JH
from repro.core import metrics as JMet
from repro.core import request as JR
from repro.core import simulator as JS
from repro.data import workload as JW
from repro_torch.configs import get_config as tget_config
from repro_torch.core import autotuner as TA
from repro_torch.core import costmodel as TC
from repro_torch.core import hybrid_epd as TH
from repro_torch.core import metrics as TMet
from repro_torch.core import request as TR
from repro_torch.core import simulator as TS
from repro_torch.data import workload as TW

# one namespace per package, so each case runs the same code on both
J = dict(cfg=jget_config, A=JA, C=JC, H=JH, M=JMet, R=JR, S=JS, W=JW)
T = dict(cfg=tget_config, A=TA, C=TC, H=TH, M=TMet, R=TR, S=TS, W=TW)


def norm(x):
    """A package-free view of a result: dataclasses as (class name,
    fields), enums as their values, NaN as a string (NaN != NaN)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: norm(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def disagg(P, roles):
    """A DisaggConfig of package P; roles: {role: count or (count, hw)}."""
    return P["S"].DisaggConfig({
        r: v if isinstance(v, int)
        else P["S"].RoleSpec(v[0], hw=getattr(P["C"], v[1]))
        for r, v in roles.items()})


# ---------------------------------------------------------------------------
# core.metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("xs,q", [([], 0.5), ([3.0], 0.9),
                                  ([5.0, 1.0, 4.0, 2.0, 3.0], 0.5),
                                  ([0.1 * i for i in range(37)], 0.9),
                                  ([2.0, 1.0], 0.0), ([2.0, 1.0], 1.0)])
def test_quantile_matches_jax(xs, q):
    assert norm(TMet.quantile(xs, q)) == norm(JMet.quantile(xs, q))


@pytest.mark.parametrize("knee,kw", [(10.0, {}), (0.1, {}),
                                     (1000.0, {}),
                                     (40.0, dict(hi=16.0, grow_to=48.0)),
                                     (3.3, dict(lo=1.0, hi=16.0, tol=0.5))])
def test_goodput_matches_jax(knee, kw):
    def attain(rate):
        return 1.0 if rate <= knee else 0.5
    probes = {}
    for name, P in (("jax", J), ("port", T)):
        seen = []

        def run(rate, _seen=seen):
            _seen.append(rate)
            return attain(rate)
        probes[name] = (P["M"].goodput(run, **kw), seen)
    assert probes["port"] == probes["jax"]


def _hand_requests(P):
    """Finished, unfinished and never-started requests with fixed times."""
    R = P["R"]
    slo = R.SLO(1.0, 0.05)
    out = []
    for i in range(7):
        r = R.Request(rid=i, arrival=0.1 * i, n_images=i % 2,
                      image_tokens=576 * (i % 2), prompt_tokens=16 + i,
                      max_new_tokens=5, slo=slo)
        if i < 6:
            r.first_token_time = r.arrival + 0.3 * (i + 1)
            r.token_times = [r.first_token_time + 0.04 * k * (1 + i % 3)
                             for k in range(5)]
            r.tokens_out = 5
        if i < 5:
            r.finish("length", r.token_times[-1])
        out.append(r)
    return out


@pytest.mark.parametrize("rate,horizon", [(4.0, 2.0), (8.0, 0.0)])
def test_summarize_and_attainment_match_jax(rate, horizon):
    got = TMet.summarize(_hand_requests(T), rate, horizon)
    want = JMet.summarize(_hand_requests(J), rate, horizon)
    assert norm(got) == norm(want)
    assert TMet.slo_attainment(_hand_requests(T)) == \
        JMet.slo_attainment(_hand_requests(J))


# ---------------------------------------------------------------------------
# data.workload
# ---------------------------------------------------------------------------
def test_workload_tables_match_jax():
    assert norm(TW.PROFILES) == norm(JW.PROFILES)
    assert TW.IMAGE_TOKENS == JW.IMAGE_TOKENS
    assert norm(TW.PAPER_SLOS) == norm(JW.PAPER_SLOS)
    for key in list(JW.PAPER_SLOS) + [("llama3-8b", "text")]:
        assert norm(TW.slo_for(*key)) == norm(JW.slo_for(*key))


@pytest.mark.parametrize("profile,rate,n,img,seed", [
    ("textcaps", 16.0, 120, 2880, 0), ("pope", 48.0, 60, 576, 3),
    ("text", 4.0, 50, 0, 7)])
def test_make_requests_matches_jax(profile, rate, n, img, seed):
    def build(P):
        slo = P["W"].slo_for("llava-next-7b", profile)
        return P["W"].make_requests(P["W"].PROFILES[profile], rate=rate,
                                    n=n, image_tokens_per_image=img,
                                    slo=slo, seed=seed)
    assert norm(build(T)) == norm(build(J))


@pytest.mark.parametrize("kind,kw", [
    ("multiturn", dict(n_convs=5, turns=4, rate=8.0, p_image=0.6,
                       seed=2)),
    ("multiturn", dict(n_convs=3, turns=2, rate=2.0)),
    ("repeated_image", dict(n=40, rate=12.0, image_pool=3, seed=5)),
    ("repeated_image", dict(n=10, rate=1.0, zipf_a=2.5))])
def test_traces_and_their_requests_match_jax(kind, kw):
    def build(P):
        items = getattr(P["W"], f"{kind}_trace")(**kw)
        reqs = P["W"].trace_requests(items, image_tokens_per_image=576,
                                     slo=P["R"].SLO(0.25, 0.04))
        return items, reqs
    assert norm(build(T)) == norm(build(J))


# ---------------------------------------------------------------------------
# core.simulator (the sizes of tests/test_system.py)
# ---------------------------------------------------------------------------
def _simulate(P, policy, rate, roles, n, *, model="llava-next-7b",
              ds="textcaps", hw="H800"):
    cfg = P["cfg"](model)
    slo = P["W"].slo_for(model, ds)
    reqs = P["W"].make_requests(P["W"].PROFILES[ds], rate=rate, n=n,
                                image_tokens_per_image=P["W"].IMAGE_TOKENS
                                [model], slo=slo, seed=0)
    cl = P["S"].Cluster(cfg, getattr(P["C"], hw), disagg(P, roles), slo,
                        policy_name=policy)
    done = P["S"].Simulator(cl).run(reqs, until=reqs[-1].arrival + 150)
    stats = P["M"].summarize(done, rate, reqs[-1].arrival)
    insts = [(i.role_name, i.iters, i.total_busy_time) for i in cl.instances]
    return done, stats, insts


@pytest.mark.parametrize("policy,rate,roles,n", [
    ("hydra", 48.0, {"EPD": 8}, 120),
    ("prefill_first", 48.0, {"EPD": 8}, 120),
    ("hydra", 16.0, {"E": 1, "P": 3, "D": 4}, 120),
    ("hydra", 24.0, {"EP": 1, "D": 7}, 120),
    ("hydra", 24.0, {"EP": 4, "D": 4}, 120),
    ("hydra", 24.0, {"EP": 7, "D": 1}, 120),
    ("hydra", 8.0, {"E": (1, "L40S"), "P": 3, "D": 4}, 60),
    ("hydra", 8.0, {"EP": (2, "H800"), "D": (2, "L40S")}, 40)])
def test_simulator_matches_jax(policy, rate, roles, n):
    """Every request's fields (token times, stage log, finish) and the
    summary, and every instance's iterations and busy time."""
    got, want = (_simulate(P, policy, rate, roles, n) for P in (T, J))
    assert len(got[0]) == n
    assert norm(got) == norm(want)


@pytest.mark.parametrize("policy", ["prefill_first", "hydra"])
def test_generation_stall_case_matches_jax(policy):
    """test_system.py's stall mix: two text decodes, then three 2880-token
    images arriving at 0.2 s, on one EPD instance."""
    def run(P):
        slo = P["R"].SLO(8.0, 0.08)
        reqs = [P["R"].Request(rid=i, arrival=0.0, n_images=0,
                               image_tokens=0, prompt_tokens=64,
                               max_new_tokens=100, slo=slo)
                for i in range(2)]
        reqs += [P["R"].Request(rid=rid, arrival=0.2, n_images=1,
                                image_tokens=2880, prompt_tokens=64,
                                max_new_tokens=16, slo=slo)
                 for rid in (2, 3, 4)]
        cl = P["S"].Cluster(P["cfg"]("llava-next-7b"), P["C"].H800,
                            P["S"].DisaggConfig({"EPD": 1}), slo,
                            policy_name=policy)
        return P["S"].Simulator(cl).run(reqs, until=600)
    assert norm(run(T)) == norm(run(J))


# ---------------------------------------------------------------------------
# core.hybrid_epd and core.autotuner (the sizes of tests/test_autotuner.py)
# ---------------------------------------------------------------------------
def _search_args(P, model="llava-1.5-7b", ds="textcaps"):
    return (P["cfg"](model), P["C"].H800, P["W"].PROFILES[ds],
            P["W"].slo_for(model, ds))


def _candidates(P, case):
    if case == "grid3":
        return P["H"].enumerate_disaggs(3)
    if case == "grid4":
        return P["H"].enumerate_disaggs(4)
    return P["A"].enumerate_hetero_disaggs([(P["C"].H800, 2),
                                            (P["C"].L40S, 2)],
                                           methods=["EP+D", "ED+P"])


def test_enumerations_match_jax():
    for n in (3, 4, 8):
        for mm in (True, False):
            assert norm(TH.enumerate_disaggs(n, multimodal=mm)) == \
                norm(JH.enumerate_disaggs(n, multimodal=mm))
    assert norm(_candidates(T, "hetero")) == norm(_candidates(J, "hetero"))
    pools = [(TC.H800, 2), (TC.L40S, 2)], [(JC.H800, 2), (JC.L40S, 2)]
    assert norm(TA.enumerate_hetero_disaggs(pools[0])) == \
        norm(JA.enumerate_hetero_disaggs(pools[1]))


@pytest.mark.parametrize("case,n_requests,max_rate", [
    ("grid3", 200, 384.0),          # test_autotuner's exhaustive argmax
    ("grid4", 60, 48.0),
    ("hetero", 60, 48.0)])          # test_autotuner's heterogeneous pools
def test_searches_match_jax(case, n_requests, max_rate):
    """The exhaustive search and the autotuner: the same best candidate,
    goodput and simulations, and every candidate's goodput (and the
    autotuner's bound and pruning)."""
    kw = dict(image_tokens=576, n_requests=n_requests, max_rate=max_rate)

    def run(P):
        ex = P["H"].search_disaggregation(
            *_search_args(P), candidates=_candidates(P, case), **kw)
        au = P["A"].autotune_disaggregation(
            *_search_args(P), candidates=_candidates(P, case), **kw)
        stats = P["A"].workload_stats(P["W"].PROFILES["textcaps"], 576)
        bounds = [P["A"].upper_bound_goodput(
            *_search_args(P)[:2], dc, stats, _search_args(P)[3],
            n_requests=n_requests) for dc, _ in ex.details]
        au = dataclasses.replace(au, wall_s=0.0)
        return norm(ex), norm(au), bounds
    assert run(T) == run(J)


def test_simulate_once_hetero_matches_jax():
    def run(P):
        roles = {"EP": (2, "H800"), "D": (2, "L40S")}
        stats, done, cl = P["H"].simulate_once(
            *_search_args(P)[:2], disagg(P, roles), *_search_args(P)[2:],
            rate=8.0, n_requests=40, image_tokens=576, seed=0)
        return stats, done, [(i.hw.name, i.iters) for i in cl.instances]
    assert norm(run(T)) == norm(run(J))
