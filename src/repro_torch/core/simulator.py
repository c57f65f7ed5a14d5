"""Discrete-event cluster simulator.

Runs the *same* scheduling code (Algorithm 1 / baseline policies) as the
real engine, with batch execution times supplied by the analytical cost
model (paper Table 2 + roofline) for a chosen hardware profile.  This is
how the paper-scale experiments (8xH800, 7B MLLMs, Poisson arrivals) run
inside a CPU-only container — see DESIGN.md §3.

Migration is pull-based (paper §4.3, DESIGN.md §4): the target instance
admits a request only when it has cache space, then pulls the KV/image
cache; the request becomes schedulable at ``now + migration_time``.

Clusters may be heterogeneous (DESIGN.md §7.2): each role group of a
``DisaggConfig`` can carry its own ``Hardware`` profile and TP degree via
``RoleSpec``, and budgets/cost-model times resolve per instance.

A host-side copy of the JAX package's simulator: the port's real-execution
server takes its role sets, ``RoleSpec`` and ``DisaggConfig`` from here,
and ``repro_torch.launch.serve --sim`` and ``core.hybrid_epd`` /
``core.autotuner`` run the simulator itself.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.batch_scheduler import POLICIES, Batch, Policy
from repro_torch.core.budgets import Budgets, compute_budgets
from repro_torch.core.costmodel import BatchWork, Hardware
from repro_torch.core.request import Request, Stage

ROLE_SETS = {
    "E": frozenset({Stage.ENCODE}),
    "P": frozenset({Stage.PREFILL}),
    "D": frozenset({Stage.DECODE}),
    "EP": frozenset({Stage.ENCODE, Stage.PREFILL}),
    "ED": frozenset({Stage.ENCODE, Stage.DECODE}),
    "PD": frozenset({Stage.PREFILL, Stage.DECODE}),
    "EPD": frozenset({Stage.ENCODE, Stage.PREFILL, Stage.DECODE}),
}


class Instance:
    def __init__(self, iid: int, role_name: str, cfg: ModelConfig,
                 hw: Hardware, budgets: Budgets, policy: Policy, *,
                 tp: int = 1, kv_capacity_tokens: Optional[int] = None,
                 image_capacity_tokens: Optional[int] = None):
        self.iid = iid
        self.role_name = role_name
        self.role = ROLE_SETS[role_name]
        self.cfg = cfg
        self.hw = hw
        self.budgets = budgets
        self.policy = policy
        self.tp = tp
        self.running: list[Request] = []
        self.waiting: deque = deque()   # (Request, pull_bytes)
        self.busy = False
        self.total_busy_time = 0.0
        self.iters = 0

        if kv_capacity_tokens is None:
            weight_bytes = cm.active_param_count(cfg) * cm.BYTES  # rough
            per_tok = max(cm.kv_bytes_per_token(cfg), 1)
            free = max(hw.mem_bytes * tp * 0.9 - weight_bytes, per_tok * 4096)
            kv_capacity_tokens = int(free / per_tok)
        self.kv_capacity_tokens = kv_capacity_tokens
        if image_capacity_tokens is None:
            image_capacity_tokens = int(hw.mem_bytes * 0.2 /
                                        max(cfg.d_model * cm.BYTES, 1))
        self.image_capacity_tokens = image_capacity_tokens

    # ------------------------------------------------------------------
    def kv_used(self) -> int:
        return sum(r.context_len for r in self.running
                   if r.stage in (Stage.PREFILL, Stage.DECODE))

    def img_used(self) -> int:
        return sum(r.image_tokens for r in self.running)

    def has_capacity(self, r: Request) -> bool:
        if r.stage in (Stage.PREFILL, Stage.DECODE):
            need = r.prefill_total + r.max_new_tokens
            if self.kv_used() + need > self.kv_capacity_tokens:
                return False
        if r.stage == Stage.ENCODE:
            if self.img_used() + r.image_tokens > self.image_capacity_tokens:
                return False
        return True

    def enqueue(self, r: Request, pull_bytes: float = 0.0):
        self.waiting.append((r, pull_bytes))

    def pop_waiting(self, stage: Optional[Stage], now: float):
        """Admit the next waiting request (FCFS within stage filter).

        Pull-based migration: admission starts the cache pull; the request
        joins ``running`` but is not schedulable until ``ready_at``.
        Returns the request if it is immediately schedulable, else None-loops
        by design (callers skip non-ready ones).
        """
        for i, (r, pull_bytes) in enumerate(self.waiting):
            if stage is not None and r.stage != stage:
                continue
            if not self.has_capacity(r):
                continue
            del self.waiting[i]
            if pull_bytes > 0:
                t_mig = cm.migration_time(self.hw, pull_bytes)
                r.ready_at = now + t_mig
                r.stage_log.append(("migrate", now, now + t_mig))
            self.running.append(r)
            return r
        return None

    def remove(self, r: Request):
        if r in self.running:
            self.running.remove(r)


@dataclass(frozen=True)
class RoleSpec:
    """One role group of a disaggregation: instance count plus optional
    per-role hardware/TP overrides (heterogeneous clusters, DESIGN.md §7.2).

    ``hw=None`` / ``tp=None`` inherit the cluster-wide defaults, so a plain
    ``DisaggConfig({"EP": 2, "D": 6})`` behaves exactly as before.
    """
    count: int
    hw: Optional[Hardware] = None
    tp: Optional[int] = None


@dataclass
class DisaggConfig:
    """A disaggregation method: mapping role -> instance count or RoleSpec.

    Values may be plain ints (homogeneous: every instance uses the cluster
    default ``Hardware``/TP) or :class:`RoleSpec` (heterogeneous: e.g.
    encode on memory-light chips, decode on bandwidth-heavy ones).
    """
    counts: dict

    def spec(self, role: str) -> RoleSpec:
        v = self.counts[role]
        return v if isinstance(v, RoleSpec) else RoleSpec(count=v)

    @property
    def roles(self) -> list:
        """[(role_name, RoleSpec)] for every non-empty role group."""
        return [(r, self.spec(r)) for r in self.counts if self.spec(r).count]

    @property
    def heterogeneous(self) -> bool:
        return any(s.hw is not None or s.tp is not None
                   for _, s in self.roles)

    @property
    def total_instances(self) -> int:
        return sum(s.count for _, s in self.roles)

    @property
    def name(self) -> str:
        parts = []
        for role, s in self.roles:
            p = f"{s.count}{role}"
            if s.hw is not None:
                p += f"@{s.hw.name}"
            if s.tp is not None and s.tp != 1:
                p += f"tp{s.tp}"
            parts.append(p)
        return "+".join(parts)

    @property
    def method(self) -> str:
        roles = sorted(r for r, _ in self.roles)
        return "+".join(roles)


class Cluster:
    def __init__(self, cfg: ModelConfig, hw: Hardware, disagg: DisaggConfig,
                 slo, *, policy_name: str = "hydra", tp: int = 1,
                 ref_decode_batch: int = 64):
        self.cfg = cfg
        self.hw = hw          # default hardware for roles without an override
        self.disagg = disagg
        self.policy = POLICIES[policy_name]
        # budgets resolve per (hardware, tp) — heterogeneous role groups get
        # their own Algorithm-1 token/image budgets, not the cluster's
        budget_cache: dict = {}
        self.instances: list[Instance] = []
        iid = itertools.count()
        for role, s in disagg.roles:
            inst_hw = s.hw if s.hw is not None else hw
            inst_tp = s.tp if s.tp is not None else tp
            key = (inst_hw.name, inst_tp)
            if key not in budget_cache:
                budget_cache[key] = compute_budgets(
                    cfg, inst_hw, slo.tpot, tp=inst_tp,
                    ref_decode_batch=ref_decode_batch)
            for _ in range(s.count):
                self.instances.append(Instance(next(iid), role, cfg, inst_hw,
                                               budget_cache[key], self.policy,
                                               tp=inst_tp))
        self._rr = {s: 0 for s in Stage}

    def by_stage(self, stage: Stage) -> list:
        return [i for i in self.instances if stage in i.role]

    @staticmethod
    def _speed(inst: Instance, stage: Stage) -> float:
        """Relative service speed of an instance for a stage: decode is
        bandwidth-bound, encode/prefill compute-bound (paper §3.1)."""
        if stage == Stage.DECODE:
            return inst.hw.hbm_bw * inst.tp
        return inst.hw.peak_flops * inst.tp

    def route(self, r: Request, stage: Stage) -> Instance:
        """Load-balance: least outstanding work, normalized by instance
        speed so heterogeneous instances fill proportionally to capacity."""
        cands = self.by_stage(stage)
        if not cands:
            raise RuntimeError(f"no instance serves stage {stage}")
        return min(cands, key=lambda i: ((len(i.running) + len(i.waiting) + 1)
                                         / self._speed(i, stage)))

    def dispatch_new(self, r: Request):
        inst = self.route(r, r.stage)
        inst.enqueue(r, pull_bytes=0.0)
        return inst

    def migrate(self, r: Request, src: Instance):
        """Request finished a stage the source can't continue — move it."""
        src.remove(r)
        target = self.route(r, r.stage)
        if r.stage == Stage.PREFILL:      # E -> P: image cache moves
            pull = cm.image_cache_bytes(self.cfg, 1) * max(r.n_images, 1)
        else:                             # P -> D: KV cache moves
            pull = r.context_len * cm.kv_bytes_per_token(self.cfg)
            if pull == 0:                 # SSM: fixed-size state
                pull = cm.ssm_state_bytes(self.cfg)
        target.enqueue(r, pull_bytes=pull)
        return target


# ---------------------------------------------------------------------------
# event loop
# ---------------------------------------------------------------------------
class Simulator:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.events: list = []   # (time, seq, kind, payload)
        self._seq = itertools.count()
        self.completed: list[Request] = []

    def push(self, t, kind, payload):
        heapq.heappush(self.events, (t, next(self._seq), kind, payload))

    # ------------------------------------------------------------------
    def _batch_work(self, batch: Batch) -> BatchWork:
        w = BatchWork()
        if batch.decode:
            w.decode_batch = len(batch.decode)
            w.decode_context = int(sum(r.context_len for r in batch.decode)
                                   / len(batch.decode))
        if batch.prefill:
            w.prefill_tokens = sum(c for _, c in batch.prefill)
            w.prefill_batch = len(batch.prefill)
            w.prefill_context = int(sum(r.prefill_done + c / 2
                                        for r, c in batch.prefill)
                                    / len(batch.prefill))
        if batch.encode:
            w.encode_images = sum(n for _, n in batch.encode)
        return w

    def _start_iteration(self, inst: Instance, now: float):
        if inst.busy:
            return
        batch = inst.policy.build(inst, now)
        if batch.empty:
            return
        dt = cm.batch_time(inst.cfg, inst.hw, self._batch_work(batch),
                           parallel_streams=inst.policy.parallel_streams,
                           tp=inst.tp)
        inst.busy = True
        inst.total_busy_time += dt
        inst.iters += 1
        self.push(now + dt, "iter_done", (inst, batch, now))

    def _finish_iteration(self, inst: Instance, batch: Batch, t0: float,
                          now: float):
        inst.busy = False
        cfg = self.cluster.cfg
        for r, n in batch.encode:
            r.stage_log.append(("encode_exec", t0, now))
            if r.stage == Stage.ENCODE:
                r.advance_after_encode()
                if Stage.PREFILL not in inst.role:
                    self.cluster.migrate(r, inst)
        for r, chunk in batch.prefill:
            r.stage_log.append(("prefill_exec", t0, now))
            r.advance_after_prefill_chunk(chunk, now)
            if r.stage == Stage.DECODE and Stage.DECODE not in inst.role:
                self.cluster.migrate(r, inst)
            elif r.stage == Stage.DONE:
                inst.remove(r)
                r.finish_time = now
                self.completed.append(r)
        for r in batch.decode:
            r.stage_log.append(("decode_exec", t0, now))
            r.advance_after_decode_step(now)
            if r.stage == Stage.DONE:
                inst.remove(r)
                self.completed.append(r)
        self._wake_all(now)

    def _wake_all(self, now: float):
        for inst in self.cluster.instances:
            if not inst.busy:
                self._start_iteration(inst, now)
            if not inst.busy:
                # nothing schedulable now; wake at the next ready_at
                nxt = [r.ready_at for r in inst.running if r.ready_at > now]
                if nxt:
                    self.push(min(nxt), "wake", inst)

    # ------------------------------------------------------------------
    def run(self, requests: list, *, until: Optional[float] = None):
        for r in requests:
            self.push(r.arrival, "arrival", r)
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            if until is not None and t > until:
                break
            if kind == "arrival":
                self.cluster.dispatch_new(payload)
                self._wake_all(t)
            elif kind == "iter_done":
                inst, batch, t0 = payload
                self._finish_iteration(inst, batch, t0, t)
            elif kind == "wake":
                self._wake_all(t)
        return self.completed
