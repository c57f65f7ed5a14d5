"""Disaggregation descriptions shared by the engine and the simulator.

Only the pieces the real-execution server needs: the instance role sets,
``RoleSpec`` and ``DisaggConfig``.  The discrete-event simulator itself
(``Instance``, ``Cluster``, ``Simulator``) and the autotuner built on it
have not been ported yet (ROADMAP, queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.costmodel import Hardware
from repro_torch.core.request import Stage

ROLE_SETS = {
    "E": frozenset({Stage.ENCODE}),
    "P": frozenset({Stage.PREFILL}),
    "D": frozenset({Stage.DECODE}),
    "EP": frozenset({Stage.ENCODE, Stage.PREFILL}),
    "ED": frozenset({Stage.ENCODE, Stage.DECODE}),
    "PD": frozenset({Stage.PREFILL, Stage.DECODE}),
    "EPD": frozenset({Stage.ENCODE, Stage.PREFILL, Stage.DECODE}),
}


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
