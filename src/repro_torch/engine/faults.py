"""Fault model for the real-execution serving stack (DESIGN.md §15).

Disaggregated EPD serving multiplies failure domains: a single dead or
wedged instance strands every request mid-pipeline and every migrated KV
block on it.  This module holds the *leaf* pieces of the fault-tolerance
layer — it imports nothing from the engine so every other engine module
can depend on it:

  FaultPlan / FaultEvent   seeded, deterministic fault injection keyed on
                           the scheduler iteration counter: instance
                           crashes, step stalls (a wedged device), cache
                           allocation failures, and dropped / corrupted
                           E->P / P->D transfers
  TransferError            typed failure of a cache transfer (dropped,
                           corrupt-checksum, destination OOM, timeout) —
                           the migration path retries these with bounded
                           backoff before falling back to journal replay
  AdmissionError           typed rejection of a submit under deadline-aware
                           load shedding (capacity durably degraded)
  RequestJournal           the minimal per-request durable record (prompt,
                           media content-hashes, sampling seed; accepted
                           tokens live in the ServeItem) that makes a
                           stranded request re-dispatchable with bit-exact
                           greedy/seeded continuation
  payload_checksum         end-to-end checksum over a transfer payload
                           (numpy arrays, torch tensors on any device, or
                           nested dict trees), how corrupted transfers are
                           *detected*

Injection is deterministic by construction: a plan is a sorted set of
(iteration, kind, instance) events, and ``FaultPlan.random`` derives one
from a seed, so a failing fault sweep reproduces from its seed alone.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

# fault kinds
CRASH = "crash"          # instance dies: all device state lost
STALL = "stall"          # instance wedges for `arg` iterations (no progress)
ALLOC = "alloc"          # cache allocations fail for `arg` iterations
DROP = "drop"            # migration payload lost in flight
CORRUPT = "corrupt"      # migration payload corrupted in flight
KINDS = (CRASH, STALL, ALLOC, DROP, CORRUPT)


class TransferError(RuntimeError):
    """A cache transfer failed in a retryable way.  ``kind`` is one of
    "drop" | "corrupt" | "oom" | "timeout"."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


class AdmissionError(RuntimeError):
    """Submit rejected: capacity is durably degraded and the request could
    never meet its deadline (deadline-aware load shedding, DESIGN.md §15).
    Typed so fronts can map it to a proper 503 instead of queueing the
    request forever."""


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault.  ``iteration`` counts *productive* scheduler
    iterations (steps where some instance had pending work — idle spins
    between Poisson arrivals don't advance fault time, so plans stay
    meaningful under open-loop load).  ``iid`` targets one instance; -1
    matches any.  ``arg`` is the window length in iterations for
    stall/alloc, and the number of failing transfer *attempts* for
    drop/corrupt (1 = first attempt fails, the retry succeeds)."""
    iteration: int
    kind: str
    iid: int = -1
    arg: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")


@dataclass
class RequestJournal:
    """Minimal durable record for failure recovery (DESIGN.md §15): enough
    to re-dispatch a stranded request to a surviving instance and replay it
    to a bit-exact continuation.  The original prompt is kept verbatim (the
    live ServeItem.prompt is rewritten with replay context on recovery);
    media is identified by content hash so the host-side copy can be
    integrity-checked before re-encoding; the resolved sampling seed plus
    the accepted-token count pin the per-lane PRNG stream."""
    prompt: np.ndarray          # original prompt token ids (copy)
    media_hashes: tuple = ()    # per-image blake2b content hashes
    seed: int = 0               # resolved sampling seed


class FaultPlan:
    """A deterministic schedule of injected faults, queried by the server
    each scheduler iteration.  Build one explicitly from events, randomly
    from a seed (``FaultPlan.random``), or from a CLI spec string
    (``FaultPlan.parse``)."""

    def __init__(self, events=()):
        self.events = tuple(sorted(events, key=lambda e: (e.iteration,
                                                          e.kind, e.iid)))
        self._crashed: set = set()   # one-shot crash events already fired

    def __repr__(self):
        return f"FaultPlan({list(self.events)!r})"

    def __bool__(self):
        return bool(self.events)

    # ------------------------------------------------------------------
    def _match(self, ev: FaultEvent, iid: int) -> bool:
        return ev.iid < 0 or ev.iid == iid

    def crash(self, iteration: int, iid: int) -> bool:
        """True exactly once per crash event, at (or after — an instance
        that was idle at the chosen iteration still dies) its iteration."""
        for i, ev in enumerate(self.events):
            if ev.kind == CRASH and self._match(ev, iid) \
                    and iteration >= ev.iteration and i not in self._crashed:
                self._crashed.add(i)
                return True
        return False

    def _in_window(self, kind: str, iteration: int, iid: int) -> bool:
        return any(ev.kind == kind and self._match(ev, iid)
                   and ev.iteration <= iteration < ev.iteration + max(ev.arg, 1)
                   for ev in self.events)

    def stalled(self, iteration: int, iid: int) -> bool:
        """Instance ``iid`` is wedged this iteration (builds batches but
        executes nothing — the no-progress failure mode)."""
        return self._in_window(STALL, iteration, iid)

    def alloc_fail(self, iteration: int, iid: int) -> bool:
        """Cache allocations on ``iid`` fail this iteration."""
        return self._in_window(ALLOC, iteration, iid)

    def transfer_fault(self, iteration: int, attempt: int) -> Optional[str]:
        """Fault applied to a migration attempted this iteration, or None.
        ``attempt`` indexes retries: an event only affects attempts below
        its ``arg``, so ``arg=1`` exercises retry-and-succeed while a large
        ``arg`` exhausts the retry budget and forces journal replay."""
        for ev in self.events:
            if ev.kind in (DROP, CORRUPT) and ev.iteration <= iteration \
                    and attempt < ev.arg:
                # windows are open-ended on attempts, not iterations: a
                # migration deferred past the chosen iteration still hits
                if iteration < ev.iteration + 1:
                    return ev.kind
        return None

    # ------------------------------------------------------------------
    @classmethod
    def random(cls, seed: int, *, horizon: int, iids,
               p_crash: float = 0.0, p_stall: float = 0.02,
               p_alloc: float = 0.02, p_transfer: float = 0.02,
               max_crashes: int = 0, stall_len: int = 3) -> "FaultPlan":
        """Derive a plan from a seed: per (iteration, instance) Bernoulli
        draws for stalls/allocation failures/transfer faults, plus up to
        ``max_crashes`` crashes at uniform iterations (never more than
        len(iids) - 1, so at least one instance survives)."""
        rng = np.random.default_rng(seed)
        iids = list(iids)
        events = []
        n_crash = min(int(max_crashes), max(len(iids) - 1, 0))
        if n_crash and p_crash > 0:
            victims = rng.choice(len(iids), size=n_crash, replace=False)
            for v in victims:
                if rng.random() < p_crash:
                    events.append(FaultEvent(
                        int(rng.integers(1, max(horizon, 2))), CRASH,
                        iid=iids[int(v)]))
        for it in range(1, horizon + 1):
            for iid in iids:
                if rng.random() < p_stall:
                    events.append(FaultEvent(it, STALL, iid=iid,
                                             arg=int(rng.integers(
                                                 1, stall_len + 1))))
                if rng.random() < p_alloc:
                    events.append(FaultEvent(it, ALLOC, iid=iid))
            if rng.random() < p_transfer:
                events.append(FaultEvent(
                    it, DROP if rng.random() < 0.5 else CORRUPT))
        return cls(events)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """CLI knob: comma-separated ``kind@iteration[:iid][+arg]`` parts,
        e.g. ``crash@100:1,stall@40:0+5,drop@60,alloc@80:2``."""
        events = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            m = re.fullmatch(
                r"(\w+)@(\d+)(?::(-?\d+))?(?:\+(\d+))?", part)
            if not m:
                raise ValueError(
                    f"bad fault spec {part!r} "
                    f"(expected kind@iteration[:iid][+arg])")
            events.append(FaultEvent(int(m.group(2)), m.group(1),
                                     iid=int(m.group(3) or -1),
                                     arg=int(m.group(4) or 1)))
        return cls(events)


# ---------------------------------------------------------------------------
# transfer checksums (corruption *detection*; injection lives in the plan)
# ---------------------------------------------------------------------------
def _tensor_bytes(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor's bits (bf16 as its int16 bit patterns: numpy
    has no bf16)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _walk_arrays(payload, visit):
    """Deterministic traversal of a transfer payload: arrays and tensors
    directly, dict trees in sorted key order, scalars by repr."""
    if isinstance(payload, dict):
        for k in sorted(payload, key=str):
            visit(str(k).encode())
            _walk_arrays(payload[k], visit)
    elif isinstance(payload, torch.Tensor):
        visit(str((tuple(payload.shape), str(payload.dtype))).encode())
        visit(_tensor_bytes(payload).tobytes())
    elif hasattr(payload, "shape"):
        a = np.ascontiguousarray(np.asarray(payload))
        visit(str((a.shape, a.dtype.str)).encode())
        visit(a.tobytes())
    else:
        visit(repr(payload).encode())


def payload_checksum(payload) -> bytes:
    """End-to-end checksum of one store's transfer payload."""
    h = hashlib.blake2b(digest_size=16)
    _walk_arrays(payload, h.update)
    return h.digest()


def corrupt_payload(payload):
    """Return a bit-flipped copy of ``payload`` (the simulated wire
    corruption a checksum must catch).  Dict trees corrupt their first
    array leaf; empty payloads come back unchanged.  A tensor's copy stays
    on its device."""
    if isinstance(payload, dict):
        for k in sorted(payload, key=str):
            flipped = corrupt_payload(payload[k])
            if flipped is not payload[k]:
                out = dict(payload)
                out[k] = flipped
                return out
        return payload
    if isinstance(payload, torch.Tensor):
        t = payload.detach().clone().contiguous()
        if t.numel():
            t.view(-1).view(torch.uint8)[0] ^= 0xFF
            return t
        return payload
    if hasattr(payload, "shape"):
        a = np.array(np.asarray(payload), copy=True)
        if a.size:
            flat = a.view(np.uint8).reshape(-1)
            flat[0] ^= 0xFF
            return a
    return payload
