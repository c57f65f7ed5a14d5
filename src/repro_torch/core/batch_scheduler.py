"""Stage-level batching — paper Algorithm 1, DESIGN.md §5 — plus the
baseline scheduling policies it is evaluated against (Figs 7, 10, 14).

Policies:
  hydra          : Algorithm 1 — all ongoing decodes, then chunked prefill
                   within the token budget, else encode within the image
                   budget; migrate tasks always ride along.  Encode runs in
                   a parallel stream (fused joint step on TPU).
  prefill_first  : vLLM-v0-style FCFS — whole encode+prefill of new requests
                   preempts decoding (generation stall).
  decode_first   : vLLM-v1-style — decodes always run; new requests join
                   with their full (unchunked) encode+prefill in the same
                   batch.
  sarathi        : chunked prefill with a token budget, but encode is NOT a
                   separate stage: the iteration whose chunk covers the
                   image region triggers the full image encode inline
                   (sequential stream) — the paper's Takeaway-3 suboptimality.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.budgets import Budgets
from repro_torch.core.request import Request, Stage


@dataclass
class Batch:
    decode: list = field(default_factory=list)            # [Request]
    prefill: list = field(default_factory=list)           # [(Request, chunk)]
    encode: list = field(default_factory=list)            # [(Request, n_images)]
    inline_encode: bool = False                            # sarathi-style stall

    @property
    def empty(self) -> bool:
        return not (self.decode or self.prefill or self.encode)


def _ready(r: Request, now: float) -> bool:
    return r.ready_at <= now + 1e-12


class Policy:
    name = "base"
    parallel_streams = True

    def build(self, inst, now: float) -> Batch:
        raise NotImplementedError


class HydraPolicy(Policy):
    """Paper Algorithm 1."""
    name = "hydra"
    parallel_streams = True

    def build(self, inst, now: float) -> Batch:
        b = Batch()
        tau_t = inst.budgets.token_budget
        tau_e = inst.budgets.image_budget
        n_t = 0
        n_e = 0
        has_prefill = False

        # 1. all ongoing decodes (admitting migrated-in decode requests
        #    first: admission triggers the pull-based cache transfer)
        if Stage.DECODE in inst.role:
            while inst.pop_waiting(Stage.DECODE, now) is not None:
                pass
            for r in inst.running:
                if r.stage == Stage.DECODE and _ready(r, now):
                    b.decode.append(r)
                    n_t += 1

        # 2. ongoing chunked prefills within the token budget
        if Stage.PREFILL in inst.role:
            for r in inst.running:
                if r.stage == Stage.PREFILL and _ready(r, now) and n_t < tau_t:
                    chunk = min(r.prefill_remaining, tau_t - n_t)
                    if chunk > 0:
                        b.prefill.append((r, chunk))
                        n_t += chunk
                        has_prefill = True
            # 3. admit new prefill-ready requests within the budget
            while n_t < tau_t:
                r = inst.pop_waiting(Stage.PREFILL, now)
                if r is None:
                    break
                if not _ready(r, now):
                    continue  # pull still in flight; it is in running now
                chunk = min(r.prefill_remaining, tau_t - n_t)
                b.prefill.append((r, chunk))
                n_t += chunk
                has_prefill = True

        # 4. encode only when no prefill work was scheduled
        if Stage.ENCODE in inst.role and not has_prefill:
            for r in inst.running:
                if r.stage == Stage.ENCODE and _ready(r, now) and n_e < tau_e:
                    b.encode.append((r, r.n_images))
                    n_e += r.n_images
            while n_e < tau_e:
                r = inst.pop_waiting(Stage.ENCODE, now)
                if r is None:
                    break
                if not _ready(r, now):
                    continue
                b.encode.append((r, r.n_images))
                n_e += r.n_images
        return b


class PrefillFirstPolicy(Policy):
    """vLLM-v0 style: FCFS, whole prefill (+ inline encode) first."""
    name = "prefill_first"
    parallel_streams = False

    def build(self, inst, now: float) -> Batch:
        b = Batch()
        # any request needing encode/prefill preempts decoding entirely
        new_work = [r for r in inst.running
                    if r.stage in (Stage.ENCODE, Stage.PREFILL) and _ready(r, now)]
        while True:
            r = inst.pop_waiting(None, now)
            if r is None:
                break
            if _ready(r, now):
                new_work.append(r)
        if new_work:
            for r in new_work[:64]:
                if r.stage == Stage.ENCODE:
                    b.encode.append((r, r.n_images))
                    b.inline_encode = True
                    # encode+full prefill execute back-to-back this iteration
                    b.prefill.append((r, r.prefill_total))
                else:
                    b.prefill.append((r, r.prefill_remaining))
            return b
        for r in inst.running:
            if r.stage == Stage.DECODE and _ready(r, now):
                b.decode.append(r)
        return b


class DecodeFirstPolicy(Policy):
    """vLLM-v1 style: decodes always run; new requests join with unchunked
    encode+prefill in the same batch."""
    name = "decode_first"
    parallel_streams = False

    def build(self, inst, now: float) -> Batch:
        b = Batch()
        for r in inst.running:
            if r.stage == Stage.DECODE and _ready(r, now):
                b.decode.append(r)
        admitted = 0
        for r in list(inst.running):
            if admitted >= 4:
                break
            if r.stage in (Stage.ENCODE, Stage.PREFILL) and _ready(r, now):
                if r.stage == Stage.ENCODE:
                    b.encode.append((r, r.n_images))
                    b.inline_encode = True
                    b.prefill.append((r, r.prefill_total))
                else:
                    b.prefill.append((r, r.prefill_remaining))
                admitted += 1
        while admitted < 4:
            r = inst.pop_waiting(None, now)
            if r is None:
                break
            if not _ready(r, now):
                continue
            if r.stage == Stage.ENCODE:
                b.encode.append((r, r.n_images))
                b.inline_encode = True
                b.prefill.append((r, r.prefill_total))
            else:
                b.prefill.append((r, r.prefill_remaining))
            admitted += 1
        return b


class SarathiPolicy(Policy):
    """Chunked prefill + stall-free decode mixing, but encode inline: the
    chunk that reaches the image region triggers the full encode within the
    same (sequential-stream) iteration."""
    name = "sarathi"
    parallel_streams = False

    def build(self, inst, now: float) -> Batch:
        b = Batch()
        tau_t = inst.budgets.token_budget
        n_t = 0
        for r in inst.running:
            if r.stage == Stage.DECODE and _ready(r, now):
                b.decode.append(r)
                n_t += 1

        def add_prefill(r):
            nonlocal n_t
            # encode not yet done and the chunk covers the image region ->
            # the full image encode happens inline this iteration
            if r.stage == Stage.ENCODE:
                b.encode.append((r, r.n_images))
                b.inline_encode = True
                r_chunk = min(r.prefill_remaining, max(tau_t - n_t, 16))
                b.prefill.append((r, r_chunk))
                n_t += r_chunk
            else:
                chunk = min(r.prefill_remaining, tau_t - n_t)
                if chunk > 0:
                    b.prefill.append((r, chunk))
                    n_t += chunk

        for r in inst.running:
            if r.stage in (Stage.PREFILL, Stage.ENCODE) and _ready(r, now) \
                    and n_t < tau_t:
                add_prefill(r)
        while n_t < tau_t:
            r = inst.pop_waiting(None, now)
            if r is None:
                break
            if _ready(r, now):
                add_prefill(r)
        return b


POLICIES = {p.name: p for p in (HydraPolicy(), PrefillFirstPolicy(),
                                DecodeFirstPolicy(), SarathiPolicy())}
