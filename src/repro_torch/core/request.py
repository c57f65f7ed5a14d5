"""Request / stage lifecycle model (paper §4.1 Request Processor,
DESIGN.md §1.2; SLO accounting: DESIGN.md §8).

A request is decomposed into a sequence of stage *tasks* — encode, prefill,
decode (+ migrate between instances) — ahead of time, with control
parameters (token counts, cache footprints) precomputed so schedulers only
do queue work on the hot path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class Stage(str, Enum):
    ENCODE = "encode"
    PREFILL = "prefill"
    DECODE = "decode"
    MIGRATE = "migrate"
    DONE = "done"


@dataclass(frozen=True)
class SLO:
    ttft: float   # seconds
    tpot: float   # seconds


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls (DESIGN.md §13).

    ``temperature <= 0`` selects greedy decoding (bit-exact argmax — the
    pre-streaming engine behavior).  ``top_k <= 0`` / ``top_p >= 1``
    disable the respective filters.  ``stop`` holds token ids: sampling
    one of them ends the request with ``finish_reason="stop"`` and the
    stop token is not included in the output.  ``seed=None`` derives a
    per-request seed from the rid at submit, so replays are deterministic
    regardless of how requests are batched together.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop: tuple = ()
    max_tokens: int = 16


@dataclass(frozen=True)
class StreamEvent:
    """One element of a request's output stream (engine API, DESIGN.md §13).

    kind: "first_token" | "token" | "finish".  Token events carry the
    sampled token id; the finish event carries the reason
    ("length" | "stop" | "abort" | "error" — "error" means the request was
    shed by the fault-tolerance layer, DESIGN.md §15).
    """
    rid: int
    kind: str
    t: float
    token: Optional[int] = None
    finish_reason: Optional[str] = None


@dataclass
class Request:
    rid: int
    arrival: float
    n_images: int
    image_tokens: int            # total media tokens (all images)
    prompt_tokens: int
    max_new_tokens: int
    slo: SLO
    # vision media joins the LM sequence (LLaVA-style); audio frames feed
    # cross-attention instead and never enter the prefill stream
    media_in_lm: bool = True
    # sampling controls; None means greedy (simulator requests never sample)
    sampling: Optional[SamplingParams] = None

    # --- lifecycle state ---
    stage: Stage = Stage.ENCODE
    prefill_done: int = 0        # prompt+image tokens already prefilled
    tokens_out: int = 0
    ready_at: float = 0.0        # not schedulable before this (migration pull)

    # --- cache-hit metadata (DESIGN.md §14) ---
    # tokens adopted from the shared prefix index: counted into
    # prefill_done at admission, so schedulers/reservations only see the
    # miss suffix; kept separately for hit-rate accounting
    prefix_cached_tokens: int = 0
    # encode stage skipped via the image-embedding cache (the cached
    # embeddings install lazily at the first prefill batch)
    encode_cached: bool = False

    # --- failure recovery (DESIGN.md §15) ---
    # output tokens already emitted before a failure forced a replay: the
    # re-prefill context ends at the last emitted token, so completing it
    # fast-forwards ``tokens_out`` here instead of re-emitting a first token
    replayed_tokens: int = 0
    n_recoveries: int = 0        # replays survived (bounded by the server)

    # --- measurements ---
    first_token_time: Optional[float] = None
    token_times: list = field(default_factory=list)
    stage_log: list = field(default_factory=list)  # (stage, t_start, t_end)
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None  # "length"|"stop"|"abort"|"error"

    def __post_init__(self):
        self.stage = Stage.ENCODE if self.n_images > 0 else Stage.PREFILL
        self.ready_at = self.arrival

    # ------------------------------------------------------------------
    @property
    def prefill_total(self) -> int:
        """LM prefill length: vision tokens enter the LM alongside text."""
        return (self.image_tokens if self.media_in_lm else 0) + self.prompt_tokens

    @property
    def context_len(self) -> int:
        return self.prefill_total + self.tokens_out

    @property
    def prefill_remaining(self) -> int:
        return self.prefill_total - self.prefill_done

    @property
    def done(self) -> bool:
        return self.stage == Stage.DONE

    # ------------------------------------------------------------------
    def advance_after_encode(self):
        self.stage = Stage.PREFILL

    def advance_after_prefill_chunk(self, chunk: int, now: float):
        self.prefill_done += chunk
        if self.prefill_done >= self.prefill_total:
            if self.replayed_tokens > 0:
                # recovery replay (DESIGN.md §15): the first
                # ``replayed_tokens`` outputs were already emitted before
                # the failure and the re-prefilled context ends at the last
                # of them — fast-forward the counter and resume decode; no
                # re-emission, no first-token restamp (TTFT is history)
                self.tokens_out = self.replayed_tokens
                self.replayed_tokens = 0
                if self.tokens_out < self.max_new_tokens:
                    self.stage = Stage.DECODE
                else:
                    self.finish("length", now)
                return
            # prefill produces the first token
            self.tokens_out = 1
            self.first_token_time = now
            self.token_times.append(now)
            if self.tokens_out < self.max_new_tokens:
                self.stage = Stage.DECODE
            else:
                self.finish("length", now)

    def advance_after_decode_step(self, now: float):
        self.tokens_out += 1
        self.token_times.append(now)
        if self.tokens_out >= self.max_new_tokens:
            self.finish("length", now)

    def finish(self, reason: str, now: float):
        self.stage = Stage.DONE
        self.finish_reason = reason
        self.finish_time = now

    # ------------------------------------------------------------------
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def tpots(self) -> list:
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    def meets_slo(self) -> bool:
        """Paper §2.3: TTFT <= SLO and 90% of TPOT values <= TPOT SLO."""
        t = self.ttft()
        if t is None or t > self.slo.ttft:
            return False
        tp = self.tpots()
        if not tp:
            return True
        within = sum(1 for x in tp if x <= self.slo.tpot)
        return within >= 0.9 * len(tp)
