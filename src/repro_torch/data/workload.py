"""Multimodal serving workloads: dataset profiles + Poisson arrivals.

The five paper datasets (TextCaps, POPE, MME, TextVQA, VizWiz) are modeled
by their per-request token statistics (approximating paper Fig 9 — the
datasets themselves carry no timestamps, so the paper likewise samples
request bodies and synthesizes Poisson arrivals).  Image-token counts per
image depend on the model (LLaVA-1.5: 576; LLaVA-NeXT: ~2880 tiles;
Qwen2-VL: resolution-adaptive ~1200).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.request import Request, SLO


@dataclass(frozen=True)
class WorkloadProfile:
    name: str
    p_image: float            # fraction of requests carrying images
    n_images: int
    prompt_mean: float        # lognormal parameters for text prompt length
    prompt_sigma: float
    output_mean: float
    output_sigma: float

    def sample_lengths(self, rng: np.random.Generator):
        prompt = int(np.clip(rng.lognormal(np.log(self.prompt_mean),
                                           self.prompt_sigma), 4, 2048))
        out = int(np.clip(rng.lognormal(np.log(self.output_mean),
                                        self.output_sigma), 1, 1024))
        n_img = self.n_images if rng.random() < self.p_image else 0
        return n_img, prompt, out


# Approximations of paper Fig 9 (LLaVA-NeXT workload shown there):
# captioning produces long outputs, classification (MME/POPE) near-binary
# outputs, VQA short answers.
PROFILES = {
    "textcaps": WorkloadProfile("textcaps", 1.0, 1, 44, 0.25, 90, 0.45),
    "pope":     WorkloadProfile("pope", 1.0, 1, 35, 0.20, 4, 0.40),
    "mme":      WorkloadProfile("mme", 1.0, 1, 45, 0.25, 4, 0.40),
    "textvqa":  WorkloadProfile("textvqa", 1.0, 1, 50, 0.30, 14, 0.50),
    "vizwiz":   WorkloadProfile("vizwiz", 1.0, 1, 40, 0.30, 48, 0.60),
    # text-only profile for the language-only assigned archs
    "text":     WorkloadProfile("text", 0.0, 0, 256, 0.60, 128, 0.60),
}

# image tokens per image, per evaluation model (paper §5.1 Models)
IMAGE_TOKENS = {
    "llava-1.5-7b": 576,
    "llava-next-7b": 2880,
    "qwen2-vl-7b": 1236,
}

# paper Table 3 SLO settings (seconds): (model, dataset) -> SLO
PAPER_SLOS = {
    ("llava-1.5-7b", "vizwiz"): SLO(8.0, 0.04),
    ("llava-1.5-7b", "textvqa"): SLO(0.25, 0.04),
    ("llava-1.5-7b", "mme"): SLO(0.25, 0.06),
    ("llava-1.5-7b", "pope"): SLO(0.25, 0.04),
    ("llava-1.5-7b", "textcaps"): SLO(0.25, 0.04),
    ("llava-next-7b", "vizwiz"): SLO(8.0, 0.12),
    ("llava-next-7b", "textvqa"): SLO(8.0, 0.12),
    ("llava-next-7b", "mme"): SLO(8.0, 0.14),
    ("llava-next-7b", "pope"): SLO(8.0, 0.06),
    ("llava-next-7b", "textcaps"): SLO(8.0, 0.08),
    ("qwen2-vl-7b", "vizwiz"): SLO(8.0, 0.14),
    ("qwen2-vl-7b", "textvqa"): SLO(1.0, 0.12),
    ("qwen2-vl-7b", "mme"): SLO(1.0, 0.14),
    ("qwen2-vl-7b", "pope"): SLO(1.0, 0.04),
    ("qwen2-vl-7b", "textcaps"): SLO(1.0, 0.14),
    ("text", "text"): SLO(1.0, 0.05),
}


def slo_for(model: str, dataset: str) -> SLO:
    return PAPER_SLOS.get((model, dataset), SLO(1.0, 0.08))


def make_requests(profile: WorkloadProfile, *, rate: float, n: int,
                  image_tokens_per_image: int, slo: SLO,
                  seed: int = 0) -> list[Request]:
    """Poisson arrival process at ``rate`` req/s; fixed output lengths
    (paper methodology: max_tokens + ignore_eos for engine-fair loads)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n):
        t += rng.exponential(1.0 / rate)
        n_img, prompt, gen = profile.sample_lengths(rng)
        out.append(Request(
            rid=rid, arrival=t, n_images=n_img,
            image_tokens=n_img * image_tokens_per_image,
            prompt_tokens=prompt, max_new_tokens=gen, slo=slo))
    return out


# ---------------------------------------------------------------------------
# cache-sensitive traces: multi-turn conversations and repeated
# ("hot") images — the request mixes where prefix / encode caching decides
# TTFT (EPD-Serve's multi-turn evaluation; TCM-Serve's repeated-visual-
# content observation, see PAPERS.md)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TraceItem:
    """One request of a cache-sensitive trace.

    ``conv``/``turn`` identify the conversation a request belongs to: each
    turn resends the full prior history (system prompt + earlier turns +
    earlier answers) plus ``new_tokens`` fresh tokens, so a prefix cache
    can skip everything but the fresh suffix.  ``image_id`` keys a shared
    image pool: two items with the same id carry byte-identical media, so
    an embedding cache can skip the encode stage for repeats.
    """
    arrival: float
    conv: int                 # conversation id (-1: independent request)
    turn: int                 # 0-based turn index within the conversation
    new_tokens: int           # fresh prompt tokens this turn
    out_tokens: int           # output budget this turn
    image_id: int = -1        # shared-image pool id (-1: no image)


def multiturn_trace(*, n_convs: int, turns: int, rate: float,
                    system_tokens: int = 32, turn_tokens: int = 24,
                    out_tokens: int = 8, p_image: float = 0.0,
                    image_pool: int = 4, zipf_a: float = 1.5,
                    seed: int = 0) -> list[TraceItem]:
    """Interleaved multi-turn conversations under Poisson arrivals.

    Turn 0 carries the system prompt + first user message; turn t > 0
    resends the whole history and appends ~``turn_tokens`` fresh tokens.
    A turn only arrives after the previous one (arrival ordering respects
    causality within a conversation).  Images, when present, stay fixed
    across a conversation's turns (the common VQA-chat shape) and draw
    from a Zipf-distributed shared pool so some images are hot.
    """
    rng = np.random.default_rng(seed)
    t = 0.0
    items = []
    img_ids = [-1] * n_convs
    for c in range(n_convs):
        if rng.random() < p_image:
            img_ids[c] = int(min(rng.zipf(zipf_a), image_pool) - 1)
    last_t = [0.0] * n_convs
    for turn in range(turns):
        for c in range(n_convs):
            t += rng.exponential(1.0 / rate)
            arr = max(t, last_t[c])
            last_t[c] = arr
            fresh = system_tokens + turn_tokens if turn == 0 else \
                max(4, int(rng.normal(turn_tokens, turn_tokens / 4)))
            items.append(TraceItem(arrival=arr, conv=c, turn=turn,
                                   new_tokens=fresh, out_tokens=out_tokens,
                                   image_id=img_ids[c]))
    items.sort(key=lambda it: it.arrival)
    return items


def repeated_image_trace(*, n: int, rate: float, image_pool: int = 4,
                         zipf_a: float = 1.5, prompt_tokens: int = 32,
                         out_tokens: int = 8,
                         seed: int = 0) -> list[TraceItem]:
    """Independent single-turn VQA requests whose images draw from a small
    Zipf-distributed pool: a handful of hot images receive most of the
    traffic, so encode results and their media pages are highly reusable."""
    rng = np.random.default_rng(seed)
    t = 0.0
    items = []
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        img = int(min(rng.zipf(zipf_a), image_pool) - 1)
        fresh = max(4, int(rng.normal(prompt_tokens, prompt_tokens / 4)))
        items.append(TraceItem(arrival=t, conv=-1, turn=0, new_tokens=fresh,
                               out_tokens=out_tokens, image_id=img))
    return items


def trace_requests(items: list[TraceItem], *,
                   image_tokens_per_image: int, slo: SLO) -> list[Request]:
    """Lower a TraceItem list to simulator ``Request``s: turn t's prompt
    length is the conversation's cumulative history (prior prompts + prior
    outputs) plus its fresh tokens.  Real-engine benches instead build the
    actual token bodies turn by turn (benchmarks/bench_cache.py)."""
    hist: dict[int, int] = {}
    out = []
    for rid, it in enumerate(items):
        prior = hist.get(it.conv, 0) if it.conv >= 0 else 0
        prompt = prior + it.new_tokens
        if it.conv >= 0:
            hist[it.conv] = prompt + it.out_tokens
        n_img = 1 if it.image_id >= 0 else 0
        out.append(Request(
            rid=rid, arrival=it.arrival, n_images=n_img,
            image_tokens=n_img * image_tokens_per_image,
            prompt_tokens=prompt, max_new_tokens=it.out_tokens, slo=slo))
    return out
