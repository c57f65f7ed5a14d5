"""Budget profiling (paper §4.2, DESIGN.md §6): binary-search the max
prefill token budget and encode image budget such that one batch iteration
stays under the TPOT SLO even with a full complement of ongoing decodes in
the batch.  Heterogeneous clusters profile one ``Budgets`` per distinct
(Hardware, TP) pair — see DESIGN.md §7.2."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import BatchWork, Hardware, batch_time


@dataclass(frozen=True)
class Budgets:
    token_budget: int    # tau_t: chunked-prefill tokens per iteration
    image_budget: int    # tau_e: images encoded per iteration


def _iter_time(cfg, hw, *, prefill_tokens=0, images=0, decode_batch=0,
               decode_context=1024, tp=1):
    work = BatchWork(decode_batch=decode_batch, decode_context=decode_context,
                     prefill_tokens=prefill_tokens, prefill_batch=1,
                     prefill_context=prefill_tokens, encode_images=images)
    return batch_time(cfg, hw, work, parallel_streams=True, tp=tp)


def _bsearch(lo: int, hi: int, ok) -> int:
    """Largest x in [lo, hi] with ok(x); lo-1 if none."""
    if not ok(lo):
        return lo - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def compute_budgets(cfg: ModelConfig, hw: Hardware, tpot_slo: float, *,
                    ref_decode_batch: int = 64, ref_context: int = 1024,
                    tp: int = 1, max_tokens: int = 16384,
                    max_images: int = 64) -> Budgets:
    """Profile tau_t and tau_e by binary search (paper Algorithm 1 init)."""
    def tok_ok(n):
        return _iter_time(cfg, hw, prefill_tokens=n,
                          decode_batch=ref_decode_batch,
                          decode_context=ref_context, tp=tp) <= tpot_slo

    def img_ok(n):
        return _iter_time(cfg, hw, images=n, decode_batch=ref_decode_batch,
                          decode_context=ref_context, tp=tp) <= tpot_slo

    tau_t = max(_bsearch(1, max_tokens, tok_ok), 16)    # floor: progress guarantee
    tau_e = max(_bsearch(1, max_images, img_ok), 1)
    return Budgets(token_budget=tau_t, image_budget=tau_e)
