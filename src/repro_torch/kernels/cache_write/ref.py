"""Plain PyTorch version of the fused paged-cache write (scatter)."""
from __future__ import annotations


def cache_write_ref(cache, new, slot_mapping):
    """cache: [n_blocks, bs, w]; new: [T, w]; slot_mapping: [T] global slots.

    Writes new[t] at slot_mapping[t] (= block slot//bs, row slot%bs), cast
    to the cache's type, in place; returns ``cache``.
    """
    w = cache.shape[-1]
    cache.view(-1, w).index_copy_(0, slot_mapping.long(),
                                  new.reshape(-1, w).to(cache.dtype))
    return cache
