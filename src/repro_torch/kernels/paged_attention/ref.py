"""Plain PyTorch versions of paged attention: decode (one query token) and
chunked prefill (a chunk of queries, chunk-causal over pages).  Gather the
pages, then a masked softmax in f32, as ``repro``'s jnp oracles do."""
from __future__ import annotations

import math

import torch


def _gather(pages, block_tables):
    """[n_pages, page, Kh, D] pages -> contiguous [B, S, Kh, D] in f32."""
    B, P = block_tables.shape
    _, page, Kh, D = pages.shape
    return pages[block_tables.long()].reshape(B, P * page, Kh, D).float()


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        window: int = 0):
    """q: [B, H, D]; pages: [n_pages, page, Kh, D];
    block_tables: [B, max_pages] int32; lengths: [B] (tokens valid).

    ``window`` > 0: sliding-window layers only see the last ``window``
    positions (the query sits at position lengths-1).
    """
    B, H, D = q.shape
    Kh = k_pages.shape[2]
    G = H // Kh
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    S = k.shape[1]
    qf = q.float().reshape(B, Kh, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)[None]
    lens = lengths.long()[:, None]
    valid = pos < lens
    if window:
        valid &= pos >= lens - window
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    return out.reshape(B, H, D).to(q.dtype)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                                *, window: int = 0):
    """Chunked-prefill attention over pages.  q: [B, C, H, D] — query c of
    request b sits at absolute position ``ctx_lens[b] + c``; pages:
    [n_pages, page, Kh, D]; block_tables: [B, max_pages] int32; ctx_lens:
    [B] tokens already cached *before* this chunk.

    The chunk's own K/V rows must already be written into the pages
    (write-then-attend), so chunk-causality is pure masking: query c sees
    key positions ``<= ctx_lens[b] + c``, restricted to the last ``window``
    positions when ``window`` > 0.  Rows whose mask is empty (padded lanes /
    padded chunk positions) produce finite garbage the caller discards.
    """
    B, C, H, D = q.shape
    Kh = k_pages.shape[2]
    G = H // Kh
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    S = k.shape[1]
    qf = q.float().reshape(B, C, Kh, G, D)
    scores = torch.einsum("bckgd,bskd->bkgcs", qf, k) / math.sqrt(D)
    qpos = ctx_lens.long()[:, None] + torch.arange(C, device=q.device)
    kpos = torch.arange(S, device=q.device)[None, None, :]
    valid = kpos <= qpos[:, :, None]                          # [B, C, S]
    if window:
        valid &= kpos > qpos[:, :, None] - window
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcs,bskd->bckgd", probs, v)
    return out.reshape(B, C, H, D).to(q.dtype)
