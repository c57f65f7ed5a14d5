"""Plain PyTorch versions of paged attention: decode (one query token) and
chunked prefill (a chunk of queries, chunk-causal over pages).  Gather the
pages, then a masked softmax in f32, as ``repro``'s jnp oracles do.  And the
decode kernel's split-KV pair: per-split partials over ranges of table
columns, merged by log-sum-exp."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, merge_partials_ref


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


def split_columns(max_pages: int, n_split: int) -> list:
    """The table columns [lo, hi) of each decode split: ceil(max_pages /
    n_split) whole pages each, cut at max_pages (empty past it)."""
    per = -(-max_pages // n_split)
    return [(min(s * per, max_pages), min((s + 1) * per, max_pages))
            for s in range(n_split)]


def paged_attention_partials_ref(q, k_pages, v_pages, block_tables, lengths,
                                 n_split: int, *, window: int = 0):
    """The decode split kernel's output: for each split of the table's
    columns (:func:`split_columns`), the f32 softmax state of every query
    head over the visible keys of that split: m [n_split, B, H] (the
    largest scaled score, NEG_INF where the split sees no key), l (the sum
    of exp(score - m)) and acc [n_split, B, H, D] (the sum of exp(score -
    m) * v).  A key past lengths[b], or before lengths[b] - window, adds
    exactly 0."""
    B, H, D = q.shape
    Kh = k_pages.shape[2]
    page = k_pages.shape[1]
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    S = k.shape[1]
    qf = q.float().reshape(B, Kh, H // Kh, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)[None]
    lens = lengths.long()[:, None]
    valid = pos < lens
    if window:
        valid &= pos >= lens - window
    ms, ls, accs = [], [], []
    for lo, hi in split_columns(block_tables.shape[1], n_split):
        vis = valid[:, None, None, lo * page:hi * page]
        s = scores[..., lo * page:hi * page].masked_fill(~vis, NEG_INF)
        m = s.amax(-1) if hi > lo else torch.full(
            s.shape[:-1], NEG_INF, device=q.device)
        p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
        l = p.sum(-1)
        ms.append(torch.where(l > 0, m, NEG_INF).reshape(B, H))
        ls.append(l.reshape(B, H))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p,
                                 v[:, lo * page:hi * page]).reshape(B, H, D))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths,
                              n_split: int, *, window: int = 0):
    """Decode attention the way the kernel computes it: the partials of
    ``n_split`` splits, then their merge; [B, H, D] in q's type.  A lane
    that sees no key comes out 0."""
    parts = paged_attention_partials_ref(q, k_pages, v_pages, block_tables,
                                         lengths, n_split, window=window)
    return merge_partials_ref(*parts).to(q.dtype)


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
