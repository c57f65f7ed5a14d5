"""Plain PyTorch versions of paged attention: decode (one query token) and
chunked prefill (a chunk of queries, chunk-causal over pages).  Gather the
pages, then a masked softmax in f32, as ``repro``'s jnp oracles do.  And the
decode kernel's split-KV pair: per-split partials over ranges of table
columns, merged by log-sum-exp; and the latent-row kernels' decomposition
(:func:`latent_tiles_ref`), for tests of their arithmetic off the card."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, merge_partials_ref

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


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


def latent_tiles_ref(q, pages, block_tables, lens, *, decode: bool,
                     n_split: int = 1, split_pages=None, rows: int = 64,
                     keys: int = 32, round_bf16: bool = False,
                     p_hi_lo=None):
    """The latent-row kernels' arithmetic (``csrc/attn_latent.cuh``) in
    plain PyTorch, tile by tile: 1-KV-head attention whose values are the
    keys' rows (K = V = ``pages`` [n_pages, page, 1, D]).

    decode: q [B, H, D], lens = tokens valid (the new one included); else
    chunked prefill: q [B, C, H, D], lens = tokens cached before the chunk.
    Query rows are (chunk row, head) pairs r = c * H + g in tiles of
    ``rows``; each tile walks its keys in ``keys``-key tiles with an online
    softmax in f32 in log2 units (scores times log2(e) / sqrt(D), a masked
    key at the finite NEG_INF for the row max and exactly 0 after it).
    Decode cuts the keys into ``n_split`` ranges of ``split_pages`` table
    columns (default: ceil(max_pages / n_split)) whose partials (m, l,
    acc) are merged by log-sum-exp (:func:`merge_partials_ref`, as the
    kernel's cluster merges them); prefill is one range.  ``round_bf16``
    weighs P V as the bf16 tensor-core tiles do, l summing the P that the
    product weighs: prefill rounds P to bf16, decode takes it as hi + lo,
    hi its bf16 rounding and lo the bf16 rounding of the rest (``p_hi_lo``
    overrides which); and rounds the output to bf16.  Returns q's shape,
    f32 unless ``round_bf16``."""
    if p_hi_lo is None:
        p_hi_lo = decode
    q4 = q[:, None] if decode else q
    B, C, H, D = q4.shape
    page, P = pages.shape[1], block_tables.shape[1]
    kv = _gather(pages, block_tables)[:, :, 0]             # [B, S, D]
    if split_pages is None:
        split_pages = -(-P // n_split)
    scale_log2 = LOG2E / math.sqrt(D)
    out = torch.zeros((B, C * H, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        qb = q4[b].reshape(C * H, D).float()
        n = int(lens[b])
        ctx = n - 1 if decode else n
        for row0 in range(0, C * H, rows):
            qt = qb[row0:row0 + rows]
            qpos = ctx + torch.arange(row0, row0 + qt.shape[0],
                                      device=q.device) // H
            parts = []
            for s in range(n_split if decode else 1):
                if decode:
                    k0 = s * split_pages * page
                    k1 = min(n, P * page, (s + 1) * split_pages * page)
                else:
                    k0, k1 = 0, min(P * page, int(qpos[-1]) + 1)
                m = torch.full((qt.shape[0],), NEG_INF, device=q.device)
                l = torch.zeros_like(m)
                acc = torch.zeros_like(qt)
                for kb in range(k0, k1, keys):
                    kt = kv[b, kb:kb + keys]
                    key = torch.arange(kb, kb + kt.shape[0], device=q.device)
                    vis = (key[None] < k1) & (key[None] <= qpos[:, None])
                    sc = qt @ kt.T
                    mx = torch.where(vis, sc, NEG_INF).amax(1)
                    m_new = torch.maximum(m, torch.where(
                        mx == NEG_INF, NEG_INF, mx * scale_log2))
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(vis, torch.exp2(
                        sc * scale_log2 - m_new[:, None]), 0.0)
                    if round_bf16:
                        hi = p.bfloat16().float()
                        p = hi + (p - hi).bfloat16().float() if p_hi_lo else hi
                    l = alpha * l + p.sum(1)
                    acc = alpha[:, None] * acc + p @ kt
                    m = m_new
                parts.append((torch.where(l > 0, m * LN2, NEG_INF), l, acc))
            if len(parts) == 1:
                o = parts[0][2] / parts[0][1].clamp_min(1e-30)[:, None]
            else:
                o = merge_partials_ref(*(torch.stack(x) for x in zip(*parts)))
            out[b, row0:row0 + qt.shape[0]] = o
    out = out.reshape(q.shape)
    return out.bfloat16() if round_bf16 else out
