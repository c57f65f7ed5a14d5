"""Plain PyTorch version of flash attention: the masked softmax in f32, as
``repro``'s jnp oracle (``flash_attention_ref``) computes it, also with
each row's log-sum-exp (``flash_attention_fwd_ref``); its gradient by the
explicit formulas the backward kernel computes (``flash_attention_bwd_ref``);
and the split-KV pair the bf16 kernel uses for short query tiles:
per-split partials (m, l, acc) and their log-sum-exp merge.

V may be narrower than Q and K (MLA: queries and keys 192 wide, values
128): q/k [..., Dqk], v [..., Dv], the output and every value-side
tensor Dv wide, the scores scaled by 1/sqrt(Dqk), as the reference's
``blockwise_attention`` does."""
from __future__ import annotations

import math

import torch

BLOCK_K = 64          # keys per tile of the kernel; splits hold whole tiles
NEG_INF = -1e30       # the kernels' finite mask value


def _visible(Sq, Sk, causal, window, kv_offset, device):
    """[Sq, Sk] bool: query row i (position kv_offset + i) sees key j."""
    qpos = kv_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k):
    """f32 scores [B, Kh, G, Sq, Sk], scaled after the product."""
    B, H, Sq, D = q.shape
    Kh = k.shape[1]
    qf = q.float().reshape(B, Kh, H // Kh, Sq, D)
    return torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) / math.sqrt(D)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_offset: int = 0):
    """q: [B, H, Sq, D]; k: [B, Kh, Sk, D]; v: [B, Kh, Sk, Dv] -> [B, H, Sq,
    Dv] in q's type.

    Query row i sits at position ``kv_offset + i`` and sees key position
    ``kpos`` when ``kpos <= qpos`` (causal) and ``kpos > qpos - window``
    (``window`` > 0).  Query head h reads KV head ``h // (H // Kh)``.  A
    row that sees no key comes out 0.
    """
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    mask = _visible(Sq, Sk, causal, window, kv_offset, q.device)
    scores = _scores(q, k).masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).nan_to_num(0.0)  # empty rows
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            kv_offset: int = 0):
    """(out, lse): :func:`flash_attention_ref`'s output and the f32
    log-sum-exp [B, H, Sq] of each row's scaled, masked scores, ``+inf``
    for a row that sees no key (so its probabilities exp(s - lse) are 0
    in the backward)."""
    B, H, Sq, _ = q.shape
    mask = _visible(Sq, k.shape[2], causal, window, kv_offset, q.device)
    scores = _scores(q, k).masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    lse = torch.where(torch.isneginf(lse), float("inf"), lse)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return (out.reshape(B, H, Sq, v.shape[-1]).to(q.dtype),
            lse.reshape(B, H, Sq))


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: int = 0, kv_offset: int = 0):
    """(dq, dk, dv) of flash attention, in the inputs' types, computed in
    f32 by the explicit formulas (scale = 1/sqrt(D), applied after the
    product as the forward does):

        delta = rowsum(dO * O),  P = exp(S * scale - lse),
        dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),
        dQ = dS K * scale,  dK = dS^T Q * scale,

    dK and dV summed over the G = H / Kh query heads of each KV head; out,
    dout and dV Dv wide as v.  ``lse`` [B, H, Sq] is
    :func:`flash_attention_fwd_ref`'s; a row that sees no key (lse = +inf)
    has P = 0 and gets zero gradients."""
    B, H, Sq, D = q.shape
    Kh, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Kh
    scale = 1.0 / math.sqrt(D)
    mask = _visible(Sq, Sk, causal, window, kv_offset, q.device)
    qf = q.float().reshape(B, Kh, G, Sq, D)
    of = out.float().reshape(B, Kh, G, Sq, Dv)
    dof = dout.float().reshape(B, Kh, G, Sq, Dv)
    kf, vf = k.float(), v.float()
    lse5 = lse.float().reshape(B, Kh, G, Sq, 1)
    delta = (dof * of).sum(-1, keepdim=True)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse5), 0.0)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def split_ranges(Sk: int, n_split: int, block_k: int = BLOCK_K) -> list:
    """The key range [lo, hi) of each split: ceil(tiles / n_split) whole
    tiles of ``block_k`` keys each, the last one cut at Sk."""
    tiles = -(-Sk // block_k)
    per = -(-tiles // n_split) * block_k
    return [(s * per, min((s + 1) * per, Sk)) for s in range(n_split)]


def flash_attention_partials_ref(q, k, v, n_split: int, *, causal: bool = True,
                                 window: int = 0, kv_offset: int = 0):
    """The split kernel's output: for each split of the keys
    (:func:`split_ranges`), the f32 softmax state of every query row over
    the keys of that split it sees — m [n_split, B, H, Sq] (the largest
    scaled score, NEG_INF where the split sees no key), l (the sum of
    exp(score - m)) and acc [n_split, B, H, Sq, Dv] (the sum of
    exp(score - m) * v).  A masked key adds exactly 0."""
    B, H, Sq, _ = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[2]
    scores = _scores(q, k)
    mask = _visible(Sq, Sk, causal, window, kv_offset, q.device)
    vf = v.float()
    ms, ls, accs = [], [], []
    for lo, hi in split_ranges(Sk, n_split):
        vis = mask[:, lo:hi]
        s = scores[..., lo:hi].masked_fill(~vis, NEG_INF)
        m = s.amax(-1) if hi > lo else torch.full(
            s.shape[:-1], NEG_INF, device=q.device)
        p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
        l = p.sum(-1)
        ms.append(torch.where(l > 0, m, NEG_INF).reshape(B, H, Sq))
        ls.append(l.reshape(B, H, Sq))
        accs.append(torch.einsum("bkgqs,bksd->bkgqd", p, vf[:, :, lo:hi])
                    .reshape(B, H, Sq, Dv))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_partials_ref(m, l, acc):
    """Merge split partials by log-sum-exp -> f32 [B, H, Sq, D]: splits
    with l = 0 weigh nothing, and a row that no split saw comes out 0."""
    live = l > 0
    top = torch.where(live, m, NEG_INF).amax(0)
    w = torch.where(live, torch.exp(m - top), 0.0)
    denom = (w * l).sum(0).clamp_min(1e-30)
    return (w[..., None] * acc).sum(0) / denom[..., None]
