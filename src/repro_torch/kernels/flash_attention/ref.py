"""Plain PyTorch version of flash attention: the masked softmax in f32, as
``repro``'s jnp oracle (``flash_attention_ref``) computes it; and of the
split-KV pair the bf16 kernel uses for short query tiles: per-split
partials (m, l, acc) and their log-sum-exp merge."""
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
    """q: [B, H, Sq, D]; k/v: [B, Kh, Sk, D] -> [B, H, Sq, D] in q's type.

    Query row i sits at position ``kv_offset + i`` and sees key position
    ``kpos`` when ``kpos <= qpos`` (causal) and ``kpos > qpos - window``
    (``window`` > 0).  Query head h reads KV head ``h // (H // Kh)``.  A
    row that sees no key comes out 0.
    """
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    mask = _visible(Sq, Sk, causal, window, kv_offset, q.device)
    scores = _scores(q, k).masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).nan_to_num(0.0)  # empty rows
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


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
    exp(score - m)) and acc [n_split, B, H, Sq, D] (the sum of
    exp(score - m) * v).  A masked key adds exactly 0."""
    B, H, Sq, D = q.shape
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
                    .reshape(B, H, Sq, D))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_partials_ref(m, l, acc):
    """Merge split partials by log-sum-exp -> f32 [B, H, Sq, D]: splits
    with l = 0 weigh nothing, and a row that no split saw comes out 0."""
    live = l > 0
    top = torch.where(live, m, NEG_INF).amax(0)
    w = torch.where(live, torch.exp(m - top), 0.0)
    denom = (w * l).sum(0).clamp_min(1e-30)
    return (w[..., None] * acc).sum(0) / denom[..., None]
