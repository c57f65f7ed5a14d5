"""Plain PyTorch version of flash attention: the masked softmax in f32, as
``repro``'s jnp oracle (``flash_attention_ref``) computes it."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_offset: int = 0):
    """q: [B, H, Sq, D]; k/v: [B, Kh, Sk, D] -> [B, H, Sq, D] in q's type.

    Query row i sits at position ``kv_offset + i`` and sees key position
    ``kpos`` when ``kpos <= qpos`` (causal) and ``kpos > qpos - window``
    (``window`` > 0).  Query head h reads KV head ``h // (H // Kh)``.  A
    row that sees no key comes out 0.
    """
    B, H, Sq, D = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    G = H // Kh
    qf = q.float().reshape(B, Kh, G, Sq, D)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) / math.sqrt(D)
    qpos = kv_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).nan_to_num(0.0)  # empty rows
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)
