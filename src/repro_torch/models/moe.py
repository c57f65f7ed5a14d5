"""Mixture-of-Experts FFN, the serving (lossless) path.

The PyTorch counterpart of ``repro.models.moe``'s ``init_moe`` and of
``moe_ffn(..., lossless=True)``, the path the JAX package's decode and
chunked-prefill steps take (granite-moe and DeepSeek-V2): an f32 router
over the f32-cast input, softmax, top-k, the k gates renormalised by their
sum, each token's k expert outputs weighted by its gates and summed, then
the shared experts' gated MLP (DeepSeek-V2) added.

The JAX package scatters tokens into an [E, T + 1, d] buffer and multiplies
every expert by every row of it.  Here only the routed (token, expert)
pairs are computed: a stable sort groups them by expert (arrival order
within an expert, as the reference ranks them), and each expert with work
runs its gated MLP as plain matrix products on its rows.  The per-expert
row counts are read on the host to cut the sorted rows (one sync per MoE
layer; ROADMAP queue 1 item 10 lists it as a CUDA-graph blocker).  The
capacity-dropping training path and the shard-map dispatch are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    """The MoE leaves of one layer, in the JAX tree's names and layout: the
    router [d, E] in f32, experts [E, d, ff] / [E, ff, d], and with shared
    experts their gated MLP ``sh_w_*`` of width ff * num_shared_experts."""
    d, ff, E = cfg.d_model, (cfg.moe_d_ff or cfg.d_ff), cfg.num_experts

    def dense(shape, dt=dtype):
        return layers.dense_init(gen, shape, dt)

    p = {"router": dense((d, E), torch.float32),
         "moe_w_gate": dense((E, d, ff)), "moe_w_up": dense((E, d, ff)),
         "moe_w_down": dense((E, ff, d))}
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        p.update({"sh_w_gate": dense((d, sff)), "sh_w_up": dense((d, sff)),
                  "sh_w_down": dense((sff, d))})
    return p


def route(p, xt, cfg):
    """(gates [T, k] f32, expert ids [T, k]) of tokens xt [T, d]: softmax
    of the f32 router logits, top-k, gates renormalised by their sum."""
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    gates, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates, ids


def moe_ffn(p, x, cfg):
    """x [B, S, d] -> [B, S, d]: what ``repro.models.moe.moe_ffn(...,
    lossless=True)`` returns first (its load-balance loss is a training
    term and is not computed)."""
    B, S, d = x.shape
    k = cfg.experts_per_token
    xt = x.reshape(-1, d)
    gates, ids = route(p, xt, cfg)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)     # pairs grouped by expert
    counts = torch.bincount(flat, minlength=cfg.num_experts).tolist()
    xs = xt[order // k]                          # each pair's token row
    ys = torch.empty_like(xs)
    act = layers.act_fn(cfg.act)
    start = 0
    for e, n in enumerate(counts):
        if n:
            xe = xs[start:start + n]
            h = act(xe @ p.moe_w_gate[e]) * (xe @ p.moe_w_up[e])
            ys[start:start + n] = h @ p.moe_w_down[e]
            start += n
    y = torch.empty_like(ys)
    y[order] = ys                                # back to (token, slot)
    out = (y.view(-1, k, d) * gates[..., None].to(y.dtype)).sum(1)
    out = out.to(x.dtype)
    if hasattr(p, "sh_w_gate"):
        out = out + (act(xt @ p.sh_w_gate) * (xt @ p.sh_w_up)) @ p.sh_w_down
    return out.reshape(B, S, d)
