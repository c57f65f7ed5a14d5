"""Mixture-of-Experts FFN: the serving (lossless) path and the
capacity-dropping training path.

The PyTorch counterpart of ``repro.models.moe``'s ``init_moe`` and
``moe_ffn``: an f32 router over the f32-cast input, softmax, top-k, the k
gates renormalised by their sum, each token's k expert outputs weighted by
its gates and summed, then the shared experts' gated MLP (DeepSeek-V2)
added; and the Switch-style load-balance loss.

``lossless=True`` (the JAX package's decode and chunked-prefill steps):
the JAX package scatters tokens into an [E, T + 1, d] buffer and
multiplies every expert by every row of it.  Here only the routed (token,
expert) pairs are computed: a stable sort groups them by expert (arrival
order within an expert, as the reference ranks them), and each expert with
work runs its gated MLP as plain matrix products on its rows.  The
per-expert row counts are read on the host to cut the sorted rows (one
sync per MoE layer; ROADMAP queue 1 item 10 lists it as a CUDA-graph
blocker).

``lossless=False`` (training) is the reference's capacity path as it is:
capacity C = min(max(1, int(cf T k / E)), T), each (token, slot) ranked
in its expert by a stable sort, pairs past C sent to an overflow row C,
the kept ones scattered into fixed-shape [E, C + 1, d] buffers (no host
read), the experts run as batched matrix products over them, the outputs
written back to their pairs and gate-weighted.  Kept pairs have unique
(expert, slot) indices, so each scatter writes each kept row once,
whatever the order; only the discarded overflow row and the row of
empty slots take several writes.

Under a mesh (``models/sharding.py``) the experts are cut over ``model``
(a rank holds a span of them) and the tokens are replicated over it: every
model rank routes all of its tokens alike and runs only the (token,
expert) pairs of its own experts, in both paths; the gate-weighted
outputs are summed in f32 over ``model``.  With data ranks the capacity
path ranks each pair in its expert's queue over the whole batch, as the
unsharded model does: the expert ids of every data rank are gathered (by
``all_reduce``), and the aux loss takes the batch's means.  The JAX
package's shard-map and data-sharded dispatch switches (layouts for
GSPMD) have no counterpart: every collective here is explicit.  The
``all_to_all`` dispatch of its ``moe_ffn_shardmap`` comes with training
under a mesh (ROADMAP queue 1 item 16).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models import sharding as SH


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


def _probs(p, xt):
    """Softmax of the f32 router logits of tokens xt [T, d]: [T, E]."""
    return torch.softmax(xt.float() @ p.router, dim=-1)


def route(p, xt, cfg, probs=None):
    """(gates [T, k] f32, expert ids [T, k]) of tokens xt [T, d]: softmax
    of the f32 router logits, top-k, gates renormalised by their sum."""
    probs = _probs(p, xt) if probs is None else probs
    gates, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates, ids


def aux_loss(probs, counts, cfg):
    """The Switch-style load-balance loss E * sum(me sg(ce) + sg(me) ce) / 2
    of the reference: me the mean router probability of each expert, ce
    the share of (token, slot) pairs routed to it (``counts`` [E])."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T, n = probs.shape[0], SH.dp_size()
    if n > 1:               # the whole batch's means, over the data ranks
        me = SH.reduce_dp(probs.sum(0)) / (T * n)
        counts, T = SH.reduce_dp(counts.float()), T * n
    else:
        me = probs.mean(0)
    ce = counts.float() / (T * k)
    return E * (me * ce.detach() + me.detach() * ce).sum() * 0.5


def capacity(cfg, T: int) -> int:
    """Expert capacity of the training path at T tokens."""
    E, k = cfg.num_experts, cfg.experts_per_token
    return min(max(1, int(cfg.moe_capacity_factor * T * k / E)), T)


def _shared(p, xt, act):
    return SH.row_parallel(act(xt @ p.sh_w_gate) * (xt @ p.sh_w_up),
                           p.sh_w_down)


def moe_ffn(p, x, cfg, *, lossless: bool = False):
    """x [B, S, d] -> ([B, S, d], aux load-balance loss), as
    ``repro.models.moe.moe_ffn``: ``lossless`` keeps every (token, slot)
    pair (serving); otherwise each expert takes at most
    :func:`capacity` pairs, in arrival order, and drops the rest
    (training).  The serving steps drop the aux loss, so ``lossless``
    skips its kernels and returns None in its place."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs = _probs(p, xt)
    gates, ids = route(p, xt, cfg, probs)
    flat = ids.reshape(-1)
    counts = torch.bincount(flat, minlength=cfg.num_experts)
    aux = None if lossless else aux_loss(probs, counts, cfg)
    act = layers.act_fn(cfg.act)
    out = (_routed if lossless else _capacity_dropping)(
        p, xt, gates, flat, counts, cfg, act).to(x.dtype)
    if hasattr(p, "sh_w_gate"):
        out = out + _shared(p, xt, act)
    return out.reshape(B, S, d), aux


def _combine(y, gates, k):
    """Each token's k pair outputs y [T * k, d] weighted by their gates
    and summed; under a mesh, where each model rank holds its experts'
    pairs (zeros elsewhere), summed in f32 over ``model``."""
    y = y.view(-1, k, y.shape[-1]) * gates[..., None].to(y.dtype)
    if SH.axis_size("model") == 1:
        return y.sum(1)
    return SH.reduce_model(y.float().sum(1)).to(y.dtype)


def _routed(p, xt, gates, flat, counts, cfg, act):
    """Every routed pair of the rank's experts through its expert (the
    serving path)."""
    k, d = cfg.experts_per_token, xt.shape[1]
    lo, hi = SH.model_span(cfg.num_experts)
    n = counts.tolist()
    order = torch.argsort(flat, stable=True)     # pairs grouped by expert
    first = sum(n[:lo])
    mine = order[first:first + sum(n[lo:hi])]    # those of experts lo..hi-1
    xs = xt[mine // k]                           # each pair's token row
    ys = torch.empty_like(xs)
    start = 0
    for e in range(lo, hi):
        if n[e]:
            xe = xs[start:start + n[e]]
            h = act(xe @ p.moe_w_gate[e - lo]) * (xe @ p.moe_w_up[e - lo])
            ys[start:start + n[e]] = h @ p.moe_w_down[e - lo]
            start += n[e]
    y = ys.new_zeros((flat.numel(), d))
    y[mine] = ys                                 # back to (token, slot)
    return _combine(y, gates, k)


def _queue_pos(flat, counts):
    """Each pair's place in its expert's queue, in arrival order: its place
    in the stable sort less the expert's first place."""
    order = torch.argsort(flat, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(flat.numel(), device=flat.device) \
        - starts[flat[order]]
    return torch.empty_like(flat).scatter_(0, order, ranks)


def _capacity_dropping(p, xt, gates, flat, counts, cfg, act):
    """The reference's capacity path, every shape fixed by T (the whole
    batch's T under data ranks); under a mesh, over the rank's experts."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    n = SH.dp_size()
    C = capacity(cfg, T * n)
    if n > 1:       # queue places among the whole batch's pairs, in order
        every = SH.gather_dp(flat).reshape(-1).long()
        off = SH.dp_rank() * T * k
        pos = _queue_pos(every, torch.bincount(every, minlength=E))[
            off:off + T * k]
    else:
        pos = _queue_pos(flat, counts)
    lo, hi = SH.model_span(E)
    e = flat - lo                                  # the rank's expert index
    mine = (e >= 0) & (e < hi - lo)
    slot = torch.where(mine & (pos < C), pos,
                       torch.full_like(pos, C))    # C: overflow / elsewhere
    e = e.clamp(0, hi - lo - 1)
    xrep = xt.repeat_interleave(k, dim=0)                      # [T*k, d]
    buf = xt.new_zeros((hi - lo, C + 1, d)).index_put((e, slot), xrep)
    xe = buf[:, :C]                                   # [E on this rank, C, d]
    h = act(torch.bmm(xe, p.moe_w_gate)) * torch.bmm(xe, p.moe_w_up)
    ye = torch.bmm(h, p.moe_w_down)                            # [E, C, d]
    # combine: each kept slot's output written back to its pair (the pair
    # a slot holds, T*k for an empty slot: a row that is dropped), so
    # dropped pairs read zeros.  The reference gathers ye[flat, slot]
    # instead; this is the same sum, and its gradient is a gather rather
    # than the scatter-add of an index whose overflow rows repeat
    # thousands of times
    pair = torch.full((hi - lo, C + 1), T * k, dtype=flat.dtype,
                      device=xt.device)
    pair = pair.index_put((e, slot), torch.arange(T * k, device=xt.device))
    y = ye.new_zeros((T * k + 1, d)).index_put(
        (pair[:, :C].reshape(-1),), ye.reshape(-1, d))
    return _combine(y[:T * k], gates, k)
