"""AdamW with linear warmup and cosine decay, as ``repro.train.optim``.

Parameters are a :class:`repro_torch.params.ParamTree` and are updated in
place (a full-width model has no room for a second copy); gradients and
the f32 moments are dicts keyed by the tree's paths
(:meth:`ParamTree.leaves`: ``"embed"``, ``"layers/0/wq"``), the key layout
of the JAX package's checkpoints.  The update is plain PyTorch, one leaf at
a time: the JAX package has no kernel there.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 as the JAX package computes it
    (a 0-d tensor on the host)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    """{"step": 0-d int32 host counter, "m" / "v": {path: f32 zeros on the
    leaf's device}}."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.leaves().items()}
    return {"step": torch.zeros((), dtype=torch.int32),
            "m": zeros, "v": {k: torch.zeros_like(z) for k, z in zeros.items()}}


def _global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every gradient element's square, in f32."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in grads.values()]
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads: dict, state: dict):
    """One AdamW step, in place on ``params`` and ``state``'s moments.
    Returns (params, new state, {"lr", "grad_norm"}): the gradients are
    clipped by their global norm (the raw norm is reported), and weight
    decay applies to leaves of two or more dimensions only."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    lr = lr_at(cfg, step)
    lr_f = float(lr)
    b1c = 1 - cfg.b1 ** float(step)
    b2c = 1 - cfg.b2 ** float(step)
    for k, p in params.leaves().items():
        m, v = state["m"][k], state["v"][k]
        g = grads[k].float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        pf = p.float()
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta.add_(pf, alpha=cfg.weight_decay)
        p.copy_(pf.sub_(delta, alpha=lr_f))
    state = {"step": step, "m": state["m"], "v": state["v"]}
    return params, state, {"lr": lr, "grad_norm": gnorm}
