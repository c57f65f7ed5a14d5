"""Shared layer primitives: norms, activations, RoPE, MLPs, init.

Plain functions on tensors, matching ``repro.models.layers`` op for op:
the norm scale is ``(1 + w)``, the GELU is the tanh approximation, and
RoPE is rotate-half on split halves (not interleaved).  KV rows are kept
flattened as ``[..., kv_heads*head_dim]`` like the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dtype)


def act_fn(name: str):
    if name.startswith("gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    return F.silu


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """Rotate-half RoPE.  x: [..., S, H, D]; positions: [..., S] or [S]."""
    d = x.shape[-1]
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, d, 2, dtype=torch.float32,
                                     device=x.device) / d)
    angles = positions[..., :, None].float() * freqs      # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                 # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def lengths_vector(cache_len, B, device=None):
    """Normalize a scalar-or-[B] cache length to a [B] int32 vector."""
    v = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return v.expand(B) if v.ndim == 0 else v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def gated_mlp(p, x, act: str):
    a = act_fn(act)
    return (a(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


def plain_mlp(p, x, act: str):
    a = act_fn(act)
    return a(x @ p.w_up) @ p.w_down


def mlp(p, x, act: str):
    if hasattr(p, "w_gate"):
        return gated_mlp(p, x, act)
    return plain_mlp(p, x, act)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None):
    """Normal weights scaled by 1/sqrt(fan_in), drawn from ``gen`` on the
    generator's own device (so full-size weights never pass the host)."""
    fan_in = shape[0]
    if len(shape) == 3:  # [experts, in, out]
        fan_in = shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w.mul_(s)).to(dtype)
