"""Shared layer primitives: norms, activations, positions, full-sequence
attention, MLPs, init.

Plain functions on tensors, matching ``repro.models.layers`` op for op:
the norm scale is ``(1 + w)``, the GELU is the tanh approximation, and
RoPE is rotate-half on split halves (not interleaved).  KV rows are kept
flattened as ``[..., kv_heads*head_dim]`` like the JAX package.
``blockwise_attention`` goes through ``kernels.flash_attention.ops`` (the
hand-written CUDA kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention


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


def sinusoidal_positions(positions, d_model: int, dtype=torch.float32):
    """Absolute sinusoidal embeddings (whisper-style).  positions: [S]."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def lengths_vector(cache_len, B, device=None):
    """Normalize a scalar-or-[B] cache length to a [B] int32 vector."""
    v = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return v.expand(B) if v.ndim == 0 else v


# ---------------------------------------------------------------------------
# Full-sequence attention
# ---------------------------------------------------------------------------
def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_offset: int = 0):
    """q: [B, Sq, H, D]; k: [B, Sk, Kh, D]; v: [B, Sk, Kh, Dv] -> [B, Sq,
    H, Dv], scaled by 1/sqrt(D) (V may be narrower, as MLA's).  GQA by
    ``h // (H // Kh)``.

    ``kv_offset``: absolute position of q[0] minus that of k[0]; ``window``
    > 0 keeps the last ``window`` keys of each query.  The JAX package
    loops over query chunks and slices the window's keys; here one kernel
    call computes the whole function on head-split views (no copy), and
    skips the key tiles a query tile cannot see.  A query that sees no key
    comes out 0 (the JAX loop's softmax over all-masked scores averages
    them instead); serving never makes such a row.  Gradients flow
    through it (training): with grad on, the flash wrapper's autograd
    Function runs the backward kernel on the card.
    """
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window,
                          kv_offset=kv_offset)
    return out.transpose(1, 2)


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
