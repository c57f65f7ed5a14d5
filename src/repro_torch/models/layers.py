"""Shared layer primitives: norms, activations, positions, full-sequence
attention, MLPs, init.

Plain functions on tensors, matching ``repro.models.layers`` op for op:
the norm scale is ``(1 + w)``, the GELU is the tanh approximation, and
RoPE is rotate-half on split halves (not interleaved).  KV rows are kept
flattened as ``[..., kv_heads*head_dim]`` like the JAX package.
``blockwise_attention`` goes through ``kernels.flash_attention.ops`` (the
hand-written CUDA kernel on the card, its plain version on the CPU); the
dense serving path's ``decode_attention`` and ``cache_write`` /
``ring_write`` through the paged-decode and cache-write kernels, over a
dense ``[B, S, kv_dim]`` cache seen as pages.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.cache_write.ops import paged_chunk_write
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention


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
# Decode attention against a dense cache
# ---------------------------------------------------------------------------
DENSE_PAGE = 16          # a dense cache's rows are read as pages of this many


def dense_pages(cache, n_kv_heads: int):
    """A dense cache [B, S, Kh*D] seen as the paged kernels' pool: pages
    [B * S / page, page, Kh, D] (a view, no copy) and the identity block
    table [B, S / page] int32 that gives lane b its own rows in order.
    The page is ``DENSE_PAGE`` rows where that divides S, else one page of
    S rows per lane (the latent kernels at D = 576 refuse such a page, so
    the runner pads its dense caches to a multiple of ``DENSE_PAGE``)."""
    B, S, w = cache.shape
    page = DENSE_PAGE if S % DENSE_PAGE == 0 else max(S, 1)
    n = max(S, 1) // page
    pages = cache.view(B * n, page, n_kv_heads, w // n_kv_heads)
    tables = torch.arange(B * n, dtype=torch.int32,
                          device=cache.device).view(B, n)
    return pages, tables


def decode_attention(q, k_cache, v_cache, cache_len, *, n_kv_heads: int,
                     ring: bool = False, window: int = 0):
    """q: [B, 1, H, D]; caches: [B, S_cache, Kh*D] (keys stored post-RoPE),
    contiguous.  Returns [B, 1, H*D] in q's type.

    ``cache_len`` may be a scalar or a per-request [B] vector; lane b sees
    its first ``min(cache_len[b] + 1, S_cache)`` rows.  ``ring``:
    sliding-window ring buffer, every slot written so far is valid (no
    window mask: the keys hold their RoPE).  A full-length cache with a
    ``window`` sees only the last ``window`` of those rows, as the JAX
    package's mask.  The paged-decode kernel reads the cache where it lies
    through :func:`dense_pages` (its plain version on the CPU); q is cast
    to the cache's type for it."""
    B = q.shape[0]
    S = k_cache.shape[1]
    k_pages, tables = dense_pages(k_cache, n_kv_heads)
    v_pages, _ = dense_pages(v_cache, n_kv_heads)
    lengths = torch.clamp(lengths_vector(cache_len, B, q.device) + 1,
                          max=S).to(torch.int32).contiguous()
    o = paged_attention(q[:, 0].to(k_cache.dtype).contiguous(), k_pages,
                        v_pages, tables, lengths,
                        window=0 if ring else window)
    return o.reshape(B, 1, -1).to(q.dtype)


def cache_write(cache, new, index):
    """Write new [B, T, kv_dim] into cache [B, S, kv_dim] (contiguous) at
    position ``index``: a scalar (T rows each lane) or a per-request [B]
    vector (T must be 1).  One launch of the cache-write kernel on the
    cache seen as a ``[1, 1, B, S, kv_dim]`` pool, row b * S + index[b] +
    t, cast to the cache's type, in place; returns ``cache``.  An index
    past the cache clamps as ``dynamic_update_slice`` does (serving never
    makes one)."""
    B, S, w = cache.shape
    T = new.shape[1]
    if torch.as_tensor(index).ndim and T != 1:
        raise ValueError(f"a per-request index writes one row, got {T}")
    idx = torch.clamp(lengths_vector(index, B, cache.device).long(), 0,
                      S - T)
    slots = (torch.arange(B, device=cache.device)[:, None] * S + idx[:, None]
             + torch.arange(T, device=cache.device)).to(torch.int32)
    paged_chunk_write(cache.view(1, 1, B, S, w), 0,
                      [new.reshape(B, T, w)], slots.contiguous())
    return cache


def ring_write(cache, new, index):
    """Ring-buffer write of a single token at slot index % S."""
    S = cache.shape[1]
    return cache_write(cache, new,
                       torch.as_tensor(index, device=cache.device) % S)


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
