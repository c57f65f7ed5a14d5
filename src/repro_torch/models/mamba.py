"""Mamba-1 (falcon-mamba) and Mamba-2 (zamba2) blocks.

The PyTorch counterpart of ``repro.models.mamba``, op for op: the causal
depthwise conv with a carried prefix, the projections (plain
``torch.matmul``, as the JAX package leaves them to XLA), and the
selective scan, which goes through ``kernels.selective_scan.ops`` (the
hand-written CUDA kernel on the card, its plain version on the CPU) for
prefill chunks and decode steps alike: Mamba-1's per-channel scan, and
for Mamba-2 the same kernel's per-head mode (one dt and one scalar A per
head of ``mamba2_head_dim`` channels, one exponential per step and head).
The recurrent state is f32; the conv prefix stays in the weights' type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import (selective_scan,
                                                   selective_scan_heads)
from repro_torch.models import layers


# ---------------------------------------------------------------------------
# causal depthwise conv (kernel K, unrolled shifts — K is 4)
# ---------------------------------------------------------------------------
def causal_conv(x, w, b, prefix=None, n_valid=None):
    """x: [B, S, C]; w: [K, C]; prefix: [B, K-1, C] carried state or None.

    ``n_valid``: optional [B] count of *valid* leading positions when the
    batch carries right-padded variable-length chunks — the carried prefix
    is then taken at each request's own boundary (the last K-1 real tokens)
    instead of the padded tail.  Valid outputs only read backwards, so they
    are unaffected by the padding.
    """
    K = w.shape[0]
    if prefix is None:
        prefix = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([prefix.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, j:j + S] * w[j] for j in range(K))
    y = y + b
    if K > 1:
        if n_valid is not None:
            # xp rows n_valid[b] .. n_valid[b]+K-2 = real positions
            # n_valid-K+1 .. n_valid-1 (prefix rows fill in when short)
            idx = n_valid.long()[:, None] + torch.arange(K - 1,
                                                         device=x.device)
            new_prefix = torch.gather(
                xp, 1, idx[..., None].expand(-1, -1, xp.shape[2]))
        else:
            new_prefix = xp[:, -(K - 1):].clone()   # do not pin all of xp
    else:
        new_prefix = prefix
    return F.silu(y), new_prefix


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------
def init_mamba1(gen: torch.Generator, cfg, dtype):
    """One Mamba-1 layer in the JAX tree's names and layout; ``norm``,
    ``dt_bias``, ``A_log`` and ``D`` stay f32 as the JAX package keeps
    them."""
    d, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.conv_kernel)
    dev = gen.device

    def dense(shape, scale=None):
        return layers.dense_init(gen, shape, dtype, scale)

    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "norm": torch.zeros((d,), **f32),
        "in_proj": dense((d, 2 * di)),
        "conv_w": dense((K, di), scale=0.5),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense((di, R + 2 * N)),
        "dt_proj": dense((R, di)),
        "dt_bias": torch.full((di,), -4.0, **f32),   # softplus ~= 0.018
        "A_log": torch.log(torch.arange(1, N + 1, **f32)).expand(di, N)
                 .contiguous(),
        "D": torch.ones((di,), **f32),
        "out_proj": dense((di, d)),
    }


def mamba1_seq(p, x, cfg, state=None, conv_prefix=None, mask=None):
    """Full-sequence Mamba-1.  x: [B, S, d] -> (y, (state, conv_prefix)).

    ``mask``: optional [B, S] bool marking valid positions of right-padded
    variable-length chunks.  Padded positions freeze the recurrence
    (dt -> 0: dA = 1, dBx = 0) and the conv prefix is carried from each
    request's own boundary, so the returned state matches running the
    unpadded sequence; padded outputs are garbage the caller discards.
    The state is f32 whatever the weights' type.
    """
    B, S, _ = x.shape
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    n_valid = None if mask is None else mask.sum(dim=1).to(torch.int32)
    xz = x @ p.in_proj
    xin, z = xz.chunk(2, dim=-1)
    xc, conv_prefix = causal_conv(xin, p.conv_w, p.conv_b, conv_prefix,
                                  n_valid)

    proj = xc @ p.x_proj                                   # [B, S, R+2N]
    dt_raw, Bt, Ct = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dt_raw @ p.dt_proj + p.dt_bias.to(dt_raw.dtype))
    if mask is not None:
        dt = dt * mask[..., None].to(dt.dtype)
    A = -torch.exp(p.A_log)                                # [di, N]

    if state is None:
        state = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    y, state = selective_scan(dt.contiguous(), xc.contiguous(), A,
                              Bt.contiguous(), Ct.contiguous(),
                              state.contiguous())
    y = y + p.D * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p.out_proj, (state, conv_prefix)


def mamba1_decode(p, x, cfg, state, conv_prefix):
    """One token.  x: [B, 1, d]."""
    return mamba1_seq(p, x, cfg, state, conv_prefix)


def mamba1_cache_shape(cfg, batch):
    return {
        "state": (batch, cfg.d_inner, cfg.ssm_state),
        "conv": (batch, cfg.conv_kernel - 1, cfg.d_inner),
    }


# ---------------------------------------------------------------------------
# Mamba-2 (SSD with scalar A per head)
# ---------------------------------------------------------------------------
def init_mamba2(gen: torch.Generator, cfg, dtype):
    """One Mamba-2 layer in the JAX tree's names and layout; ``norm``,
    ``dt_bias2``, ``A_log2``, ``D2`` and ``ssm_norm`` stay f32 as the JAX
    package keeps them."""
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.conv_kernel
    H2 = di // cfg.mamba2_head_dim
    conv_dim = di + 2 * N
    dev = gen.device

    def dense(shape, scale=None):
        return layers.dense_init(gen, shape, dtype, scale)

    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "norm": torch.zeros((d,), **f32),
        "in_proj": dense((d, 2 * di)),
        "bc_proj": dense((d, 2 * N)),
        "dtp": dense((d, H2)),
        "conv_w": dense((K, conv_dim), scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias2": torch.full((H2,), -4.0, **f32),
        "A_log2": torch.zeros((H2,), **f32),
        "D2": torch.ones((H2,), **f32),
        "ssm_norm": torch.zeros((di,), **f32),
        "out_proj": dense((di, d)),
    }


def mamba2_seq(p, x, cfg, state=None, conv_prefix=None, mask=None):
    """Full-sequence Mamba-2.  x: [B, S, d] -> (y, (state [B, H, P, N] f32,
    conv_prefix [B, K-1, d_inner + 2N])).  ``mask``: see
    :func:`mamba1_seq` (padded positions freeze the recurrence through
    dt = 0, the conv prefix is carried from each request's boundary).

    Unlike Mamba-1, ``z`` comes first out of ``in_proj``, B, C and dt are
    projected from the block's input (not the conv output), the conv runs
    over ``[xin, B, C]``, the skip ``D2`` is per head, and the gated
    output is RMS-normed over d_inner before ``out_proj``."""
    B, S, _ = x.shape
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.mamba2_head_dim
    H2 = di // P
    n_valid = None if mask is None else mask.sum(dim=1).to(torch.int32)
    z, xin = (x @ p.in_proj).chunk(2, dim=-1)
    bc = x @ p.bc_proj
    dt = F.softplus(x @ p.dtp + p.dt_bias2.to(x.dtype))    # [B, S, H2]
    if mask is not None:
        dt = dt * mask[..., None].to(dt.dtype)
    xbc, conv_prefix = causal_conv(torch.cat([xin, bc], dim=-1), p.conv_w,
                                   p.conv_b, conv_prefix, n_valid)
    xc, Bt, Ct = torch.split(xbc, [di, N, N], dim=-1)
    A = -torch.exp(p.A_log2)                               # [H2]

    if state is None:
        state = torch.zeros((B, H2, P, N), dtype=torch.float32,
                            device=x.device)
    y, state = selective_scan_heads(dt.contiguous(), xc.contiguous(), A,
                                    Bt.contiguous(), Ct.contiguous(),
                                    state.contiguous())
    y = y.view(B, S, H2, P) + p.D2[:, None] * xc.float().view(B, S, H2, P)
    y = y.reshape(B, S, di) * F.silu(z.float())
    y = layers.rmsnorm(y.to(x.dtype), p.ssm_norm, cfg.norm_eps)
    return y @ p.out_proj, (state, conv_prefix)


def mamba2_decode(p, x, cfg, state, conv_prefix):
    """One token.  x: [B, 1, d]."""
    return mamba2_seq(p, x, cfg, state, conv_prefix)


def mamba2_cache_shape(cfg, batch):
    hd = cfg.mamba2_head_dim
    return {
        "state": (batch, cfg.d_inner // hd, hd, cfg.ssm_state),
        "conv": (batch, cfg.conv_kernel - 1,
                 cfg.d_inner + 2 * cfg.ssm_state),
    }
