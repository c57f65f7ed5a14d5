"""Multi-head Latent Attention (DeepSeek-V2): the full-sequence path of
training and the absorbed path over a paged latent pool.

The PyTorch counterpart of ``repro.models.mla``'s ``init_mla``,
``_queries``, ``_latent_kv``, ``mla_full``, ``mla_decode_paged`` and
``mla_chunk_paged``.  ``mla_full`` (training) expands the latent through
``kv_b`` into per-head keys and values and runs flash attention with
queries and keys nope + rope wide (192 for DeepSeek-V2) and values
v_head_dim wide (128).  The serving steps take the *absorbed* path.  The pool stores one row per token, the post-norm
latent ``ckv`` (kv_lora_rank wide) and the rotated shared key ``k_rope``
side by side, R + rope wide (576 for DeepSeek-V2).  Absorbing ``kv_b``'s
key half into the query makes attention exactly 1-KV-head MQA over those
rows: the key of token s is its row, the value is the same row, and the
first R features of the output are the latent context, which ``kv_b``'s
value half lifts to the heads.  So the paged decode and chunked-prefill
kernels serve MLA with ``k_pages is v_pages`` at head dim R + rope.  They
scale scores by 1/sqrt(R + rope); MLA wants 1/sqrt(nope + rope), so the
query is pre-scaled by the ratio.  The dense serving paths
(``mla_decode``, ``mla_chunk``) are not ported (ROADMAP queue 1: dense
fallbacks).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.cache_write.ops import (paged_chunk_write,
                                                 paged_token_write)
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_prefill_attention)
from repro_torch.models import layers
from repro_torch.models.layers import rmsnorm


def init_mla(gen: torch.Generator, cfg, dtype) -> dict:
    """The MLA leaves of one layer, in the JAX tree's names and layout (the
    norm scales zero and f32)."""
    d, H = cfg.d_model, cfg.num_heads
    nope, rope_d, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    dev = gen.device

    def dense(shape):
        return layers.dense_init(gen, shape, dtype)

    p = {"kv_a": dense((d, cfg.kv_lora_rank + rope_d)),
         "kv_norm": torch.zeros((cfg.kv_lora_rank,), device=dev),
         "kv_b": dense((cfg.kv_lora_rank, H * (nope + vd))),
         "wo": dense((H * vd, d))}
    if cfg.q_lora_rank:
        p.update({"q_a": dense((d, cfg.q_lora_rank)),
                  "q_norm": torch.zeros((cfg.q_lora_rank,), device=dev),
                  "q_b": dense((cfg.q_lora_rank, H * (nope + rope_d)))})
    else:
        p["q_b"] = dense((d, H * (nope + rope_d)))
    return p


def _queries(p, x, cfg, positions):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope] rotated)."""
    B, S, _ = x.shape
    nope = cfg.qk_nope_head_dim
    if hasattr(p, "q_a"):
        qh = rmsnorm(x @ p.q_a, p.q_norm, cfg.norm_eps) @ p.q_b
    else:
        qh = x @ p.q_b
    qh = qh.view(B, S, cfg.num_heads, nope + cfg.qk_rope_head_dim)
    q_nope, q_rope = qh[..., :nope], qh[..., nope:]
    return q_nope, layers.rope(q_rope, positions, cfg.rope_theta)


def _latent_kv(p, x, cfg, positions):
    """(ckv [B, S, R] post-norm, k_rope [B, S, rope] rotated)."""
    R = cfg.kv_lora_rank
    ckv_full = x @ p.kv_a
    ckv = rmsnorm(ckv_full[..., :R], p.kv_norm, cfg.norm_eps)
    k_rope = layers.rope(ckv_full[..., None, R:], positions,
                         cfg.rope_theta)[..., 0, :]
    return ckv, k_rope


def _latent_rows(p, x, cfg, positions):
    """The pool rows of x's tokens: [post-norm ckv, rotated k_rope],
    [B, S, R + rope]."""
    return torch.cat(_latent_kv(p, x, cfg, positions), dim=-1)


def mla_full(p, x, cfg, positions):
    """The uncompressed path of training over all S positions of x [B, S,
    d]: ``kv_b`` lifts the latent to per-head k_nope and v, the shared
    k_rope is broadcast over the heads, and causal flash attention runs
    with queries and keys nope + rope wide and values v_head_dim wide.
    Returns (out [B, S, d], (ckv [B, S, R], k_rope [B, S, rope]))."""
    B, S, _ = x.shape
    H, nope, rope_d, vd = (cfg.num_heads, cfg.qk_nope_head_dim,
                           cfg.qk_rope_head_dim, cfg.v_head_dim)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    ckv, k_rope = _latent_kv(p, x, cfg, positions)
    kv = (ckv @ p.kv_b).view(B, S, H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope_d)],
                  dim=-1)
    o = layers.blockwise_attention(q, k, v, causal=True)
    return o.reshape(B, S, H * vd) @ p.wo, (ckv, k_rope)


def _absorbed_query(p, q_nope, q_rope, cfg):
    """[..., H, R + rope] f32 query over the latent rows: q_nope through
    kv_b's key half, then q_rope, pre-scaled for the kernels'
    1/sqrt(R + rope)."""
    R, H, nope = cfg.kv_lora_rank, cfg.num_heads, cfg.qk_nope_head_dim
    rope_d = cfg.qk_rope_head_dim
    w_uk = p.kv_b.view(R, H, nope + cfg.v_head_dim)[..., :nope]
    q_lat = torch.einsum("...hn,rhn->...hr", q_nope.float(), w_uk.float())
    q_cat = torch.cat([q_lat, q_rope.float()], dim=-1)
    return q_cat * (math.sqrt(R + rope_d) / math.sqrt(nope + rope_d))


def _lift(p, ctx, cfg, x):
    """Latent context (the first R output features) through kv_b's value
    half and wo: [..., H, R + rope] -> [..., d]."""
    R, H, nope = cfg.kv_lora_rank, cfg.num_heads, cfg.qk_nope_head_dim
    w_uv = p.kv_b.view(R, H, nope + cfg.v_head_dim)[..., nope:]
    o = torch.einsum("...hr,rhv->...hv", ctx[..., :R].float(), w_uv.float())
    return o.flatten(-2).to(x.dtype) @ p.wo


def _pages(data, layer, cfg):
    NB, bs = data.shape[2], data.shape[3]
    return data[0, layer].view(NB, bs, 1,
                               cfg.kv_lora_rank + cfg.qk_rope_head_dim)


def mla_decode_paged(p, x, cfg, data, layer, tables, slots, lens, *,
                     scratch=None):
    """Absorbed MLA decode over the paged latent pool.

    x: [B, 1, d]; data: [1, L_mla, NB, bs, R + rope], written in place;
    tables: [B, P]; slots: [B]; lens: [B] tokens already cached;
    ``scratch``: the scratch block's first slot (see
    ``paged_token_write``).  Returns (out [B, 1, d], data)."""
    B = x.shape[0]
    pos = layers.lengths_vector(lens, B, x.device)[:, None]
    q_nope, q_rope = _queries(p, x, cfg, pos)
    rows = _latent_rows(p, x, cfg, pos)[:, 0]
    paged_token_write(data, layer, rows.to(data.dtype)[None], slots,
                      scratch=scratch)
    pages = _pages(data, layer, cfg)
    q = _absorbed_query(p, q_nope[:, 0], q_rope[:, 0], cfg)
    ctx = paged_attention(q.to(pages.dtype), pages, pages, tables, lens + 1)
    return _lift(p, ctx, cfg, x)[:, None], data


def mla_chunk_paged(p, x, cfg, data, layer, tables, slots, ctx_lens, *,
                    scratch=None):
    """Chunked-prefill MLA over the paged latent pool: the chunk's rows are
    written with one launch, then the chunked paged-attention kernel runs
    as 1-head MQA, chunk-causal.

    x: [B, C, d]; slots: [B, C] (padded positions point at scratch);
    ctx_lens: [B] tokens cached before the chunk.  Returns (out [B, C, d],
    data)."""
    B, C, _ = x.shape
    pos = ctx_lens[:, None] + torch.arange(C, device=x.device,
                                           dtype=ctx_lens.dtype)
    q_nope, q_rope = _queries(p, x, cfg, pos)
    rows = _latent_rows(p, x, cfg, pos)
    paged_chunk_write(data, layer, rows.to(data.dtype)[None], slots,
                      scratch=scratch)
    pages = _pages(data, layer, cfg)
    q = _absorbed_query(p, q_nope, q_rope, cfg)
    ctx = paged_prefill_attention(q.to(pages.dtype), pages, pages, tables,
                                  ctx_lens)
    return _lift(p, ctx, cfg, x), data
