"""The decoder's serving path over device-resident paged caches.

The PyTorch counterpart of the paged serving steps of
``repro.models.model``: ``init_params``, ``encode_media``,
``decode_step_paged``, ``prefill_chunk_paged`` and ``sample_from_logits``,
with the same arguments and control tensors so the tests can feed both
packages identical inputs.  Pools are updated in place by the cache-write
kernel (the JAX package donates them instead); the functions still return
them so the call shapes match.

Four families are covered: dense attention + MLP layers (``ATTN_MLP``)
with an optional vision frontend, the LLaVA family the paper evaluates;
the encoder-decoder whisper family (``ATTN_MLP`` decoder layers with
cross-attention, an audio encoder as the encode stage, sinusoidal
positions), whose encoder output and per-layer cross K/V travel in the
step's ``state`` argument; attention-free Mamba-1 models (``MAMBA1``,
falcon-mamba), whose per-request recurrent state travels there too; the
MoE family: attention + MoE FFN (``ATTN_MOE``, granite-moe) and
DeepSeek-V2's latent attention (``MLA_MLP``/``MLA_MOE``), whose layers
read and write a second page pool, ``"mla"``, of latent rows; and the
zamba2 hybrid: Mamba-2 layers (``MAMBA2``, their state in ``state`` as
Mamba-1's) and ``SHARED_ATTN`` layers, each of which runs the one
attention + MLP block ``params.shared`` after its own norm, over its own
plane of the KV pool.  A Mamba model with a media frontend raises
``NotImplementedError`` (ROADMAP, queue 1: other families).
Training runs the full-sequence :func:`forward` (``repro.models.model``'s
``forward`` with its ``_embed``, ``_block_full``, ``_attn_full`` and
``_cross_full``) over every layer kind: attention + MLP or MoE layers
(the MoE FFN's capacity-dropping path and its load-balance loss), MLA +
MLP or MoE (``mla.mla_full``, queries and keys 192 wide and values 128
for DeepSeek-V2), Mamba-1 and Mamba-2 layers and shared attention, with
the vision projector or the audio encoder in front; its attention goes
through the flash kernel and its gradient at every width the configs
have, the scans through the selective-scan kernels and theirs.
The host-cache fallback serves over dense per-layer caches instead of
pages, as the JAX package's ``prefill``, ``init_cache``,
``build_cache_from_prefill``, ``decode_step``, ``prefill_chunk``,
``empty_prior`` and ``extend_prior``: a decode step writes each layer's
new K/V (or latent row) into its ``[B, S, w]`` cache with the cache-write
kernel and attends through the paged-decode kernel over that cache seen
as pages (``layers.decode_attention``, ``mla.mla_decode``); a prefill
chunk attends over concat(prefix, chunk) through the flash kernel with
``kv_offset`` (``mla.mla_chunk`` for MLA), Mamba layers through the scan.
An MLA layer's dense cache is one ``{"lat": [B, S, R + rope]}`` tensor,
the latent pool's row layout, where the JAX package keeps ``ckv`` and
``krope`` apart.
Under a mesh (``models/sharding.py``) :func:`forward`, :func:`prefill`,
:func:`init_cache`, :func:`build_cache_from_prefill` and
:func:`decode_step` run on each rank's cut of the weights
(``sharding.shard_params``) and its rows of the batch: attention on the
rank's query heads and the KV heads they read (the flash, decode and
cache-write kernels at the local head counts), the MLP on its span of
the FFN width, the MoE FFN on its experts, Mamba-1 on its channels, the
embedding and the logits on its span of the vocabulary, each followed by
an ``all_reduce`` over ``model`` (``sharding.row_parallel``,
``vocab_embed``, ``vocab_logits``); activations between layers are
replicated.  Attention + MLP or MoE layers and Mamba-1 layers, with or
without the vision projector, run under a mesh; other families, the
chunked and paged steps raise there (ROADMAP queue 1 item 16).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_MLP, ATTN_MOE, MAMBA1, MAMBA2,
                                      MLA_MLP, MLA_MOE, SHARED_ATTN,
                                      ModelConfig)
from repro_torch.kernels.cache_write.ops import (paged_chunk_write,
                                                 paged_token_write)
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_prefill_attention)
from repro_torch.models import layers, mamba, mla, moe
from repro_torch.models import sharding as SH
from repro_torch.models.layers import rmsnorm
from repro_torch.params import ParamTree


def check_supported(cfg: ModelConfig):
    """Raise for what this slice of the port does not cover yet."""
    kinds = set(cfg.layer_kinds())
    other = sorted(kinds - {ATTN_MLP, ATTN_MOE, MLA_MLP, MLA_MOE, MAMBA1,
                            MAMBA2, SHARED_ATTN})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {other} are not ported yet "
            f"(ROADMAP queue 1: other families)")
    mamba_kinds = sorted(kinds & {MAMBA1, MAMBA2})
    if mamba_kinds and cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: {mamba_kinds} layers with a {cfg.frontend!r} "
            f"frontend are not ported yet (ROADMAP queue 1: other "
            f"families)")
    if cfg.frontend not in ("none", "vision", "audio") or \
            (cfg.frontend == "audio") != cfg.cross_attention:
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} with cross_attention="
            f"{cfg.cross_attention} is not ported yet (ROADMAP queue 1: "
            f"other families)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32, trainable: bool = False) -> ParamTree:
    """Random weights drawn from ``gen`` on its device, in the JAX
    package's tree and layout (norm scales zero-initialised in f32).  The
    draws differ from ``jax.random``; parity tests convert the JAX tree
    with :func:`repro_torch.params.params_from_numpy` instead.
    ``trainable``: every leaf requires grad (training); serving keeps them
    frozen."""
    check_supported(cfg)
    d, H, Kh, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def dense(shape, scale=None):
        return layers.dense_init(gen, shape, dtype, scale)

    def attn(cross: bool) -> dict:
        p = {"norm1": zeros(d), "wq": dense((d, H * Dh)),
             "wk": dense((d, Kh * Dh)), "wv": dense((d, Kh * Dh)),
             "wo": dense((H * Dh, d)), "norm2": zeros(d)}
        if cross:
            p.update({"xnorm": zeros(d), "xq": dense((d, H * Dh)),
                      "xk": dense((d, Kh * Dh)), "xv": dense((d, Kh * Dh)),
                      "xo": dense((H * Dh, d))})
        return p

    def mlp() -> dict:
        p = {} if cfg.act == "gelu_mlp" else {"w_gate": dense((d, cfg.d_ff))}
        p["w_up"] = dense((d, cfg.d_ff))
        p["w_down"] = dense((cfg.d_ff, d))
        return p

    def layer(kind) -> dict:
        """``repro.models.model._init_layer``'s tree for one layer."""
        if kind == MAMBA1:
            return mamba.init_mamba1(gen, cfg, dtype)
        if kind == MAMBA2:
            return mamba.init_mamba2(gen, cfg, dtype)
        if kind == SHARED_ATTN:
            return {"norm": zeros(d)}
        if kind in (MLA_MLP, MLA_MOE):
            p = {"norm1": zeros(d), "norm2": zeros(d),
                 **mla.init_mla(gen, cfg, dtype)}
        else:
            p = attn(cfg.cross_attention)
        p.update(moe.init_moe(gen, cfg, dtype) if kind in (ATTN_MOE, MLA_MOE)
                 else mlp())
        return p

    tree = {"embed": dense((cfg.vocab_size, d), scale=0.02),
            "final_norm": zeros(d),
            "layers": [layer(kind) for kind in cfg.layer_kinds()]}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense((d, cfg.vocab_size), scale=0.02)
    if SHARED_ATTN in cfg.layer_kinds():
        tree["shared"] = attn(False) | mlp()
    if cfg.frontend == "vision":
        tree["media_proj_w1"] = dense((d, 2 * d))
        tree["media_proj_w2"] = dense((2 * d, d))
    if cfg.encoder_layers:
        tree["encoder"] = {"layers": [attn(False) | mlp()
                                      for _ in range(cfg.encoder_layers)],
                           "norm": zeros(d)}
    return ParamTree(tree, trainable)


class _MetaDraws(torch.Generator):
    """A generator whose draws land on the meta device: shapes and types,
    no data."""
    device = torch.device("meta")


def param_specs(cfg: ModelConfig, dtype=torch.bfloat16) -> ParamTree:
    """The param tree's shapes and types, as :func:`init_params` makes
    them, on the meta device (no memory at any size)."""
    return init_params(cfg, _MetaDraws(), dtype)


# ---------------------------------------------------------------------------
# encode stage / logits
# ---------------------------------------------------------------------------
def _attn_full(p, x, cfg, positions, window, causal=True):
    """Self-attention over all S positions of x [B, S, d] through the
    flash-attention kernel (RoPE at ``positions`` [S] when the model has
    it).  Returns (out [B, S, d], (k, v) [B, S, Kh*Dh])."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    o = layers.blockwise_attention(q, k, v, causal=causal, window=window)
    return SH.row_parallel(o.reshape(B, S, -1), p.wo), \
        (k.reshape(B, S, -1), v.reshape(B, S, -1))


def encode_media(cfg, params, media):
    """The encode-stage computation: the vision projector, or the audio
    encoder (sinusoidal positions, non-causal self-attention + MLP blocks,
    a final norm) over precomputed frame embeddings [B, T, d]."""
    if cfg.frontend == "vision":
        w1 = params.media_proj_w1
        h = torch.nn.functional.gelu(media.to(w1.dtype) @ w1,
                                     approximate="tanh")
        return SH.row_parallel(h, params.media_proj_w2)
    if cfg.frontend == "audio":
        enc = params.encoder
        dtype = params.embed.dtype          # the weights' type
        T = media.shape[1]
        pos = torch.arange(T, device=media.device)
        h = media.to(dtype) + layers.sinusoidal_positions(pos, cfg.d_model,
                                                          dtype)
        for lp in enc.layers:
            h = h + _attn_full(lp, rmsnorm(h, lp.norm1, cfg.norm_eps), cfg,
                               pos, window=0, causal=False)[0]
            h = h + layers.mlp(lp, rmsnorm(h, lp.norm2, cfg.norm_eps),
                               cfg.act)
        return rmsnorm(h, enc.norm, cfg.norm_eps)
    check_supported(cfg)
    return media


def _logits(cfg, params, h):
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return SH.vocab_logits(h, w, cfg.vocab_size)


# ---------------------------------------------------------------------------
# full-sequence forward (training)
# ---------------------------------------------------------------------------
def _embed(cfg, params, tokens, media_emb, positions):
    """Token embeddings [B, S, d], after the media embeddings when given,
    plus sinusoidal positions for models without RoPE (whisper)."""
    h = SH.vocab_embed(params.embed, tokens, cfg.vocab_size)
    if media_emb is not None:
        h = torch.cat([media_emb.to(h.dtype), h], dim=1)
    if not cfg.rope_theta:
        h = h + layers.sinusoidal_positions(positions, cfg.d_model, h.dtype)
    return h


def _block_full(cfg, kind, p, shared, h, positions, enc_out, window,
                collect_cache):
    """One block over the full sequence, as the reference's
    ``_block_full``.  Returns (h, cache entry, aux loss): Mamba layers'
    {"state", "conv"}, shared-attention and attention layers' {"k", "v"}
    (and {"xk", "xv"} with cross-attention), MLA layers' {"ckv", "krope"}
    with ``collect_cache``; the MoE FFN's load-balance loss (its
    capacity-dropping training path), 0.0 without MoE."""
    cache, aux = {}, 0.0
    if kind in (MAMBA1, MAMBA2):
        fn = mamba.mamba1_seq if kind == MAMBA1 else mamba.mamba2_seq
        y, (state, conv) = fn(p, rmsnorm(h, p.norm, cfg.norm_eps), cfg)
        h = h + y
        if collect_cache:
            cache = {"state": state, "conv": conv}
        return h, cache, aux
    if kind == SHARED_ATTN:
        a, (k, v) = _attn_full(shared, rmsnorm(h, p.norm, cfg.norm_eps), cfg,
                               positions, window=0)
        h = h + a
        h = h + layers.mlp(shared, rmsnorm(h, shared.norm2, cfg.norm_eps),
                           cfg.act)
        if collect_cache:
            cache = {"k": k, "v": v}
        return h, cache, aux
    if kind in (MLA_MLP, MLA_MOE):
        a, (ckv, krope) = mla.mla_full(p, rmsnorm(h, p.norm1, cfg.norm_eps),
                                       cfg, positions)
        h = h + a
        if collect_cache:
            cache = {"ckv": ckv, "krope": krope}
    else:
        a, (k, v) = _attn_full(p, rmsnorm(h, p.norm1, cfg.norm_eps), cfg,
                               positions, window)
        h = h + a
        if collect_cache:
            cache = {"k": k, "v": v}
    if cfg.cross_attention:
        # the reference's _cross_full: the same function as a chunk's
        c, (xk, xv) = _cross_chunk(p, rmsnorm(h, p.xnorm, cfg.norm_eps),
                                   enc_out, cfg)
        h = h + c
        if collect_cache:
            cache.update({"xk": xk, "xv": xv})
    x = rmsnorm(h, p.norm2, cfg.norm_eps)
    if kind in (ATTN_MOE, MLA_MOE):
        f, aux = moe.moe_ffn(p, x, cfg, lossless=False)
    else:
        f = layers.mlp(p, x, cfg.act)
    return h + f, cache, aux


def forward(cfg: ModelConfig, params, tokens, media=None, frames=None, *,
            remat: bool = False, collect_cache: bool = False):
    """Full-sequence logits: returns (logits [B, S_total, V], caches or
    None, aux loss), as ``repro.models.model.forward``.  ``media`` [B, T,
    d] goes through the vision projector and before the tokens; ``frames``
    [B, T, d] through the audio encoder, for cross-attention.  ``remat``
    recomputes each block in the backward (``torch.utils.checkpoint``,
    non-reentrant), which changes no number.  Takes every layer kind:
    attention or MLA + MLP or MoE, Mamba-1 and Mamba-2 layers and shared
    attention.  Under a mesh: the rank's rows of the batch, on its cut of
    the weights (see the module's docstring); logits and aux loss are the
    rank's rows of the unsharded ones."""
    check_supported(cfg)
    SH.check_model(cfg, params, media, frames)
    enc_out = encode_media(cfg, params, frames) if frames is not None \
        else None
    media_emb = encode_media(cfg, params, media) if media is not None \
        else None
    S_total = tokens.shape[1] + (0 if media_emb is None
                                 else media_emb.shape[1])
    positions = torch.arange(S_total, device=tokens.device)
    h = _embed(cfg, params, tokens, media_emb, positions)
    shared = getattr(params, "shared", None)
    caches, aux_total = [], 0.0
    for i, kind in enumerate(cfg.layer_kinds()):
        window = cfg.sliding_window if cfg.is_local_layer(i) else 0
        args = (cfg, kind, params.layers[i], shared, h, positions, enc_out,
                window, collect_cache)
        h, cache, aux = checkpoint(_block_full, *args, use_reentrant=False) \
            if remat else _block_full(*args)
        aux_total = aux_total + aux
        caches.append(cache)
    return _logits(cfg, params, h), (caches if collect_cache else None), \
        aux_total


def prefill(cfg: ModelConfig, params, tokens, media=None, frames=None):
    """Serving prefill: (last-token logits [B, V], {"layers": per-layer
    cache entries of :func:`forward`}), the JAX package's ``prefill``."""
    logits, caches, _ = forward(cfg, params, tokens, media=media,
                                frames=frames, collect_cache=True)
    return logits[:, -1], {"layers": caches}


# ---------------------------------------------------------------------------
# dense caches (the host-cache fallback's decode and chunked prefill)
# ---------------------------------------------------------------------------
def _lat_width(cfg) -> int:
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def _layer_cache_shape(cfg, kind, i, batch, max_len):
    """The JAX package's dense cache shapes of layer i, except that an MLA
    layer keeps its rows in one {"lat": [B, S, R + rope]} tensor (``ckv``
    and ``k_rope`` side by side, as the latent pool stores them)."""
    if kind in (MAMBA1, MAMBA2):
        return (mamba.mamba1_cache_shape if kind == MAMBA1
                else mamba.mamba2_cache_shape)(cfg, batch)
    if kind in (MLA_MLP, MLA_MOE):
        return {"lat": (batch, max_len, _lat_width(cfg))}
    S_c = max_len
    if cfg.is_local_layer(i) and cfg.sliding_window:
        S_c = min(max_len, cfg.sliding_window)
    kvd = cfg.num_kv_heads * cfg.head_dim
    ent = {"k": (batch, S_c, kvd), "v": (batch, S_c, kvd)}
    if cfg.cross_attention and kind in (ATTN_MLP, ATTN_MOE):
        ent["xk"] = (batch, cfg.media_tokens, kvd)
        ent["xv"] = (batch, cfg.media_tokens, kvd)
    return ent


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cpu") -> dict:
    """Zero dense caches {"layers": [...]} (Mamba states in f32); under a
    mesh this rank's: its KV heads' columns, its Mamba channels."""
    SH.check_model(cfg)
    cfg = SH.local_cfg(cfg)
    out = []
    for i, kind in enumerate(cfg.layer_kinds()):
        out.append({name: torch.zeros(
            shape, dtype=torch.float32 if name == "state" else dtype,
            device=device)
            for name, shape in _layer_cache_shape(cfg, kind, i, batch,
                                                  max_len).items()})
    return {"layers": out}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> dict:
    """:func:`init_cache`'s shapes and types on the meta device."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def cache_pspecs(cfg: ModelConfig, layout: str = "kvdim") -> dict:
    """Partition specs of the dense cache tree, as the JAX package's
    ``cache_pspecs``: tuples of mesh axes a dim, ``"dp"`` the data axes.
    ``"kvdim"`` shards the flattened KV width over ``model`` (the rank's
    KV heads, the layout the sharded steps run); ``"seq"`` shards the
    sequence of K, V and latent rows over ``model``, specs only in this
    slice.  An MLA layer's ``lat`` takes the spec of the JAX package's
    ``ckv`` and ``krope``."""
    def leaf_spec(name, ndim):
        if name in ("k", "v", "xk", "xv", "conv"):
            if layout == "seq" and name in ("k", "v"):
                return ("dp", "model", None)
            return ("dp", None, "model")
        if name == "lat" and layout == "seq":
            return ("dp", "model", None)
        if name == "state":
            return ("dp", "model") + (None,) * (ndim - 2)
        return ("dp",) + (None,) * (ndim - 1)

    return {"layers": [
        {name: leaf_spec(name, len(s)) for name, s in
         _layer_cache_shape(cfg, kind, i, batch=1, max_len=2).items()}
        for i, kind in enumerate(cfg.layer_kinds())]}


def build_cache_from_prefill(cfg: ModelConfig, prefill_cache, max_len: int):
    """Pad/arrange :func:`prefill`'s per-layer entries into fixed-size decode
    caches: sequence entries padded with zeros to ``max_len`` rows, a
    sliding-window layer's to its window, and one that already holds more
    rows keeps its last S_c at slot ``pos % S_c`` (the ring's roll).  MLA
    layers' ``ckv``/``krope`` become one ``lat`` tensor."""
    out = []
    for i, (kind, ent) in enumerate(zip(cfg.layer_kinds(),
                                        prefill_cache["layers"])):
        if kind in (MAMBA1, MAMBA2):
            out.append(ent)
            continue
        if kind in (MLA_MLP, MLA_MOE):
            ent = {"lat": torch.cat([ent["ckv"], ent["krope"]], dim=-1)}
        new = {}
        for name, arr in ent.items():
            if name in ("xk", "xv"):
                new[name] = arr
                continue
            S = arr.shape[1]
            S_c = max_len
            if name in ("k", "v") and cfg.is_local_layer(i) \
                    and cfg.sliding_window:
                S_c = min(max_len, cfg.sliding_window)
            if S >= S_c:
                new[name] = torch.roll(arr[:, S - S_c:], S % S_c,
                                       dims=1).contiguous()
            else:
                pad = arr.new_zeros((arr.shape[0], S_c - S) + arr.shape[2:])
                new[name] = torch.cat([arr, pad], dim=1)
        out.append(new)
    return {"layers": out}


def _attn_decode(p, x, cfg, ent, cache_len, window):
    """One token per lane against the layer's dense K/V cache: the new
    token's K/V written at ``cache_len`` (a ring buffer's at cache_len %
    S_c, when the cache is no longer than the window) by the cache-write
    kernel, then decode attention over the cache.  Returns out [B, 1, d];
    the cache is updated in place."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg, layers.lengths_vector(cache_len, B,
                                                    x.device)[:, None])
    Kh, Dh = k.shape[2], cfg.head_dim       # the rank's KV heads
    ring = bool(window) and ent["k"].shape[1] <= window
    write = layers.ring_write if ring else layers.cache_write
    write(ent["k"], k.reshape(B, 1, Kh * Dh), cache_len)
    write(ent["v"], v.reshape(B, 1, Kh * Dh), cache_len)
    o = layers.decode_attention(q, ent["k"], ent["v"], cache_len,
                                n_kv_heads=Kh, ring=ring, window=window)
    return SH.row_parallel(o, p.wo)


def decode_step(cfg: ModelConfig, params, cache, cache_len, token):
    """One decode step over dense caches (see :func:`init_cache`).  token:
    [B, 1]; cache_len: scalar or [B] tokens already cached.  Returns
    (logits [B, V], cache), the caches written in place (the JAX package
    returns new ones).  Under a mesh: the rank's lanes and caches."""
    SH.check_model(cfg, params)
    B = token.shape[0]
    h = _positions(cfg, SH.vocab_embed(params.embed, token, cfg.vocab_size),
                   layers.lengths_vector(cache_len, B, token.device)[:, None])
    for i, kind in enumerate(cfg.layer_kinds()):
        p = params.layers[i]
        ent = cache["layers"][i]
        if kind in (MAMBA1, MAMBA2):
            fn = mamba.mamba1_decode if kind == MAMBA1 \
                else mamba.mamba2_decode
            y, (st, conv) = fn(p, rmsnorm(h, p.norm, cfg.norm_eps), cfg,
                               ent["state"], ent["conv"])
            h = h + y
            ent.update(state=st, conv=conv)
            continue
        if kind == SHARED_ATTN:
            sp = params.shared
            h = h + _attn_decode(sp, rmsnorm(h, p.norm, cfg.norm_eps), cfg,
                                 ent, cache_len, 0)
            h = h + layers.mlp(sp, rmsnorm(h, sp.norm2, cfg.norm_eps),
                               cfg.act)
            continue
        x = rmsnorm(h, p.norm1, cfg.norm_eps)
        if kind in (MLA_MLP, MLA_MOE):
            a, _ = mla.mla_decode(p, x, cfg, ent["lat"], cache_len)
        else:
            window = cfg.sliding_window if cfg.is_local_layer(i) else 0
            a = _attn_decode(p, x, cfg, ent, cache_len, window)
        h = h + a
        if cfg.cross_attention:
            h = h + _cross_decode(p, rmsnorm(h, p.xnorm, cfg.norm_eps), cfg,
                                  ent)
        h = h + _ffn(p, rmsnorm(h, p.norm2, cfg.norm_eps), cfg, kind)
    return _logits(cfg, params, h[:, 0]), cache


def _attn_chunk(p, x, cfg, prior_k, prior_v, offset, window):
    """A prefill chunk x [B, C, d] at positions offset.. over its dense
    prefix prior_k/v [B, P, Kh*Dh] and itself: causal flash attention over
    concat(prefix, chunk) with ``kv_offset`` P.  Returns (out, (k, v) of
    the chunk [B, C, Kh*Dh])."""
    B, C, _ = x.shape
    Kh, Dh = cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, offset + torch.arange(C, device=x.device))
    P_len = prior_k.shape[1]
    k_full = torch.cat([prior_k.view(B, P_len, Kh, Dh).to(k.dtype), k], 1)
    v_full = torch.cat([prior_v.view(B, P_len, Kh, Dh).to(v.dtype), v], 1)
    o = layers.blockwise_attention(q, k_full, v_full, causal=True,
                                   window=window, kv_offset=P_len)
    return o.reshape(B, C, -1) @ p.wo, (k.reshape(B, C, Kh * Dh),
                                        v.reshape(B, C, Kh * Dh))


def prefill_chunk(cfg: ModelConfig, params, tokens, prior, offset, *,
                  enc_out=None, media_emb=None):
    """One prefill chunk against a dense cache prefix, the JAX package's
    ``prefill_chunk``.  tokens: [B, C] (None for a pure media chunk);
    media_emb [B, T, d] goes first; ``prior``: {"layers": per-layer
    prefix entries} of ``offset`` tokens (see :func:`empty_prior`),
    Mamba layers' {"state", "conv"} (None before the first chunk), a
    cross-attention layer's {"xk", "xv"} once a chunk has made them.
    Returns (last-token logits [B, V], {"layers": the chunk's entries to
    append, new Mamba states, and on the first chunk the cross K/V made
    from ``enc_out``})."""
    SH.refuse("prefill_chunk")
    if media_emb is not None:
        h = media_emb.to(params.embed.dtype)
        if tokens is not None:
            h = torch.cat([h, params.embed[tokens.long()]], dim=1)
    else:
        h = params.embed[tokens.long()]
    C = h.shape[1]
    h = _positions(cfg, h, offset + torch.arange(C, device=h.device)
                   .expand(h.shape[0], C))
    out = []
    for i, kind in enumerate(cfg.layer_kinds()):
        p = params.layers[i]
        ent = prior["layers"][i]
        if kind in (MAMBA1, MAMBA2):
            fn = mamba.mamba1_seq if kind == MAMBA1 else mamba.mamba2_seq
            y, (st, conv) = fn(p, rmsnorm(h, p.norm, cfg.norm_eps), cfg,
                               ent.get("state"), ent.get("conv"))
            h = h + y
            out.append({"state": st, "conv": conv})
            continue
        if kind == SHARED_ATTN:
            sp = params.shared
            a, (k, v) = _attn_chunk(sp, rmsnorm(h, p.norm, cfg.norm_eps),
                                    cfg, ent["k"], ent["v"], offset, 0)
            h = h + a
            h = h + layers.mlp(sp, rmsnorm(h, sp.norm2, cfg.norm_eps),
                               cfg.act)
            out.append({"k": k, "v": v})
            continue
        x = rmsnorm(h, p.norm1, cfg.norm_eps)
        if kind in (MLA_MLP, MLA_MOE):
            a, lat = mla.mla_chunk(p, x, cfg, ent["lat"], offset)
            new = {"lat": lat}
        else:
            window = cfg.sliding_window if cfg.is_local_layer(i) else 0
            a, (k, v) = _attn_chunk(p, x, cfg, ent["k"], ent["v"], offset,
                                    window)
            new = {"k": k, "v": v}
        h = h + a
        if cfg.cross_attention:
            x = rmsnorm(h, p.xnorm, cfg.norm_eps)
            if ent.get("xk") is not None:
                h = h + _cross_decode(p, x, cfg, ent)
            else:
                c, (xk, xv) = _cross_chunk(p, x, enc_out, cfg)
                h = h + c
                new.update(xk=xk, xv=xv)
        h = h + _ffn(p, rmsnorm(h, p.norm2, cfg.norm_eps), cfg, kind,
                     lossless=False)
        out.append(new)
    return _logits(cfg, params, h[:, -1]), {"layers": out}


def empty_prior(cfg: ModelConfig, batch: int, dtype=torch.float32,
                device="cpu") -> dict:
    """Zero-length cache prefix for the first prefill chunk."""
    out = []
    kvd = cfg.num_kv_heads * cfg.head_dim
    for kind in cfg.layer_kinds():
        if kind in (MAMBA1, MAMBA2):
            out.append({"state": None, "conv": None})
        elif kind in (MLA_MLP, MLA_MOE):
            out.append({"lat": torch.zeros((batch, 0, _lat_width(cfg)),
                                           dtype=dtype, device=device)})
        else:
            out.append({n: torch.zeros((batch, 0, kvd), dtype=dtype,
                                       device=device) for n in ("k", "v")})
    return {"layers": out}


def extend_prior(cfg: ModelConfig, prior, chunk_entries) -> dict:
    """Append a chunk's cache entries onto the prefix: sequence entries
    concatenate, Mamba states and cross K/V are replaced (the cross K/V
    kept from the prefix when the chunk made none)."""
    out = []
    for kind, old, new in zip(cfg.layer_kinds(), prior["layers"],
                              chunk_entries["layers"]):
        if kind in (MAMBA1, MAMBA2):
            out.append(new)
            continue
        ent = {}
        for name in old.keys() | new.keys():
            if name in ("xk", "xv"):
                ent[name] = new.get(name, old.get(name))
            else:
                ent[name] = torch.cat([old[name].to(new[name].dtype),
                                       new[name]], dim=1)
        out.append(ent)
    return {"layers": out}


# ---------------------------------------------------------------------------
# on-device sampling (DESIGN.md §13)
# ---------------------------------------------------------------------------
def gumbel_noise(seed, step, V: int, device) -> torch.Tensor:
    """[B, V] Gumbel noise, lane b drawn from a generator seeded with
    (seed[b], step[b]): a pure function of the request seed and the token
    index, whatever the batch.  The bits differ from ``jax.random``'s."""
    out = torch.empty((len(seed), V), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for b, (s, t) in enumerate(zip(seed, step)):
        g = torch.Generator(device=device)
        g.manual_seed((int(s) & 0xFFFFFFFF) << 32 | (int(t) & 0xFFFFFFFF))
        u = torch.rand((V,), generator=g, device=device).clamp_(min=tiny)
        out[b] = -torch.log(-torch.log(u))
    return out


def sample_from_logits(logits, sample, noise=None):
    """Batched categorical sampling with per-lane controls.

    ``sample``: {"temp": [B] f32, "top_k": [B] i32 (<=0 disables),
    "top_p": [B] f32, "seed": [B], "step": [B]}.  The seeds and steps may
    be host arrays; they only seed :func:`gumbel_noise`.  ``noise`` [B, V]
    replaces that draw (the tests feed both packages the same noise).
    Lanes with ``temp <= 0`` return the plain argmax (the first maximum,
    as ``jnp.argmax``).
    """
    temp = sample["temp"]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.float()
    V = lg.shape[-1]
    lg = lg / torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
    # top-k: drop logits below each lane's k-th largest (k <= 0 disables)
    k = sample["top_k"]
    k_eff = torch.clamp(torch.where(k > 0, k, torch.full_like(k, V)), 1, V)
    srt = torch.sort(lg, dim=-1, descending=True).values
    kth = srt.gather(-1, (k_eff - 1).long()[:, None])
    lg = lg.masked_fill(lg < kth, float("-inf"))
    # top-p (nucleus): keep the smallest prefix of the descending
    # distribution whose mass reaches p; ties at the boundary stay in
    p = torch.clamp(sample["top_p"], min=1e-6)
    probs = torch.softmax(lg, dim=-1)
    srt_p = torch.sort(probs, dim=-1, descending=True).values
    keep = (torch.cumsum(srt_p, dim=-1) - srt_p) < p[:, None]
    pmin = torch.where(keep, srt_p, torch.full_like(srt_p, float("inf")))
    pmin = pmin.min(dim=-1).values
    lg = torch.where(probs >= pmin[:, None], lg,
                     torch.full_like(lg, float("-inf")))
    if noise is None:
        noise = gumbel_noise(sample["seed"], sample["step"], V, lg.device)
    sampled = torch.argmax(lg + noise, dim=-1).to(torch.int32)
    return torch.where(temp <= 0, greedy, sampled)


# ---------------------------------------------------------------------------
# decode over device-resident paged caches (DESIGN.md §11)
# ---------------------------------------------------------------------------
def _qkv(p, x, cfg, pos):
    """Projected q [B, S, H, Dh] and k/v [B, S, Kh, Dh], rotated when the
    model uses RoPE (whisper adds sinusoidal positions to h instead)."""
    B, S, _ = x.shape
    Dh = cfg.head_dim           # head counts from the (rank's) weights
    q = (x @ p.wq).view(B, S, -1, Dh)
    k = (x @ p.wk).view(B, S, -1, Dh)
    v = (x @ p.wv).view(B, S, -1, Dh)
    if cfg.rope_theta:
        q = layers.rope(q, pos, cfg.rope_theta)
        k = layers.rope(k, pos, cfg.rope_theta)
    return q, k, v


def _positions(cfg, h, pos):
    """h + sinusoidal embeddings of ``pos`` (same shape as h[..., 0]) for
    models without RoPE; h as it is otherwise."""
    if cfg.rope_theta:
        return h
    emb = layers.sinusoidal_positions(pos.reshape(-1), cfg.d_model, h.dtype)
    return h + emb.reshape(h.shape)


def _cross_decode(p, x, cfg, ent):
    """Cross-attention of x [B, C, d] (a decode token per lane, or a later
    prefill chunk) over the lane's cached cross K/V ``ent["xk"]``/
    ``ent["xv"]`` [B, T, Kh*Dh]: the flash kernel, non-causal over all T
    keys (at C = 1 what the JAX package's ``decode_attention(...,
    cache_len=T-1)`` computes)."""
    B, C, _ = x.shape
    H, Kh, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xk, xv = ent["xk"], ent["xv"]
    T = xk.shape[1]
    q = (x @ p.xq).view(B, C, H, Dh).to(xk.dtype)
    o = layers.blockwise_attention(q, xk.view(B, T, Kh, Dh),
                                   xv.view(B, T, Kh, Dh), causal=False)
    return o.reshape(B, C, H * Dh).to(x.dtype) @ p.xo


def _pages(data, layer, cfg):
    NB, bs = data.shape[2], data.shape[3]
    shape = (NB, bs, cfg.num_kv_heads, cfg.head_dim)
    return data[0, layer].view(shape), data[1, layer].view(shape)


def _attn_decode_paged(p, x, cfg, data, layer, kv, lens, lengths, window):
    """Dense-attention decode step against the paged KV store: append the
    new token's K/V via the fused cache write, then attend through the
    paged-attention kernel over pages + block tables.  ``kv``: the step's
    ``ctl["kv"]``.  ``lengths`` is ``lens + 1`` (the cached tokens plus the
    new one)."""
    B = x.shape[0]
    Kh, Dh = cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, layers.lengths_vector(lens, B)[:, None])
    paged_token_write(data, layer, (k.reshape(B, Kh * Dh),
                                    v.reshape(B, Kh * Dh)), kv["slots"],
                      scratch=kv.get("scratch"))
    k_pages, v_pages = _pages(data, layer, cfg)
    o = paged_attention(q[:, 0].to(k_pages.dtype), k_pages, v_pages,
                        kv["tables"], lengths, window=window)
    return o.reshape(B, 1, -1).to(x.dtype) @ p.wo


def _ffn(p, x, cfg, kind, lossless: bool = True):
    """The layer's FFN: the MoE for MoE kinds, lossless in serving (no aux
    loss), the capacity path where the JAX package takes it (the dense
    prefill chunk); else the MLP."""
    if kind in (ATTN_MOE, MLA_MOE):
        return moe.moe_ffn(p, x, cfg, lossless=lossless)[0]
    return layers.mlp(p, x, cfg.act)


def decode_step_paged(cfg: ModelConfig, params, data, ctl, state, lens,
                      token):
    """One decode step reading/writing device-resident paged caches in place.

    ``data``: {"kv": [2, L_attn, num_blocks+1, bs, width] page pool of the
    attention layers, "mla": [1, L_mla, num_blocks+1, bs, R + rope] latent
    pool of the MLA layers}, each present when the model has such layers,
    written in place.  ``ctl``: {"kv" / "mla" (with its pool): {"tables":
    [B, P] int32, "slots": [B] int32 within-plane row slot of the token
    being appended, "scratch": optional first within-plane slot of the
    scratch block that padded lanes write to, whose rows the cache-write
    kernel then skips}, "sample": optional controls of
    :func:`sample_from_logits`}.  ``state``: {"layers": [...]} batched
    per-layer non-paged state (see :func:`empty_state`): Mamba-1 and
    Mamba-2 layers carry {"state", "conv"}, cross-attention layers their
    cached {"xk", "xv"} [B, T, Kh*Dh], other layers nothing.  ``lens``:
    [B] int32 tokens already cached; ``token``: [B, 1].

    Returns (logits [B, V] — or sampled ids [B] with ``ctl["sample"]`` —,
    the pools present in ``data``, {"layers": new per-layer state}; cross
    K/V do not change in decode, so their entries come back empty).
    """
    SH.refuse("decode_step_paged")
    h = _positions(cfg, params.embed[token.long()], lens)
    kv, pool = ctl.get("kv"), data.get("kv")
    lat, lat_pool = ctl.get("mla"), data.get("mla")
    lengths = lens + 1
    new_state = []
    aj = mj = 0              # running indices into the kv / mla planes
    for i, kind in enumerate(cfg.layer_kinds()):
        p = params.layers[i]
        if kind in (MAMBA1, MAMBA2):
            fn = mamba.mamba1_decode if kind == MAMBA1 \
                else mamba.mamba2_decode
            ent = state["layers"][i]
            y, (st, conv) = fn(p, rmsnorm(h, p.norm, cfg.norm_eps), cfg,
                               ent["state"], ent["conv"])
            h = h + y
            new_state.append({"state": st, "conv": conv})
            continue
        if kind == SHARED_ATTN:
            sp = params.shared
            h = h + _attn_decode_paged(sp, rmsnorm(h, p.norm, cfg.norm_eps),
                                       cfg, pool, aj, kv, lens, lengths, 0)
            aj += 1
            h = h + layers.mlp(sp, rmsnorm(h, sp.norm2, cfg.norm_eps),
                               cfg.act)
            new_state.append({})
            continue
        x = rmsnorm(h, p.norm1, cfg.norm_eps)
        if kind in (MLA_MLP, MLA_MOE):
            a, _ = mla.mla_decode_paged(p, x, cfg, lat_pool, mj,
                                        lat["tables"], lat["slots"], lens,
                                        scratch=lat.get("scratch"))
            mj += 1
        else:
            window = cfg.sliding_window if cfg.is_local_layer(i) else 0
            a = _attn_decode_paged(p, x, cfg, pool, aj, kv, lens, lengths,
                                   window)
            aj += 1
        h = h + a
        if cfg.cross_attention:
            h = h + _cross_decode(p, rmsnorm(h, p.xnorm, cfg.norm_eps), cfg,
                                  state["layers"][i])
        h = h + _ffn(p, rmsnorm(h, p.norm2, cfg.norm_eps), cfg, kind)
        new_state.append({})
    logits = _logits(cfg, params, h[:, 0])
    out = logits if ctl.get("sample") is None \
        else sample_from_logits(logits, ctl["sample"])
    return out, _paged(data), {"layers": new_state}


def _paged(data) -> dict:
    return {k: data[k] for k in ("kv", "mla") if data.get(k) is not None}


# ---------------------------------------------------------------------------
# batched chunked prefill over device-resident paged caches (DESIGN.md §12)
# ---------------------------------------------------------------------------
def _attn_chunk_paged(p, x, cfg, data, layer, kv, ctx_lens, window):
    """Chunked-prefill dense attention against the paged KV store: write the
    chunk's K/V rows with one fused launch, then attend the chunk's queries
    through the chunked paged-attention kernel (chunk-causal over pages).
    ``kv``: the chunk's ``ctl["kv"]``."""
    B, C, _ = x.shape
    Kh, Dh = cfg.num_kv_heads, cfg.head_dim
    pos = ctx_lens[:, None] + torch.arange(C, device=x.device,
                                           dtype=ctx_lens.dtype)
    q, k, v = _qkv(p, x, cfg, pos)
    paged_chunk_write(data, layer, (k.reshape(B, C, Kh * Dh),
                                    v.reshape(B, C, Kh * Dh)), kv["slots"],
                      scratch=kv.get("scratch"))
    k_pages, v_pages = _pages(data, layer, cfg)
    o = paged_prefill_attention(q.to(k_pages.dtype), k_pages, v_pages,
                                kv["tables"], ctx_lens, window=window)
    return o.reshape(B, C, -1).to(x.dtype) @ p.wo


def _cross_chunk(p, x, enc_out, cfg):
    """Cross-attention of a prefill chunk x [B, C, d] over the encoder
    output [B, T, d]; returns (out, (xk, xv) [B, T, Kh*Dh]).  Recomputed
    from ``enc_out`` every chunk, as the JAX package does: deterministic
    in the encoder output, so a batch may mix first and later chunks."""
    B, C, _ = x.shape
    H, Kh, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T = enc_out.shape[1]
    e = enc_out.to(x.dtype)
    q = (x @ p.xq).view(B, C, H, Dh)
    k = e @ p.xk
    v = e @ p.xv
    o = layers.blockwise_attention(q, k.view(B, T, Kh, Dh),
                                   v.view(B, T, Kh, Dh), causal=False)
    return o.reshape(B, C, H * Dh) @ p.xo, (k, v)


def prefill_chunk_paged(cfg: ModelConfig, params, data, ctl, state, ctx_lens,
                        tokens):
    """One batched prefill chunk reading/writing device paged caches in place.

    ``data``: {"kv": [2, L_attn, NB+1, bs, w], "mla": [1, L_mla, NB+1, bs,
    R + rope]} page pools, as for :func:`decode_step_paged`.  ``ctl``:
    {"kv" / "mla" (with its pool): {"tables": [B, P] int32, "slots": [B, C]
    int32 within-plane row slots of the chunk tokens (padded positions
    point at scratch), "scratch": optional, as for
    :func:`decode_step_paged`}, "img": {"slots": [B, C]
    int32 image-cache row per media position or -1, "pages": image page
    pool} (optional), "mask": [B, C] bool valid chunk positions, "last": [B]
    int32 index of each request's last valid position, "sample":
    optional}.  ``state``: {"layers": [...]} batched per-layer Mamba
    state/conv (zeros for a request's first chunk; see
    :func:`empty_state`), and for cross-attention models "enc_out": [B, T,
    d], each lane's encoder output.  ``ctx_lens``: [B] int32 tokens
    already cached; ``tokens``: [B, C] int32 (0 at media positions — media
    embeddings are read straight off the image-cache pages).

    Returns (last-token logits [B, V] — or sampled ids [B] —, the pools
    present in ``data``, {"layers": new per-layer state}: Mamba
    state/conv, and each cross-attention layer's {"xk", "xv"} [B, T,
    Kh*Dh] for the decode steps).  Padded positions freeze the Mamba
    recurrence (``mask``), so each lane's new state is that of its valid
    tokens alone.
    """
    SH.refuse("prefill_chunk_paged")
    B, C = tokens.shape
    h = params.embed[tokens.long()]
    img = ctl.get("img")
    if img is not None:
        # media positions read their embedding rows off the image-cache
        # pages on device (no host gather of media embeddings)
        img_flat = img["pages"][0, 0].reshape(-1, img["pages"].shape[-1])
        islots = img["slots"]
        media_h = img_flat[islots.clamp(min=0).long()]
        h = torch.where((islots >= 0)[..., None], media_h.to(h.dtype), h)
    h = _positions(cfg, h, ctx_lens[:, None] + torch.arange(
        C, device=h.device, dtype=ctx_lens.dtype))
    kv, pool = ctl.get("kv"), data.get("kv")
    lat, lat_pool = ctl.get("mla"), data.get("mla")
    mask = ctl["mask"]
    new_state = []
    aj = mj = 0              # running indices into the kv / mla planes
    for i, kind in enumerate(cfg.layer_kinds()):
        p = params.layers[i]
        if kind in (MAMBA1, MAMBA2):
            fn = mamba.mamba1_seq if kind == MAMBA1 else mamba.mamba2_seq
            ent = state["layers"][i]
            y, (st, conv) = fn(p, rmsnorm(h, p.norm, cfg.norm_eps), cfg,
                               ent["state"], ent["conv"], mask=mask)
            h = h + y
            new_state.append({"state": st, "conv": conv})
            continue
        if kind == SHARED_ATTN:
            sp = params.shared
            h = h + _attn_chunk_paged(sp, rmsnorm(h, p.norm, cfg.norm_eps),
                                      cfg, pool, aj, kv, ctx_lens, 0)
            aj += 1
            h = h + layers.mlp(sp, rmsnorm(h, sp.norm2, cfg.norm_eps),
                               cfg.act)
            new_state.append({})
            continue
        x = rmsnorm(h, p.norm1, cfg.norm_eps)
        if kind in (MLA_MLP, MLA_MOE):
            a, _ = mla.mla_chunk_paged(p, x, cfg, lat_pool, mj,
                                       lat["tables"], lat["slots"], ctx_lens,
                                       scratch=lat.get("scratch"))
            mj += 1
        else:
            window = cfg.sliding_window if cfg.is_local_layer(i) else 0
            a = _attn_chunk_paged(p, x, cfg, pool, aj, kv, ctx_lens, window)
            aj += 1
        h = h + a
        ent = {}
        if cfg.cross_attention:
            c, (xk, xv) = _cross_chunk(p, rmsnorm(h, p.xnorm, cfg.norm_eps),
                                       state["enc_out"], cfg)
            h = h + c
            ent = {"xk": xk, "xv": xv}
        h = h + _ffn(p, rmsnorm(h, p.norm2, cfg.norm_eps), cfg, kind)
        new_state.append(ent)
    h_last = h[torch.arange(B, device=h.device), ctl["last"].long()]
    logits = _logits(cfg, params, h_last)
    if ctl.get("sample") is not None:
        logits = sample_from_logits(logits, ctl["sample"])
    return logits, _paged(data), {"layers": new_state}


def empty_state(cfg: ModelConfig, *, dtype=torch.float32,
                device="cpu") -> dict:
    """The non-paged state of one new request, zero: Mamba-1 layers carry
    {"state": [1, d_inner, N] f32, "conv": [1, K-1, d_inner] in ``dtype``
    (the weights' type)}, Mamba-2 layers {"state": [1, H, P, N] f32,
    "conv": [1, K-1, d_inner + 2N] in ``dtype``}; cross-attention layers
    {"xk", "xv": [1, T, Kh*Dh]} and the model "enc_out": [1, T, d] in
    ``dtype``, T the frames of one clip (every layer shares one read-only
    zero tensor); other attention layers carry nothing.  The steps take it
    batched: one such lane per request, concatenated."""
    out = []
    tree = {}
    if cfg.cross_attention:
        T = cfg.media_tokens
        tree["enc_out"] = torch.zeros((1, T, cfg.d_model), dtype=dtype,
                                      device=device)
        zx = torch.zeros((1, T, cfg.num_kv_heads * cfg.head_dim),
                         dtype=dtype, device=device)
    for kind in cfg.layer_kinds():
        ent = {}
        if kind in (MAMBA1, MAMBA2):
            shapes = (mamba.mamba1_cache_shape if kind == MAMBA1
                      else mamba.mamba2_cache_shape)(cfg, 1)
            ent = {"state": torch.zeros(shapes["state"], dtype=torch.float32,
                                        device=device),
                   "conv": torch.zeros(shapes["conv"], dtype=dtype,
                                       device=device)}
        elif cfg.cross_attention:
            ent = {"xk": zx, "xv": zx}
        out.append(ent)
    return {"layers": out, **tree}
