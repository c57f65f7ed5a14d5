"""ModelRunner: stage execution on PyTorch over device-resident paged caches.

Executes the three HydraInfer stages on actual model weights:

  encode             : modality frontend -> image-token cache (paged, block
                       576), or for cross-attention models (whisper) the
                       audio encoder -> ``enc_out`` in the state store
  prefill_chunks     : ONE batched chunked-prefill step for every request's
                       chunk this iteration (paged KV; DESIGN.md §12)
  decode             : batched one-token step over heterogeneous contexts
  joint_encode_decode: encode then decode, one after the other on one
                       stream (the paper's two CUDA streams are later work)

Block storage stays on the device; each step reads pages + block tables
through the paged-attention kernels and appends the new token — or the
whole prefill chunk — in place through the fused cache-write kernel.  Only
small control tensors (block tables, lengths, slots) go to the device and
only sampled token ids (or logits, when asked for) come back each step.
Mamba layers (Mamba-1, and zamba2's Mamba-2 beside its shared-attention
layers, which use the KV pool) keep no paged cache: each request's
recurrent state and conv prefix (``mamba{i}`` entries of the state store,
device tensors, the state in f32) are batched into the step and scattered
back per lane after it.
Cross-attention models keep each request's encoder output (``enc_out``)
and, after prefill, each layer's cross K/V (``xk{i}``/``xv{i}``) there
too, as device tensors in the pool's type: prefill batches ``enc_out``,
decode batches the cross K/V.
Batch size, chunk length and page count are bucketed to powers of two as
in the JAX package, so both packages see identical control tensors.

The JAX package's dense host-cache fallback (``RunnerCaches(device=False)``)
is not ported: here ``device`` always names the torch device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN_MLP, ATTN_MOE, MAMBA1, MAMBA2,
                                      MLA_MLP, MLA_MOE, SHARED_ATTN,
                                      ModelConfig)
from repro_torch.engine.paged_cache import (DevicePagedCache, PagedCacheSpec,
                                            StateStore, migrate_request)
from repro_torch.models import model as M

KV_BLOCK = 16        # paper §5.1
IMG_BLOCK = 576      # paper §5.1 (one LLaVA-1.5 image)


def bucket_pow2(n: int) -> int:
    """Smallest power of two >= n (shape bucketing)."""
    return 1 << max(0, n - 1).bit_length()


def _seq_layers(cfg: ModelConfig):
    """(attn_layer_ids, mla_layer_ids): the layers with a sequence-like
    paged cache, K/V planes or latent rows."""
    attn, mla = [], []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind in (MLA_MLP, MLA_MOE):
            mla.append(i)
        elif kind in (ATTN_MLP, ATTN_MOE, SHARED_ATTN):
            attn.append(i)
    return attn, mla


class RunnerCaches:
    """Per-instance cache pool: paged KV + paged latent (MLA) cache + paged
    image cache + state store, all sharing the unified transfer interface
    (paper §4.5).  ``kv`` is None without attention layers, ``mla``
    without MLA layers."""

    def __init__(self, cfg: ModelConfig, *, kv_blocks: int = 512,
                 img_blocks: int = 16, dtype=torch.float32, device="cuda",
                 sharing: bool = False):
        M.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.sharing = sharing
        self.attn_layers, self.mla_layers = _seq_layers(cfg)
        # Prefix sharing of the KV cache is unsound for models with
        # recurrent layers: their state at a prefix boundary is not paged or
        # snapshotted, so an adopted KV prefix would pair with a zero state.
        # The image cache (pure content, position-free) still shares.
        self.has_recurrent = any(k in (MAMBA1, MAMBA2)
                                 for k in cfg.layer_kinds())
        share_seq = sharing and not self.has_recurrent
        stores = []
        self.kv = self.mla = self.img = None
        if self.attn_layers:
            self.kv = DevicePagedCache(PagedCacheSpec(
                n_tensors=2, n_layers=len(self.attn_layers),
                block_size=KV_BLOCK, width=cfg.num_kv_heads * cfg.head_dim,
                num_blocks=kv_blocks, dtype=dtype),
                sharing=share_seq, device=self.device)
            stores.append(self.kv)
        if self.mla_layers:
            # one latent row per token, read as both key and value
            self.mla = DevicePagedCache(PagedCacheSpec(
                n_tensors=1, n_layers=len(self.mla_layers),
                block_size=KV_BLOCK,
                width=cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                num_blocks=kv_blocks, dtype=dtype),
                sharing=share_seq, device=self.device)
            stores.append(self.mla)
        if cfg.frontend != "none":
            # one image per block so a repeated image shares exactly its
            # own pages (media_tokens when set, the LLaVA default otherwise)
            self.img = DevicePagedCache(PagedCacheSpec(
                n_tensors=1, n_layers=1,
                block_size=cfg.media_tokens or IMG_BLOCK,
                width=cfg.d_model, num_blocks=img_blocks, dtype=dtype),
                sharing=sharing, device=self.device)
            stores.append(self.img)
        self.states = StateStore()
        stores.append(self.states)
        self.stores = stores

    def release(self, rid: int):
        """THE release path for every retire/abort/migrate-source site: with
        sharing enabled this drops *references* — a block survives while any
        other request's table still points at it."""
        for s in self.stores:
            s.free(rid)

    def seq_pools(self) -> list:
        """(step argument name, pool) of each sequence pool present."""
        return [(n, c) for n, c in (("kv", self.kv), ("mla", self.mla))
                if c is not None]

    def kv_tokens_free(self) -> int:
        """Tokens every sequence pool can still take (the least of them)."""
        pools = self.seq_pools()
        if not pools:
            return 1 << 30       # SSM-only: no token-proportional cache
        return min(c.available_blocks * c.spec.block_size for _, c in pools)

    def kv_tokens_total(self) -> int:
        """Whole-pool KV capacity in tokens, the least over the sequence
        pools: the admission check's can-this-request-EVER-fit bound
        (DESIGN.md §15)."""
        pools = self.seq_pools()
        if not pools:
            return 1 << 30
        return min(c.spec.num_blocks * c.spec.block_size for _, c in pools)

    def live_rids(self) -> set:
        """Every rid holding any state on this instance's stores — the set
        an instance quarantine must release (DESIGN.md §15)."""
        rids: set = set()
        for s in self.stores:
            if isinstance(s, StateStore):
                rids.update(s.store.keys())
            else:
                rids.update(s.tables.keys())
        return rids


def migrate(rid: int, src: RunnerCaches, dst: RunnerCaches, *,
            fault=None, timeout=None) -> int:
    return migrate_request(rid, src.stores, dst.stores, fault=fault,
                           timeout=timeout)


class ModelRunner:
    def __init__(self, cfg: ModelConfig, params, caches: RunnerCaches, *,
                 device="cuda"):
        self.device = resolve_device(device)
        if caches.device != self.device or params.device != self.device:
            raise ValueError(
                f"runner on {self.device} but caches on {caches.device} and "
                f"params on {params.device}")
        M.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.caches = caches
        # one zero lane: the state of a request's first prefill chunk and of
        # padded lanes (and the cross K/V of a lane that has none)
        self._zero = M.empty_state(cfg, dtype=caches.dtype,
                                   device=self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def _host(x: torch.Tensor) -> np.ndarray:
        return x.float().cpu().numpy() if x.is_floating_point() \
            else x.cpu().numpy()

    # ------------------------------------------------------------------
    # sampling control prep
    # ------------------------------------------------------------------
    @staticmethod
    def _all_greedy(sample, idxs=None) -> bool:
        if sample is None:
            return False
        t = np.asarray(sample["temp"])
        return not np.any((t if idxs is None else t[idxs]) > 0)

    def _sample_ctl(self, sample, B_pad: int, idxs=None):
        """Pad/select host sample arrays (see ``M.sample_from_logits``) into
        the step's control subtree.  Padded lanes get temp=0 (greedy over
        garbage logits, discarded on the host).  Seeds and steps stay on
        the host: they only seed the per-lane generators."""
        out = {}
        for name, dt in (("temp", np.float32), ("top_k", np.int32),
                         ("top_p", np.float32), ("seed", np.int64),
                         ("step", np.int64)):
            v = np.asarray(sample[name]).astype(dt)
            if idxs is not None:
                v = v[idxs]
            pad = B_pad - v.shape[0]
            if pad:
                v = np.concatenate([v, np.zeros(pad, dt)])
            out[name] = v if name in ("seed", "step") else self._dev(v)
        return out

    def _finish(self, out, B: int, greedy: bool) -> np.ndarray:
        """Host copy of the step's first B lanes: token ids when sampling
        (greedy batches take a plain on-device argmax), else logits."""
        if greedy:
            out = torch.argmax(out, dim=-1).to(torch.int32)
        return self._host(out[:B])

    # ------------------------------------------------------------------
    # encode stage
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode(self, items):
        """items: [(rid, media [n_media, d_model])] -> image cache entries.

        One item per media element, so a multi-image request contributes
        several items (same rid) that batch alongside everyone else's.
        Mixed media shapes batch per shape group, but the results commit in
        the original item order, so a request's images always land in its
        image cache in submission order.
        """
        if not items:
            return
        groups: dict[tuple, list] = {}          # shape -> item indices
        for i, (_, m) in enumerate(items):
            groups.setdefault(tuple(m.shape), []).append(i)
        embs: list = [None] * len(items)
        for idxs in groups.values():
            grp = [items[i] for i in idxs]
            emb = M.encode_media(self.cfg, self.params, self._media_batch(grp))
            for i, e in zip(idxs, emb):
                embs[i] = e
        for (rid, _), e in zip(items, embs):
            if self.cfg.cross_attention:
                self._store_enc_out(rid, e)
            else:
                self.caches.img.append(rid, e[None, None])  # [1, 1, T, d]

    def _store_enc_out(self, rid: int, e: torch.Tensor):
        """Cross-attention models keep the encoder output [1, T, d] in the
        state store; a later clip of the same request lands after the
        earlier ones."""
        st = self.caches.states.get(rid) or {}
        e = e[None].to(self.caches.dtype)
        if "enc_out" in st:
            e = torch.cat([st["enc_out"], e], dim=1)
        st["enc_out"] = e
        self.caches.states.put(rid, st)

    def _media_batch(self, items):
        """Stack media on the device, padding the batch to a power of two
        (shape bucket)."""
        media = torch.stack([torch.as_tensor(m) for _, m in items])
        media = media.to(self.device)
        pad = bucket_pow2(media.shape[0]) - media.shape[0]
        if pad:
            media = torch.cat([media, media.new_zeros((pad,)
                                                      + media.shape[1:])])
        return media

    # ------------------------------------------------------------------
    # prefill (batched, device-resident paged path, DESIGN.md §12)
    # ------------------------------------------------------------------
    def prefill_chunk(self, rid: int, tokens: Optional[np.ndarray], *,
                      use_media: bool = False):
        """Run one chunk for one request; returns last-token logits [V]."""
        return self.prefill_chunks([(rid, tokens, use_media)])[0]

    def _ctx_len(self, rid: int) -> int:
        pools = self.caches.seq_pools()
        if pools:
            return pools[0][1].lengths.get(rid, 0)
        st = self.caches.states.get(rid) or {}
        return int(st.get("ctx_len", 0))

    def _batched_state(self, rids, B_pad: int, *, fresh: bool = False):
        """Batch each request's non-paged state into the step's [B_pad, ...]
        state; padded lanes get zeros.

        Mamba layers take each request's state/conv; ``fresh`` (prefill):
        a request with none yet (its first chunk) starts from zeros, while
        in decode every request must have one.  Cross-attention models take
        each lane's ``enc_out`` in prefill and each layer's cross K/V in
        decode, probed per lane: a lane without them, the first one
        included, gets zero rows and no other lane loses its own."""
        sts = [self.caches.states.get(r) or {} for r in rids]
        pad = B_pad - len(rids)

        def stack(per, zero):
            ref = next((e for e in per if e is not None), zero)
            if (ref.shape, ref.dtype) != (zero.shape, zero.dtype):
                zero = torch.zeros_like(ref)    # several clips per request
            return torch.cat([zero if e is None else e for e in per]
                             + [zero] * pad)

        out = []
        for i, zero in enumerate(self._zero["layers"]):
            if "state" in zero:                         # Mamba-1 or -2
                per = [st[f"mamba{i}"] if not fresh or f"mamba{i}" in st
                       else zero for st in sts] + [zero] * pad
                out.append({n: torch.cat([e[n] for e in per])
                            for n in ("state", "conv")})
            elif "xk" in zero and not fresh:            # cross K/V
                out.append({n: stack([st.get(f"{n}{i}") for st in sts],
                                     zero[n]) for n in ("xk", "xv")})
            else:
                out.append({})
        tree = {"layers": out}
        if fresh and "enc_out" in self._zero:
            tree["enc_out"] = stack([st.get("enc_out") for st in sts],
                                    self._zero["enc_out"])
        return tree

    def _commit_states(self, rids, new_state, ctx_lens):
        """Scatter each lane's new Mamba state/conv, and after prefill its
        cross K/V, back to its request and record its context length."""
        for b, rid in enumerate(rids):
            st = self.caches.states.get(rid) or {}
            for i, e in enumerate(new_state["layers"]):
                if "state" in e:
                    st[f"mamba{i}"] = {"state": e["state"][b:b + 1],
                                       "conv": e["conv"][b:b + 1]}
                elif "xk" in e:
                    st[f"xk{i}"] = e["xk"][b:b + 1].to(self.caches.dtype)
                    st[f"xv{i}"] = e["xv"][b:b + 1].to(self.caches.dtype)
            st["ctx_len"] = ctx_lens[b]
            self.caches.states.put(rid, st)

    @torch.inference_mode()
    def prefill_chunks(self, items, sample=None):
        """One prefill chunk for a batch of requests.  items: [(rid,
        tokens | None, use_media)].  Returns last-token logits
        [len(items), V] (np) in input order — or, when ``sample`` carries
        per-item sampling controls, the sampled next-token ids
        [len(items)] (np int32; only meaningful for items whose prefill
        completes this chunk).

        ONE ``prefill_chunk_paged`` call per pow2 chunk-length bucket (so a
        whole-image media chunk doesn't pad every short text chunk up to
        its length), batch-padded to a power of two.
        """
        out = np.zeros((len(items),) if sample is not None
                       else (len(items), self.cfg.vocab_size),
                       np.int32 if sample is not None else np.float32)
        groups: dict[int, list] = {}
        for idx, (rid, toks, um) in enumerate(items):
            n = (0 if toks is None else len(toks)) + \
                (self.caches.img.lengths.get(rid, 0) if um else 0)
            groups.setdefault(bucket_pow2(max(n, 1)), []).append(
                (idx, rid, toks, um, n))
        for C_pad, grp in sorted(groups.items()):
            res = self._prefill_group(grp, C_pad, sample=sample)
            for (idx, *_), lg in zip(grp, res):
                out[idx] = lg
        return out

    def _prefill_group(self, grp, C_pad: int, sample=None):
        """Run one equal-bucket group: [(idx, rid, tokens, use_media,
        n_new)] -> last-token logits [len(grp), V] (np), or sampled token
        ids [len(grp)] when ``sample`` is given."""
        B = len(grp)
        B_pad = bucket_pow2(B)
        rids = [g[1] for g in grp]
        n_new = [g[4] for g in grp]
        ctx = [self._ctx_len(r) for r in rids]
        tokens = np.zeros((B_pad, C_pad), np.int32)
        mask = np.zeros((B_pad, C_pad), bool)
        img_slots = None
        for b, (_, rid, toks, um, n) in enumerate(grp):
            off = 0
            if um:
                m = self.caches.img.lengths.get(rid, 0)
                if img_slots is None:
                    img_slots = np.full((B_pad, C_pad), -1, np.int32)
                img_slots[b, :m] = self.caches.img.row_slots(rid, 0, m)
                off = m
            if toks is not None:
                tokens[b, off:off + len(toks)] = toks
            mask[b, :n] = True
        last = np.zeros(B_pad, np.int32)
        last[:B] = np.maximum(np.asarray(n_new, np.int32) - 1, 0)
        lens_arr = np.zeros(B_pad, np.int32)
        lens_arr[:B] = ctx
        data, ctl = {}, {}
        for name, cache in self.caches.seq_pools():
            bs = cache.spec.block_size
            pages = max(-(-(c + n) // bs) for c, n in zip(ctx, n_new))
            tables, slots = cache.prepare_prefill(rids, n_new, B_pad, C_pad,
                                                  bucket_pow2(pages))
            data[name] = cache.data
            ctl[name] = {"tables": self._dev(tables),
                         "slots": self._dev(slots),
                         "scratch": cache.scratch_block * bs}
        if img_slots is not None:
            # media positions read the device image cache in the step
            ctl["img"] = {"slots": self._dev(img_slots),
                          "pages": self.caches.img.data}
        ctl["mask"] = self._dev(mask)
        ctl["last"] = self._dev(last)
        idxs = np.asarray([g[0] for g in grp])
        greedy = self._all_greedy(sample, idxs)
        if sample is not None and not greedy:
            ctl["sample"] = self._sample_ctl(sample, B_pad, idxs=idxs)
        state = self._batched_state(rids, B_pad, fresh=True)
        logits, _, new_state = M.prefill_chunk_paged(
            self.cfg, self.params, data, ctl, state, self._dev(lens_arr),
            self._dev(tokens))
        res = self._finish(logits, B, greedy)
        for _, cache in self.caches.seq_pools():
            cache.commit_prefill(rids, n_new)
        self._commit_states(rids, new_state,
                            [c + n for c, n in zip(ctx, n_new)])
        return res

    # ------------------------------------------------------------------
    # decode (device-resident paged path, DESIGN.md §11)
    # ------------------------------------------------------------------
    def _prepare_paged(self, rids):
        """Host-side per-step control prep: one-token block headroom, padded
        block tables / slot mappings / lengths.  All tiny int32 arrays — the
        bulk cache never crosses the host boundary."""
        B = len(rids)
        B_pad = bucket_pow2(B)
        lens = [self._ctx_len(r) for r in rids]
        lens_arr = np.zeros(B_pad, np.int32)
        lens_arr[:B] = lens
        data, ctl = {}, {}
        for name, cache in self.caches.seq_pools():
            bs = cache.spec.block_size
            pages = max(-(-(n + 1) // bs) for n in lens)
            tables, slots = cache.prepare_decode(rids, B_pad,
                                                 bucket_pow2(pages))
            data[name] = cache.data
            ctl[name] = {"tables": self._dev(tables),
                         "slots": self._dev(slots),
                         "scratch": cache.scratch_block * bs}
        return data, ctl, self._dev(lens_arr), lens

    def _commit_paged(self, rids, new_state, lens):
        """Block tables/lengths advance by the one token the step wrote;
        each lane's new Mamba state goes back to its request."""
        for _, cache in self.caches.seq_pools():
            cache.commit_decode(rids)
        self._commit_states(rids, new_state, [n + 1 for n in lens])

    @torch.inference_mode()
    def decode(self, rids, tokens: np.ndarray, sample=None):
        """One decode step for a batch.  tokens: [B].  Returns logits [B, V],
        or sampled next-token ids [B] (np int32) when ``sample`` carries
        per-request sampling controls (see ``M.sample_from_logits``)."""
        data, ctl, lens_arr, lens = self._prepare_paged(rids)
        B_pad = lens_arr.shape[0]
        greedy = self._all_greedy(sample)
        if sample is not None and not greedy:
            ctl["sample"] = self._sample_ctl(sample, B_pad)
        tok = np.zeros((B_pad, 1), np.int32)
        tok[:len(rids), 0] = tokens
        out, _, new_state = M.decode_step_paged(
            self.cfg, self.params, data, ctl,
            self._batched_state(rids, B_pad), lens_arr, self._dev(tok))
        res = self._finish(out, len(rids), greedy)
        self._commit_paged(rids, new_state, lens)
        return res

    # ------------------------------------------------------------------
    # encode + decode in one scheduler iteration (paper §3.1 / Fig 4)
    # ------------------------------------------------------------------
    def joint_encode_decode(self, enc_items, rids, tokens, sample=None):
        """Encode a media batch AND decode a token batch in one scheduler
        iteration.  The paper overlaps the two on separate CUDA streams;
        this slice runs them one after the other on the current stream.

        Returns the decode logits [len(rids), V] (np) — or the sampled
        next-token ids [len(rids)] when ``sample`` is given — or None when
        there was no decode work.  The embeddings land in the image cache
        (or, for cross-attention models, the state store) and never cross
        the host boundary."""
        self.encode(enc_items)
        if not rids:
            return None
        return self.decode(rids, tokens, sample)
