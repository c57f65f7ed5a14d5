"""HydraServer: real-execution multi-instance serving (in-process), on
PyTorch.

The same scheduling stack as the JAX package's server — Algorithm 1 /
baseline policies, pull-based migration, hybrid EPD instance roles — with
stages executing through the torch ModelRunner on one device (every
instance of the server shares it), and wall-clock time.  The host logic
(admission, routing, migration, prefix and embedding caches, health,
replay and shedding) is a copy of ``repro.engine.server``; what differs is
the device: ``device`` (default ``"cuda"``) names it, the cache pools hold
K/V in the weights' type (``device_cache=False``: f32 numpy pools on the
host, the dense fallback, gathered to the device each step), and device
tensors cross to the host only as numpy copies.

Fault tolerance (DESIGN.md §15): every instance carries a health state
machine (healthy → degraded → dead) driven by per-iteration progress
heartbeats; a dead instance is quarantined (removed from routing, its cache
references released) and its stranded requests are re-dispatched to
survivors via journal *replay* — re-prefilling the original prompt plus the
already-emitted output tokens and resuming decode at the exact per-lane PRNG
step, so greedy/seeded continuations are bit-exact with an uninterrupted
run.  Migrations retry with bounded backoff on typed transfer failures
(drop/corrupt/OOM/timeout) before falling back to replay.  Under durably
degraded capacity, deadline-aware shedding (``shed_policy="deadline"``)
finishes doomed requests with reason "error" and rejects unserveable
submits with a typed ``AdmissionError``.  A seeded ``FaultPlan`` injects
crashes, stalls, allocation failures, and transfer faults at chosen
scheduler iterations for testing and the recovery benchmark.
"""
from __future__ import annotations

import hashlib
import itertools
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace as dataclasses_replace
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.batch_scheduler import POLICIES
from repro_torch.core.budgets import Budgets
from repro_torch.core.costmodel import A100
from repro_torch.core.request import (Request, SLO, SamplingParams, Stage,
                                      StreamEvent)
from repro_torch.core.simulator import ROLE_SETS, DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.faults import (AdmissionError, FaultPlan,
                                       RequestJournal, TransferError)


@dataclass
class ServeItem:
    req: Request
    prompt: np.ndarray                 # [n_text] int32
    media: Optional[list] = None       # [per image: [n_media_i, d_model]]
    generated: list = field(default_factory=list)
    seed: int = 0                      # resolved sampling seed
    # --- prefix/embedding cache bookkeeping (DESIGN.md §14) ---
    kv_keys: Optional[list] = None     # live seq-cache key stream: media
    #                                    pseudo-keys then prompt tokens,
    #                                    extended with each decoded token
    kv_root: int = 0                   # chain root seed (mixes media for
    #                                    cross-attn archs)
    img_keys: Optional[list] = None    # image-cache key stream
    media_hashes: Optional[list] = None  # per-image content hashes
    cached_media: Optional[list] = None  # embeddings found in the encode
    #                                      cache at submit (pinned here so
    #                                      LRU eviction can't race install)
    media_installed: bool = False
    # --- failure recovery (DESIGN.md §15) ---
    journal: Optional[RequestJournal] = None  # original prompt + media
    #                                           hashes + seed; ``generated``
    #                                           above is the accepted-token
    #                                           half of the journal


def _media_hash(m) -> int:
    """Content hash of one media array (the identity under which its
    encoded embedding and its cache pages are shared across requests)."""
    a = np.ascontiguousarray(np.asarray(m))
    h = hashlib.blake2b(digest_size=8)
    h.update(str((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return int.from_bytes(h.digest(), "little")


class EmbeddingCache:
    """Content-hash -> encoded media embedding (host numpy), LRU-bounded.

    A hit lets a repeated image/clip skip the encode stage entirely: the
    stored embedding is installed straight into the image cache (sharing
    resident pages by the same hash) or the cross-attn state store.
    """

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self.store: "OrderedDict[int, np.ndarray]" = OrderedDict()

    def get(self, h: int):
        e = self.store.get(h)
        if e is not None:
            self.store.move_to_end(h)
        return e

    def put(self, h: int, emb: np.ndarray):
        if h in self.store:
            self.store.move_to_end(h)
            return
        self.store[h] = emb
        while len(self.store) > self.capacity:
            self.store.popitem(last=False)


class RealInstance:
    """Duck-types the fields the scheduling policies expect.

    Unlike the simulator's ``Instance`` there is no pull-delay modeling
    here: real migration happens synchronously in ``HydraServer._migrate``
    (which accounts the actual bytes moved), so the queue holds bare
    requests.
    """

    def __init__(self, iid, role_name, cfg, params, budgets, policy,
                 *, kv_blocks=512, img_blocks=16, device_cache=True,
                 device="cuda", spec=None, sharing=False):
        self.iid = iid
        self.role_name = role_name
        self.role = ROLE_SETS[role_name]
        self.budgets = budgets
        self.policy = policy
        self.spec = spec                    # RoleSpec (hw/tp routing weights)
        self.caches = R.RunnerCaches(cfg, kv_blocks=kv_blocks,
                                     img_blocks=img_blocks,
                                     dtype=params.embed.dtype,
                                     device=device, sharing=sharing,
                                     device_cache=device_cache)
        self.runner = R.ModelRunner(cfg, params, self.caches, device=device)
        self.running: list[Request] = []
        self.waiting: deque = deque()
        # health state machine (DESIGN.md §15): healthy -> degraded -> dead
        self.health = "healthy"
        self.stall_count = 0         # consecutive no-progress iterations

    def enqueue(self, r: Request):
        self.waiting.append(r)

    def _kv_reserved(self) -> int:
        """KV tokens promised to already-admitted requests but not yet
        written, plus one block of rounding slack each — without this,
        several requests can each pass ``has_capacity`` against the same
        free pool and then OOM the allocator mid-run.  Encode-stage
        requests count too when this instance will also prefill them:
        ``advance_after_encode`` flips them to PREFILL with no further
        capacity check."""
        tot = 0
        for r in self.running:
            if r.stage in (Stage.PREFILL, Stage.DECODE):
                tot += (r.prefill_remaining
                        + max(r.max_new_tokens - r.tokens_out, 0)
                        + 1 + R.KV_BLOCK)
            elif r.stage == Stage.ENCODE and Stage.PREFILL in self.role:
                tot += r.prefill_total + r.max_new_tokens + 1 + R.KV_BLOCK
        return tot

    @staticmethod
    def _needs_media_install(r: Request) -> bool:
        """An encode-skipped vision request whose cached embeddings have not
        landed in the image cache yet (they install lazily at its first
        prefill batch; a full KV-prefix hit over the media span skips the
        install entirely, hence the prefill_done test)."""
        return (r.stage == Stage.PREFILL and r.encode_cached
                and r.media_in_lm and r.prefill_done < r.image_tokens)

    def _img_reserved_blocks(self) -> int:
        """Image blocks promised to admitted requests whose media has not
        materialized yet (same double-admission hazard as KV): encode-stage
        requests, plus encode-skipped ones pending their lazy install."""
        bs = self.caches.img.spec.block_size
        return sum(-(-r.image_tokens // bs) for r in self.running
                   if r.stage == Stage.ENCODE or self._needs_media_install(r))

    def has_capacity(self, r: Request) -> bool:
        if r.stage in (Stage.PREFILL, Stage.DECODE):
            need = r.prefill_remaining + r.max_new_tokens + 1 + R.KV_BLOCK
            if self.caches.kv_tokens_free() < need + self._kv_reserved():
                return False
            if self._needs_media_install(r) and self.caches.img is not None:
                bs = self.caches.img.spec.block_size
                need_img = -(-r.image_tokens // bs)
                return (self.caches.img.available_blocks
                        >= need_img + self._img_reserved_blocks())
            return True
        if r.stage == Stage.ENCODE and self.caches.img is not None:
            bs = self.caches.img.spec.block_size
            need = -(-r.image_tokens // bs)
            if (self.caches.img.available_blocks
                    < need + self._img_reserved_blocks()):
                return False
            if Stage.PREFILL in self.role:  # will prefill here post-encode
                need_kv = r.prefill_total + r.max_new_tokens + 1 + R.KV_BLOCK
                return (self.caches.kv_tokens_free()
                        >= need_kv + self._kv_reserved())
            return True
        return True

    def pop_waiting(self, stage, now):
        for i, r in enumerate(self.waiting):
            if stage is not None and r.stage != stage:
                continue
            if not self.has_capacity(r):
                continue
            del self.waiting[i]
            self.running.append(r)
            return r
        return None

    def remove(self, r: Request):
        if r in self.running:
            self.running.remove(r)


class HydraServer:
    def __init__(self, cfg: ModelConfig, params, disagg: DisaggConfig, *,
                 slo: SLO = SLO(10.0, 1.0), policy: str = "hydra",
                 budgets: Budgets = Budgets(64, 4), kv_blocks: int = 512,
                 img_blocks: int = 16, device_cache: bool = True,
                 prefix_cache: bool = False, embed_cache_entries: int = 32,
                 fault_plan: Optional[FaultPlan] = None,
                 shed_policy: str = "off", shed_ttft_factor: float = 8.0,
                 transfer_retries: int = 3, transfer_backoff: float = 0.005,
                 transfer_timeout: Optional[float] = None,
                 degraded_after: Optional[int] = 8,
                 dead_after: Optional[int] = 32, max_recoveries: int = 5,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        pol = POLICIES[policy]
        self.instances = []
        iid = itertools.count()
        # every instance runs on ``device``: RoleSpec hardware overrides
        # only feed the speed-normalized router below
        for role, spec in disagg.roles:
            for _ in range(spec.count):
                self.instances.append(RealInstance(
                    next(iid), role, cfg, params, budgets, pol,
                    kv_blocks=kv_blocks, img_blocks=img_blocks,
                    device_cache=device_cache, device=self.device, spec=spec,
                    sharing=prefix_cache))
        self.items: dict[int, ServeItem] = {}
        self._rid = itertools.count()
        self.slo = slo
        self.migrated_bytes = 0
        self.n_migrations = 0
        self.on_event = None            # callable(StreamEvent) | None
        self.prefix_cache = prefix_cache
        self.embed_cache = EmbeddingCache(embed_cache_entries)
        self.cache_counters = {"prompt_tokens": 0, "cached_prompt_tokens": 0,
                               "images": 0, "cached_images": 0}
        # --- fault tolerance (DESIGN.md §15) ---
        if shed_policy not in ("off", "deadline"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        self.fault_plan = fault_plan
        self.shed_policy = shed_policy
        self.shed_ttft_factor = shed_ttft_factor
        self.transfer_retries = transfer_retries
        self.transfer_backoff = transfer_backoff
        self.transfer_timeout = transfer_timeout
        self.degraded_after = degraded_after
        self.dead_after = dead_after
        self.max_recoveries = max_recoveries
        self.dead_instances: list[RealInstance] = []
        self.fault_log: list[dict] = []
        self._iter = 0                 # productive scheduler iterations
        self.n_replays = 0
        self.n_shed = 0
        self.n_transfer_retries = 0
        self.n_transfer_failures = 0
        self._t0 = time.monotonic()

    def now(self) -> float:
        """Engine clock: seconds since server construction."""
        return time.monotonic() - self._t0

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, *, media=None,
               max_new_tokens: Optional[int] = None, arrival: float = 0.0,
               sampling: Optional[SamplingParams] = None,
               slo: Optional[SLO] = None) -> int:
        """Enqueue a request.  Legal at any time, including while the serve
        loop is live (open-loop arrivals through ``Engine``).

        ``media``: None, one [n_media, d_model] array (a single image /
        audio clip), or a list of such arrays for multi-image requests
        (LLaVA-Next / Qwen2-VL style) — each counts as one image and its
        rows as image tokens.  ``sampling`` defaults to greedy;
        ``max_new_tokens`` (legacy) overrides ``sampling.max_tokens``.
        """
        rid = next(self._rid)
        if media is not None and not isinstance(media, (list, tuple)):
            media = [media]
        media = list(media) if media else None
        n_images = len(media) if media else 0
        image_tokens = sum(m.shape[0] for m in media) if media else 0
        if sampling is None:
            sampling = SamplingParams(
                max_tokens=16 if max_new_tokens is None else max_new_tokens)
        elif max_new_tokens is not None:
            sampling = dataclasses_replace(sampling,
                                           max_tokens=max_new_tokens)
        req = Request(rid=rid, arrival=arrival,
                      n_images=n_images, image_tokens=image_tokens,
                      prompt_tokens=len(prompt),
                      max_new_tokens=sampling.max_tokens,
                      slo=slo or self.slo, sampling=sampling,
                      media_in_lm=self.cfg.frontend != "audio")
        if self.shed_policy == "deadline":
            self._admission_check(req)     # typed reject before any state
        seed = sampling.seed if sampling.seed is not None \
            else (rid * 1000003 + 99991) & 0x7FFFFFFF
        it = ServeItem(req=req, prompt=np.asarray(prompt), media=media,
                       seed=seed)
        self.items[rid] = it
        if self.prefix_cache:
            self._prepare_cache_keys(it)
        if media is not None and it.media_hashes is None:
            it.media_hashes = [_media_hash(m) for m in media]
        it.journal = RequestJournal(
            prompt=np.array(it.prompt, copy=True),
            media_hashes=tuple(it.media_hashes or ()), seed=seed)
        inst = self._route(req.stage)
        self._bind_keys(inst, it)
        if req.stage == Stage.PREFILL:
            self._try_prefix_match(inst, it)
        inst.enqueue(req)
        return rid

    # ------------------------------------------------------------------
    # prefix / image-embedding caching (DESIGN.md §14)
    # ------------------------------------------------------------------
    def _prepare_cache_keys(self, it: ServeItem):
        """Derive the request's cache identity once, at submit: the seq-cache
        key stream (media pseudo-keys then prompt tokens — decoded tokens
        append later), and the encode-skip decision when every media item's
        embedding is already resident in the embedding cache."""
        r = it.req
        prompt = [int(t) for t in it.prompt]
        if not it.media:
            it.kv_keys = prompt
            return
        it.media_hashes = [_media_hash(m) for m in it.media]
        self.cache_counters["images"] += len(it.media)
        if r.media_in_lm:
            mkeys = [(h, j) for h, m in zip(it.media_hashes, it.media)
                     for j in range(m.shape[0])]
            it.kv_keys = mkeys + prompt
            it.img_keys = mkeys
        else:
            # cross-attn: media never enters the LM sequence, but every KV
            # row attends enc_out — mix the media identity into the chain
            # root so different clips can never share a text prefix
            it.kv_keys = prompt
            it.kv_root = hash(("xattn", tuple(it.media_hashes)))
        cached = [self.embed_cache.get(h) for h in it.media_hashes]
        if all(c is not None for c in cached):
            it.cached_media = cached       # pin vs. LRU eviction
            r.encode_cached = True
            r.stage = Stage.PREFILL        # skip the encode stage entirely
            self.cache_counters["cached_images"] += len(it.media)

    def _bind_keys(self, inst: RealInstance, it: ServeItem):
        """Attach the request's live key streams to an instance's sharing
        caches so commits register completed blocks (idempotent)."""
        if not self.prefix_cache:
            return
        rid = it.req.rid
        for c in (inst.caches.kv, inst.caches.mla):
            if c is not None and c.sharing and it.kv_keys is not None:
                c.set_keys(rid, it.kv_keys, it.kv_root)
        if inst.caches.img is not None and it.img_keys is not None:
            inst.caches.img.set_keys(rid, it.img_keys, 0)

    def _try_prefix_match(self, inst: RealInstance, it: ServeItem):
        """Adopt the longest resident KV prefix for a PREFILL-stage request
        before it is scheduled, so chunk planning and capacity reservations
        see only the miss suffix.  Capped at prefill_total - 1 (the suffix
        chunk must run to produce the first-token logits); media-in-LM
        prompts must cover the whole media span or nothing, because media
        chunks embed whole-first."""
        if not self.prefix_cache:
            return
        r = it.req
        if r.stage != Stage.PREFILL or r.prefill_done:
            return
        pools = [c for c in (inst.caches.kv, inst.caches.mla)
                 if c is not None]
        if not pools or not all(c.sharing for c in pools):
            matched = 0                    # SSM-hybrid: sharing gated off
        else:
            limit = r.prefill_total - 1
            matched = min(c.probe_prefix(it.kv_keys, it.kv_root, limit)
                          for c in pools)
            if r.media_in_lm and 0 < matched < r.image_tokens:
                matched = 0
        self.cache_counters["prompt_tokens"] += r.prefill_total
        if matched <= 0:
            return
        for c in pools:
            c.take_prefix(r.rid, matched, it.kv_keys, it.kv_root)
        r.prefill_done = matched
        r.prefix_cached_tokens = matched
        self.cache_counters["cached_prompt_tokens"] += matched

    def _cache_encoded(self, inst: RealInstance, r: Request):
        """After a real encode: publish the per-media embeddings into the
        content-hash embedding cache so later requests can skip the stage.
        Cross-attn encoders may change sequence length, so their output is
        only cacheable when the clip boundary is unambiguous (single clip)."""
        it = self.items[r.rid]
        if it.media_hashes is None:
            return
        if self.cfg.cross_attention:
            if len(it.media_hashes) != 1:
                return
            st = inst.caches.states.get(r.rid) or {}
            enc = st.get("enc_out")            # device [1, T, d]
            if enc is not None:
                # host f32 copy (exact for bf16; the install casts back)
                self.embed_cache.put(it.media_hashes[0],
                                     enc[0].float().cpu().numpy())
            return
        # host f32 copy (exact for bf16 pools; the install casts back)
        emb = inst.caches.img.gather(r.rid)[0, 0]
        if isinstance(emb, torch.Tensor):
            emb = emb.float().cpu().numpy()
        pos = 0
        for h, m in zip(it.media_hashes, it.media):
            n = m.shape[0]
            self.embed_cache.put(h, emb[pos:pos + n])
            pos += n

    def _install_media(self, inst: RealInstance, it: ServeItem):
        """Lazily materialize an encode-skipped request's media on its
        prefill instance: enc_out into the state store (cross-attn), or the
        cached embeddings into the paged image cache — adopting resident
        pages by content hash first, appending only the miss remainder."""
        r = it.req
        if self.cfg.cross_attention:
            st = inst.caches.states.get(r.rid) or {}
            e = np.concatenate([np.asarray(c) for c in it.cached_media], 0)
            # a device tensor in the pool's type, as the encode stage
            # leaves it (see ModelRunner._store_enc_out)
            st["enc_out"] = torch.from_numpy(e)[None].to(
                device=inst.caches.device, dtype=inst.caches.dtype)
            inst.caches.states.put(r.rid, st)
        else:
            img = inst.caches.img
            matched = img.probe_prefix(it.img_keys, 0, len(it.img_keys))
            if matched:
                img.take_prefix(r.rid, matched, it.img_keys, 0)
            pos = 0
            for e in it.cached_media:
                n = e.shape[0]
                if pos + n > matched:      # miss remainder, in order
                    img.append(r.rid, np.asarray(e)[None, None])
                pos += n
        it.media_installed = True

    def cache_stats(self) -> dict:
        """Hit-rate + sharing counters (feed ``core.costmodel.CacheFeedback``
        and the BENCH_cache scenario)."""
        c = dict(self.cache_counters)
        c["prefix_hit_rate"] = (c["cached_prompt_tokens"] / c["prompt_tokens"]
                                if c["prompt_tokens"] else 0.0)
        c["encode_hit_rate"] = (c["cached_images"] / c["images"]
                                if c["images"] else 0.0)
        cow = ev = 0
        for i in self.instances:
            for cache in (i.caches.kv, i.caches.mla, i.caches.img):
                if cache is not None:
                    cow += cache.n_cow
                    ev += cache.n_evictions
        c["cow_copies"] = cow
        c["evictions"] = ev
        return c

    def abort(self, rid: int, now: Optional[float] = None) -> bool:
        """Cancel a request at any stage: drop it from whichever instance
        holds it (running or waiting) and free its KV/image blocks there.
        Returns False if the rid is unknown or already finished."""
        it = self.items.get(rid)
        if it is None or it.req.done:
            return False
        r = it.req
        now = self.now() if now is None else now
        for inst in self.instances:
            if r in inst.running:
                inst.running.remove(r)
            try:
                inst.waiting.remove(r)
            except ValueError:
                pass
            inst.caches.release(rid)
        r.finish("abort", now)
        self._emit("finish", r, now, finish_reason="abort")
        return True

    @staticmethod
    def _speed(inst: RealInstance, stage: Stage) -> float:
        """Relative service speed for a stage (simulator ``Cluster._speed``):
        decode is bandwidth-bound, encode/prefill compute-bound (paper
        §3.1).  RoleSpec hardware overrides are normalized against the A100
        profile; instances without an override weigh 1.0."""
        spec = inst.spec
        if spec is None or spec.hw is None:
            return float(spec.tp) if spec is not None and spec.tp else 1.0
        tp = spec.tp or 1
        if stage == Stage.DECODE:
            return spec.hw.hbm_bw * tp / A100.hbm_bw
        return spec.hw.peak_flops * tp / A100.peak_flops

    def _route(self, stage: Stage, *, prefer_healthy: bool = True
               ) -> RealInstance:
        """Least outstanding work normalized by instance speed, so
        heterogeneous role groups fill proportionally to capacity.  Healthy
        instances win over degraded ones; raises a typed
        :class:`AdmissionError` when no live instance serves the stage."""
        cands = [i for i in self.instances if stage in i.role]
        if not cands:
            raise AdmissionError(
                f"no live instance serves stage {stage.value!r}")
        if prefer_healthy:
            healthy = [i for i in cands if i.health == "healthy"]
            cands = healthy or cands
        return min(cands, key=lambda i: ((len(i.running) + len(i.waiting) + 1)
                                         / self._speed(i, stage)))

    def _admission_check(self, req: Request):
        """Deadline-aware admission (``shed_policy="deadline"``): reject —
        with a typed error instead of queueing forever — a request whose
        pipeline stages have no live instance or whose KV footprint exceeds
        every candidate instance's whole pool."""
        stages = ([Stage.ENCODE] if req.n_images else []) + [Stage.PREFILL]
        if req.max_new_tokens > 1:
            stages.append(Stage.DECODE)
        for st in stages:
            if not any(st in i.role for i in self.instances):
                raise AdmissionError(
                    f"no live instance serves stage {st.value!r}")
        need = req.prefill_total + req.max_new_tokens + 1 + R.KV_BLOCK
        fits = [i for i in self.instances if Stage.PREFILL in i.role
                and i.caches.kv_tokens_total() >= need]
        if not fits:
            raise AdmissionError(
                f"request needs {need} KV tokens but no live prefill "
                f"instance can ever hold it")

    def _migrate(self, r: Request, src: RealInstance):
        """Hand ``r`` off to an instance of its next stage.  Transfers are
        transactional + checksummed (``paged_cache.migrate_request``); typed
        failures retry with exponential backoff against a (possibly
        different) destination — the source copy survives until an attempt
        fully lands.  Exhausted retries release the source and fall back to
        journal replay, so the request is never lost (DESIGN.md §15)."""
        src.remove(r)
        it = self.items[r.rid]
        last_kind = "?"
        for attempt in range(self.transfer_retries + 1):
            try:
                dst = self._route(r.stage)
            except AdmissionError:
                break                      # no live destination: replay/shed
            # bind keys BEFORE the transfer so the destination's import
            # registers the migrated full blocks in its prefix index
            self._bind_keys(dst, it)
            fault = (self.fault_plan.transfer_fault(self._iter, attempt)
                     if self.fault_plan is not None else None)
            try:
                moved = R.migrate(r.rid, src.caches, dst.caches,
                                  fault=fault, timeout=self.transfer_timeout)
            except TransferError as e:
                last_kind = e.kind
                self.n_transfer_retries += 1
                dst.caches.release(r.rid)  # clear any bound-but-unused keys
                self._log("transfer_retry", rid=r.rid, fault=e.kind,
                          attempt=attempt, dst=dst.iid)
                if attempt < self.transfer_retries:
                    time.sleep(min(self.transfer_backoff * (2 ** attempt),
                                   0.05))
                continue
            self.migrated_bytes += moved
            self.n_migrations += 1
            if r.stage == Stage.PREFILL:
                self._try_prefix_match(dst, it)
            # admit only under the destination's capacity reservation; a
            # full destination parks the request in waiting (its migrated
            # cache is already resident there) until pop_waiting finds room
            if dst.has_capacity(r):
                dst.running.append(r)
            else:
                dst.waiting.append(r)
            return
        # retries exhausted (or no destination): the source copy is of no
        # further use — release it and recover via journal replay
        self.n_transfer_failures += 1
        self._log("transfer_failed", rid=r.rid, fault=last_kind)
        src.caches.release(r.rid)
        self._replay(r, self.now())

    # ------------------------------------------------------------------
    # sampling + event plumbing
    # ------------------------------------------------------------------
    def _emit(self, kind: str, r: Request, now: float, *, token=None,
              finish_reason=None):
        if self.on_event is not None:
            self.on_event(StreamEvent(rid=r.rid, kind=kind, t=now,
                                      token=token,
                                      finish_reason=finish_reason))

    def _sample_args(self, reqs) -> dict:
        """Host-side per-lane sampling controls for a batch (consumed by the
        ``M.sample_from_logits`` head inside the serving step).  The
        PRNG step is the index of the token being sampled (``tokens_out``),
        so a request draws the same stream however it is batched."""
        sp = [r.sampling or SamplingParams() for r in reqs]
        return {
            "temp": np.array([s.temperature for s in sp], np.float32),
            "top_k": np.array([s.top_k for s in sp], np.int32),
            "top_p": np.array([s.top_p for s in sp], np.float32),
            "seed": np.array([self.items[r.rid].seed for r in reqs],
                             np.uint32),
            "step": np.array([r.tokens_out for r in reqs], np.int32),
        }

    def _accept_token(self, r: Request, tok: int, now: float,
                      first: bool) -> bool:
        """Record one sampled token; returns True when it is a stop token
        (the stop token itself is not part of the output)."""
        sp = r.sampling
        if sp is not None and sp.stop and tok in sp.stop:
            return True
        it = self.items[r.rid]
        it.generated.append(tok)
        if it.kv_keys is not None:
            it.kv_keys.append(tok)     # key stream stays ahead of the cache
        self._emit("first_token" if first else "token", r, now, token=tok)
        return False

    def _retire(self, inst: RealInstance, r: Request, now: float,
                reason: Optional[str] = None):
        """A request reached DONE on ``inst``: release its slot and its
        KV/image blocks (on EVERY path, incl. prefill-produced DONE) and
        emit the finish event."""
        if reason is not None:
            r.finish(reason, now)
        inst.remove(r)
        inst.caches.release(r.rid)
        self._emit("finish", r, now, finish_reason=r.finish_reason)

    # ------------------------------------------------------------------
    def _exec_batch(self, inst: RealInstance, batch, now):
        # ``now`` fed the policy's scheduling decisions; token/finish
        # timestamps re-stamp AFTER each blocking runner call so TTFT/TPOT
        # include the compute that produced the token (the runner returns
        # host numpy, so the device work has completed by then)
        items = self.items
        # --- encode (+ joint with decode under hydra's parallel streams);
        # one encode item per image so multi-image requests batch flat
        enc_items = [(r.rid, m) for r, _ in batch.encode
                     for m in items[r.rid].media]
        dec_reqs = list(batch.decode)
        dec_out = None
        if inst.policy.parallel_streams and enc_items and dec_reqs:
            toks = np.array([items[r.rid].generated[-1] for r in dec_reqs])
            dec_out = inst.runner.joint_encode_decode(
                enc_items, [r.rid for r in dec_reqs], toks,
                sample=self._sample_args(dec_reqs))
        else:
            if enc_items:
                inst.runner.encode(enc_items)
            if dec_reqs:
                toks = np.array([items[r.rid].generated[-1] for r in dec_reqs])
                dec_out = inst.runner.decode(
                    [r.rid for r in dec_reqs], toks,
                    sample=self._sample_args(dec_reqs))
        t_dec = self.now()

        # --- encode bookkeeping
        for r, _ in batch.encode:
            if r.stage == Stage.ENCODE:
                if self.prefix_cache:
                    self._cache_encoded(inst, r)
                r.advance_after_encode()
                if Stage.PREFILL not in inst.role:
                    self._migrate(r, inst)
                else:
                    self._try_prefix_match(inst, items[r.rid])

        # --- chunked prefill: ONE batched runner call for every request's
        # chunk this iteration (stage-level batching, paper §4) instead of
        # a per-request Python loop; media chunks embed whole-first
        if batch.prefill:
            work = []
            for r, chunk in batch.prefill:
                it = items[r.rid]
                if (it.cached_media is not None and not it.media_installed
                        and (self.cfg.cross_attention
                             or r.prefill_done < r.image_tokens)):
                    self._install_media(inst, it)
                if r.media_in_lm and r.prefill_done < r.image_tokens:
                    work.append((r, None, True, r.image_tokens))
                else:
                    t0 = r.prefill_done - (r.image_tokens if r.media_in_lm
                                           else 0)
                    t1 = min(t0 + chunk, len(it.prompt))
                    work.append((r, it.prompt[t0:t1], False, t1 - t0))
            pre_toks = inst.runner.prefill_chunks(
                [(r.rid, toks, um) for r, toks, um, _ in work],
                sample=self._sample_args([r for r, *_ in work]))
            now = self.now()
            for (r, _, _, done), tok in zip(work, pre_toks):
                was_replay = r.replayed_tokens > 0
                r.advance_after_prefill_chunk(done, now)
                resumed = was_replay and r.replayed_tokens == 0
                if r.stage in (Stage.DECODE, Stage.DONE) and not resumed:
                    # prefill produced the request's first token (a resumed
                    # replay discards this sample: its re-prefill ends at
                    # the last token already emitted before the failure)
                    if self._accept_token(r, int(tok), now, first=True):
                        self._retire(inst, r, now, reason="stop")
                        continue
                if r.stage == Stage.DECODE and Stage.DECODE not in inst.role:
                    self._migrate(r, inst)
                elif r.stage == Stage.DONE:
                    self._retire(inst, r, now)

        # --- decode bookkeeping
        if dec_reqs and dec_out is not None:
            for r, tok in zip(dec_reqs, dec_out):
                if self._accept_token(r, int(tok), t_dec, first=False):
                    self._retire(inst, r, t_dec, reason="stop")
                    continue
                r.advance_after_decode_step(t_dec)
                if r.stage == Stage.DONE:
                    self._retire(inst, r, t_dec)

    # ------------------------------------------------------------------
    # fault tolerance: health tracking, quarantine, journal replay,
    # deadline-aware shedding (DESIGN.md §15)
    # ------------------------------------------------------------------
    def _log(self, kind: str, **kw):
        self.fault_log.append({"t": self.now(), "kind": kind, **kw})

    @staticmethod
    def _has_ready_work(inst: RealInstance, now: float) -> bool:
        return bool(inst.running) or any(r.ready_at <= now
                                         for r in inst.waiting)

    def _health_progress(self, inst: RealInstance):
        if inst.health == "degraded":
            self._log("instance_recovered", iid=inst.iid)
        inst.stall_count = 0
        inst.health = "healthy"

    def _health_no_progress(self, inst: RealInstance, now: float):
        """One missed progress heartbeat: escalate healthy → degraded →
        dead at the configured thresholds (None disables a transition)."""
        inst.stall_count += 1
        if self.dead_after is not None and inst.stall_count >= self.dead_after:
            self._mark_dead(inst, now, cause=(
                f"no progress for {inst.stall_count} iterations"))
        elif (self.degraded_after is not None
              and inst.stall_count >= self.degraded_after
              and inst.health == "healthy"):
            inst.health = "degraded"
            self._log("instance_degraded", iid=inst.iid,
                      stall_count=inst.stall_count)

    def _mark_dead(self, inst: RealInstance, now: float, cause: str = ""):
        """Quarantine a failed instance: remove it from routing, release
        every cache reference it holds, and replay its stranded requests on
        the survivors.  All device state on the instance is considered
        lost."""
        inst.health = "dead"
        if inst in self.instances:
            self.instances.remove(inst)
        self.dead_instances.append(inst)
        stranded = list(inst.running) + list(inst.waiting)
        inst.running.clear()
        inst.waiting.clear()
        for rid in sorted(inst.caches.live_rids()):
            inst.caches.release(rid)
        self._log("instance_dead", iid=inst.iid, cause=cause,
                  stranded=[r.rid for r in stranded])
        for r in stranded:
            if not r.done:
                self._replay(r, now)

    def kill_instance(self, iid: int, now: Optional[float] = None) -> bool:
        """Operator/bench hook: fail instance ``iid`` immediately (same
        path as an injected crash).  Returns False for an unknown iid."""
        for inst in list(self.instances):
            if inst.iid == iid:
                self._mark_dead(inst, self.now() if now is None else now,
                                cause="killed")
                return True
        return False

    def _drop_everywhere(self, r: Request):
        """Remove every trace of ``r`` from live instances (queues + cache
        references).  Defensive: recovery paths must never leave a stale
        copy behind."""
        for inst in self.instances:
            inst.remove(r)
            try:
                inst.waiting.remove(r)
            except ValueError:
                pass
            inst.caches.release(r.rid)

    def _replay(self, r: Request, now: float):
        """Re-dispatch a stranded request from its journal: rebuild the
        prefill context as ``original prompt + generated[:-1]`` so the
        re-prefill ends at the last token already emitted, fast-forward
        ``tokens_out`` (see ``Request.advance_after_prefill_chunk``), and
        resume decode at the exact per-lane PRNG step — bit-exact
        continuation for greedy and seeded sampling.  Surviving prefix /
        embedding-cache blocks make the re-prefill cheap (DESIGN.md §14)."""
        it = self.items[r.rid]
        j = it.journal
        r.n_recoveries += 1
        if r.n_recoveries > self.max_recoveries:
            self._shed(r, now, why="recovery limit exceeded")
            return
        self._drop_everywhere(r)
        if j.media_hashes:
            cur = it.media_hashes if it.media_hashes is not None \
                else [_media_hash(m) for m in it.media]
            if tuple(cur) != tuple(j.media_hashes):
                self._shed(r, now, why="media integrity check failed")
                return
        k = len(it.generated)
        if k > 1:
            it.prompt = np.concatenate(
                [np.asarray(j.prompt),
                 np.asarray(it.generated[:k - 1], dtype=j.prompt.dtype)])
        else:
            it.prompt = np.asarray(j.prompt)
        r.prompt_tokens = len(it.prompt)
        r.replayed_tokens = k
        r.prefill_done = 0
        r.tokens_out = 0
        r.prefix_cached_tokens = 0
        r.ready_at = now
        r.stage = Stage.ENCODE if r.n_images > 0 else Stage.PREFILL
        r.encode_cached = False
        it.media_installed = False
        it.cached_media = None
        if self.prefix_cache and it.media:
            # survivors may still hold the encoded media: re-take the
            # encode-skip decision against the embedding cache
            cached = [self.embed_cache.get(h) for h in it.media_hashes]
            if all(c is not None for c in cached):
                it.cached_media = cached
                r.encode_cached = True
                r.stage = Stage.PREFILL
        try:
            inst = self._route(r.stage)
        except AdmissionError:
            self._shed(r, now, why="no live instance for replay")
            return
        self.n_replays += 1
        self._log("replay", rid=r.rid, tokens_replayed=k, dst=inst.iid)
        self._bind_keys(inst, it)
        if r.stage == Stage.PREFILL:
            self._try_prefix_match(inst, it)
        inst.enqueue(r)

    def _shed(self, r: Request, now: float, why: str = ""):
        """Give up on a request: drop it everywhere, free its blocks, and
        finish it with reason "error" so its stream terminates cleanly."""
        self._drop_everywhere(r)
        self.n_shed += 1
        self._log("shed", rid=r.rid, why=why)
        r.finish("error", now)
        self._emit("finish", r, now, finish_reason="error")

    def _capacity_degraded(self) -> bool:
        return bool(self.dead_instances) or any(i.health != "healthy"
                                                for i in self.instances)

    def _shed_doomed(self, now: float):
        """Deadline-aware shedding (``shed_policy="deadline"``): while
        capacity is durably degraded, queued requests whose TTFT deadline
        is already blown past recovery (``shed_ttft_factor`` x the SLO)
        finish with "error" and free their blocks rather than rotting in a
        queue they will never leave in time."""
        if not self._capacity_degraded():
            return
        for inst in list(self.instances):
            for r in list(inst.waiting):
                if (r.first_token_time is None and r.slo is not None
                        and now - r.arrival
                        > self.shed_ttft_factor * r.slo.ttft):
                    self._shed(r, now, why="TTFT deadline unattainable")

    def _recover_failed_batch(self, inst: RealInstance, batch, now: float):
        """A batch execution died (allocation failure mid-step): the
        touched requests' cache state on ``inst`` is suspect — release and
        replay each of them; the instance itself stays up but takes a
        health strike."""
        reqs = {r.rid: r for r, _ in batch.encode}
        reqs.update({r.rid: r for r, _ in batch.prefill})
        reqs.update({r.rid: r for r in batch.decode})
        self._log("batch_failed", iid=inst.iid, rids=sorted(reqs))
        for r in reqs.values():
            if not r.done:
                inst.remove(r)
                inst.caches.release(r.rid)
                self._replay(r, now)
        self._health_no_progress(inst, now)

    def fault_stats(self) -> dict:
        return {"iterations": self._iter,
                "replays": self.n_replays,
                "shed": self.n_shed,
                "transfer_retries": self.n_transfer_retries,
                "transfer_failures": self.n_transfer_failures,
                "dead_instances": [i.iid for i in self.dead_instances],
                "health": {i.iid: i.health for i in self.instances},
                "log": list(self.fault_log)}

    # ------------------------------------------------------------------
    def _stall_report(self) -> str:
        lines = ["no instance can build a batch but requests remain queued "
                 "(capacity deadlock?)"]
        for i in self.instances:
            free_kv = i.caches.kv_tokens_free()
            img_free = (i.caches.img.available_blocks
                        if i.caches.img is not None else "-")
            lines.append(
                f"  inst {i.iid} [{i.role_name}] health={i.health} "
                f"running={len(i.running)} "
                f"waiting={len(i.waiting)} kv_tokens_free={free_kv} "
                f"img_blocks_free={img_free}")
            for r in list(i.waiting)[:4]:
                lines.append(
                    f"    waiting rid={r.rid} stage={r.stage.value} "
                    f"need={r.prefill_remaining + r.max_new_tokens + 1} "
                    f"ready_at={r.ready_at:.3f}")
        return "\n".join(lines)

    def stall_diagnosis(self) -> tuple:
        """Split the stall guard's diagnostic into its two distinct causes:
        ``("no_progress", msg)`` when some instance sits on ready work
        without executing it (a wedged instance — the health state
        machine's territory), else ``("deadlock", msg)`` for the legacy
        capacity-deadlock report."""
        now = self.now()
        sick = [i for i in self.instances
                if i.stall_count > 0 and self._has_ready_work(i, now)]
        if sick:
            lines = ["instance(s) hold ready work but make no progress "
                     "(wedged instance?)"]
            for i in sick:
                lines.append(
                    f"  inst {i.iid} [{i.role_name}] health={i.health} "
                    f"stall_count={i.stall_count} running={len(i.running)} "
                    f"waiting={len(i.waiting)}")
            return "no_progress", "\n".join(lines)
        return "deadlock", self._stall_report()

    def step(self, now: Optional[float] = None) -> bool:
        """ONE reentrant scheduler iteration: build and execute a batch on
        every instance.  Returns True when any instance had work.  This is
        the serving loop body — ``run()`` iterates it to completion, the
        streaming ``Engine`` drives it continuously while ``submit()`` /
        ``abort()`` land between iterations (continuous batching).

        Fault hooks (DESIGN.md §15): the iteration counter advances only on
        non-idle steps (idle spins between open-loop arrivals don't burn
        fault-plan time); each instance is checked against the plan for
        crashes / stalls / allocation failures, progress heartbeats feed the
        health state machine, and — under ``shed_policy="deadline"`` —
        doomed queued requests are shed after the instance sweep."""
        t = self.now() if now is None else now
        if not self.idle():
            self._iter += 1
        plan = self.fault_plan
        any_work = False
        for inst in list(self.instances):
            if plan is not None and plan.crash(self._iter, inst.iid):
                self._mark_dead(inst, t, cause="injected crash")
                continue
            if plan is not None and plan.stalled(self._iter, inst.iid):
                # wedged: builds nothing this iteration; only count the
                # missed heartbeat when it actually had runnable work
                if self._has_ready_work(inst, t):
                    self._health_no_progress(inst, t)
                continue
            batch = inst.policy.build(inst, t)
            if batch.empty:
                continue
            any_work = True
            inject_alloc = (plan is not None
                            and plan.alloc_fail(self._iter, inst.iid))
            pools = [c for c in (inst.caches.kv, inst.caches.mla,
                                 inst.caches.img) if c is not None]
            if inject_alloc:
                for c in pools:
                    c.fail_alloc = 1
            try:
                self._exec_batch(inst, batch, t)
            except MemoryError:
                self._recover_failed_batch(inst, batch, self.now())
            else:
                self._health_progress(inst)
            finally:
                if inject_alloc:
                    for c in pools:
                        c.fail_alloc = 0
        if self.shed_policy == "deadline":
            self._shed_doomed(self.now() if now is None else now)
        return any_work

    def idle(self) -> bool:
        return all(not i.waiting and not i.running for i in self.instances)

    def deadlock_candidate(self) -> bool:
        """True when pending work exists and ALL of it is ready now: if a
        step still schedules nothing, no amount of waiting can change the
        state (capacity deadlock) — callers count these and raise the
        ``_stall_report`` diagnostic."""
        now = self.now()
        pending = [r for i in self.instances
                   for r in list(i.waiting) + i.running]
        return bool(pending) and all(r.ready_at <= now for r in pending)

    def run(self, max_iters: int = 10_000, stall_iters: int = 100) -> dict:
        """Closed-loop back-compat shim: step until every submitted request
        finishes, with the capacity-deadlock stall guard."""
        stalled = 0
        for _ in range(max_iters):
            if self.step():
                stalled = 0
                continue
            if self.idle():
                break
            # requests remain but nothing was scheduled: if ANY pending
            # request only becomes ready in the future, waiting can
            # still unblock things (e.g. its reservation parks another
            # request) — keep spinning.  If every pending request is
            # ready and still nothing schedules, that is a capacity
            # deadlock: diagnose it instead of silently busy-spinning
            # to max_iters.
            if self.deadlock_candidate():
                stalled += 1
                if stalled >= stall_iters:
                    raise RuntimeError(self.stall_diagnosis()[1])
            else:
                stalled = 0
                time.sleep(0.001)  # future arrival: wait, don't hot-spin
        return {rid: it for rid, it in self.items.items()}
