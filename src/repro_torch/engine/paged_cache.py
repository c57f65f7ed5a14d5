"""Paged cache management (paper §4.5) + prefix/content block sharing
(DESIGN.md §14).

Centralized, paged memory for both the KV cache and the image-token cache
with a *unified* management + transfer interface: the image cache is a
one-layer, single-tensor cache (block size = one image), the KV cache is a
multi-layer, two-tensor cache (block size 16).  Fixed-size recurrent state
(SSM/MLA-conv) lives in a per-request StateStore with the same transfer
interface, so migration code is cache-kind-agnostic.

Two storage backends share the layout ``[T, L, num_blocks, bs, width]`` and
the full transfer surface:

  PagedCache        host numpy — migration endpoints and tests
  DevicePagedCache  one torch tensor on the device — the serving steps read
                    pages through the paged-attention kernels and append
                    via the fused cache-write kernel, in place, without
                    ever copying the cache to the host (DESIGN.md §11)

Block sharing (``sharing=True``): every block carries a refcount equal to
its occurrences across block tables.  Full blocks register in a
hash-of-key-prefix chain index; a later request whose key stream matches a
registered chain adopts those blocks (``probe_prefix``/``take_prefix``)
instead of recomputing them.  All writes go through ``_prepare_write``,
which copy-on-writes any shared block before the scatter lands, so a
sharer can never corrupt another request's pages.  Blocks whose refcount
reaches zero but whose content is still indexed park in an LRU *evictable*
pool — reclaimed (and unindexed) only when the allocator runs dry.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.engine.faults import (TransferError, corrupt_payload,
                                       payload_checksum)
from repro_torch.kernels.cache_write.ops import paged_chunk_write


class BlockAllocator:
    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.free = list(range(num_blocks - 1, -1, -1))

    def alloc(self, n: int) -> list:
        if n > len(self.free):
            raise MemoryError(f"cache OOM: need {n}, free {len(self.free)}")
        return [self.free.pop() for _ in range(n)]

    def release(self, blocks: list):
        self.free.extend(blocks)

    @property
    def n_free(self) -> int:
        return len(self.free)


@dataclass
class PagedCacheSpec:
    n_tensors: int       # 2 for KV (k+v), 1 for image tokens
    n_layers: int
    block_size: int      # tokens per block (16 KV / one image for media)
    width: int           # per-token feature width
    num_blocks: int
    dtype: object = np.float32   # numpy dtype, or a torch dtype (device only)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _mix(prev: int, key_block: tuple) -> int:
    """Chain-hash one block's key slice onto the running prefix hash.

    Python's tuple/int hashing is deterministic within a process (ints are
    not salted), which is the lifetime of a cache.  Production would use a
    keyed cryptographic hash; collisions here mean silent false sharing.
    """
    return hash((prev, key_block))


class PagedCacheBase:
    """Shared block-table bookkeeping for both storage backends.

    With ``sharing`` enabled the allocator is refcount-aware: ``free(rid)``
    *releases references* rather than blocks, and full blocks register in
    the prefix index so later requests can adopt them.
    """

    def __init__(self, spec: PagedCacheSpec, *, sharing: bool = False):
        self.spec = spec
        self.allocator = BlockAllocator(spec.num_blocks)
        self.tables: dict[int, list] = {}    # rid -> [block ids]
        self.lengths: dict[int, int] = {}    # rid -> tokens stored
        self.sharing = sharing
        # --- sharing state (inert when sharing is off) ---
        self.refcount = [0] * spec.num_blocks
        self.hash_block: dict[int, int] = {}   # chain hash -> block id
        self.block_hash: dict[int, int] = {}   # block id -> chain hash
        self.evictable: "OrderedDict[int, None]" = OrderedDict()  # LRU
        self.keys: dict[int, list] = {}        # rid -> live key stream
        self.roots: dict[int, int] = {}        # rid -> chain root seed
        self._chain: dict[int, tuple] = {}     # rid -> (n_blocks_hashed, h)
        self.n_evictions = 0
        self.n_cow = 0
        # fault injection (DESIGN.md §15): when > 0, the next that-many
        # allocations raise MemoryError — the server sets this for one
        # scheduler iteration to exercise the batch-recovery path
        self.fail_alloc = 0

    # ------------------------------------------------------------------
    # allocation / release (refcount-aware)
    # ------------------------------------------------------------------
    @property
    def available_blocks(self) -> int:
        """Blocks obtainable right now: truly free + evictable cached."""
        return self.allocator.n_free + len(self.evictable)

    def _alloc(self, n: int) -> list:
        """Allocate ``n`` blocks at refcount 1, evicting LRU cached blocks
        (and dropping their index entries) when the free list runs dry."""
        if self.fail_alloc > 0:
            self.fail_alloc -= 1
            raise MemoryError("injected allocation failure")
        while self.allocator.n_free < n and self.evictable:
            b, _ = self.evictable.popitem(last=False)
            h = self.block_hash.pop(b, None)
            if h is not None:
                self.hash_block.pop(h, None)
            self.allocator.release([b])
            self.n_evictions += 1
        blocks = self.allocator.alloc(n)
        for b in blocks:
            self.refcount[b] = 1
        return blocks

    def _decref(self, blocks: list):
        dead = []
        for b in blocks:
            rc = self.refcount[b] = self.refcount[b] - 1
            if rc < 0:
                raise AssertionError(f"double free of block {b}")
            if rc == 0:
                if b in self.block_hash:
                    self.evictable[b] = None       # park: content reusable
                    self.evictable.move_to_end(b)
                else:
                    dead.append(b)
        if dead:
            self.allocator.release(dead)

    def _ensure_capacity(self, rid: int, n_tokens: int):
        bs = self.spec.block_size
        table = self.tables.setdefault(rid, [])
        self.lengths.setdefault(rid, 0)
        need_blocks = -(-n_tokens // bs)
        if need_blocks > len(table):
            table.extend(self._alloc(need_blocks - len(table)))

    def can_fit(self, n_tokens: int) -> bool:
        return -(-n_tokens // self.spec.block_size) <= self.available_blocks

    def free(self, rid: int):
        """Release the request's *references*.  A shared block survives in
        other tables; an indexed refcount-zero block parks in the evictable
        pool; everything else returns to the allocator.  This is the single
        release path for every retire/abort/migrate site (DESIGN.md §14)."""
        blocks = self.tables.pop(rid, [])
        self.lengths.pop(rid, None)
        self.keys.pop(rid, None)
        self.roots.pop(rid, None)
        self._chain.pop(rid, None)
        self._decref(blocks)

    # ------------------------------------------------------------------
    # prefix index: probe / adopt / register
    # ------------------------------------------------------------------
    def set_keys(self, rid: int, keys: list, root: int = 0):
        """Bind the request's *live* key stream (token ids / media keys —
        the caller keeps appending to the same list as decode proceeds) so
        commits can register completed blocks lazily."""
        self.keys[rid] = keys
        self.roots[rid] = root

    def probe_prefix(self, keys: list, root: int, limit: int) -> int:
        """Longest indexed prefix of ``keys`` (whole blocks), capped at
        ``limit`` tokens.  Pure lookup: no refcounts move."""
        if not self.sharing or limit <= 0:
            return 0
        bs = self.spec.block_size
        h, n = root, 0
        while n + bs <= len(keys) and n < limit:
            h2 = _mix(h, tuple(keys[n:n + bs]))
            if h2 not in self.hash_block:
                break
            h = h2
            n += bs
        return min(n, limit)

    def take_prefix(self, rid: int, matched: int, keys: list, root: int):
        """Adopt the first ``matched`` tokens' blocks (as returned by
        ``probe_prefix``): incref each chain block into ``rid``'s table.
        ``matched`` may end mid-block (the hit cap); the partial tail block
        is adopted whole and copy-on-written if ``rid`` ever writes it."""
        if matched <= 0:
            return
        if self.tables.get(rid):
            raise AssertionError(f"take_prefix on non-empty table rid={rid}")
        bs = self.spec.block_size
        n_blocks = -(-matched // bs)
        h = root
        blocks = []
        n_full_hash = (0, root)
        for k in range(n_blocks):
            h = _mix(h, tuple(keys[k * bs:(k + 1) * bs]))
            b = self.hash_block[h]
            if self.refcount[b] == 0:
                self.evictable.pop(b)              # revive from the pool
            self.refcount[b] += 1
            blocks.append(b)
            if (k + 1) * bs <= matched:
                n_full_hash = (k + 1, h)
        self.tables[rid] = blocks
        self.lengths[rid] = matched
        # chain resumes after the fully-covered blocks; the partial tail
        # re-hashes with rid's OWN keys once rid fills it
        self._chain[rid] = n_full_hash

    def _maybe_register(self, rid: int):
        """Register every newly-completed full block of ``rid`` in the
        prefix index (called from every commit path).  No-op without keys
        or when sharing is off."""
        if not self.sharing:
            return
        keys = self.keys.get(rid)
        if keys is None:
            return
        bs = self.spec.block_size
        table = self.tables.get(rid, [])
        n_full = self.lengths.get(rid, 0) // bs
        k, h = self._chain.get(rid, (0, self.roots.get(rid, 0)))
        while k < n_full and (k + 1) * bs <= len(keys) and k < len(table):
            h = _mix(h, tuple(keys[k * bs:(k + 1) * bs]))
            b = table[k]
            if h not in self.hash_block and b not in self.block_hash:
                self.hash_block[h] = b
                self.block_hash[b] = h
            k += 1
        self._chain[rid] = (k, h)

    # ------------------------------------------------------------------
    # copy-on-write
    # ------------------------------------------------------------------
    def _prepare_write(self, rid: int, start: int, n: int):
        """Make token positions [start, start+n) of ``rid`` safely writable:
        any touched block that is shared (refcount > 1) is duplicated first
        (COW) so the scatter cannot land in another request's pages; a
        sole-owned but still-indexed block is unindexed instead (cheaper —
        its registered content is about to diverge)."""
        if n <= 0 or not self.sharing:
            return
        bs = self.spec.block_size
        table = self.tables.get(rid, [])
        pairs = []
        for k in range(start // bs, (start + n - 1) // bs + 1):
            if k >= len(table):
                break
            b = table[k]
            if self.refcount[b] > 1:
                [nb] = self._alloc(1)
                table[k] = nb
                pairs.append((b, nb))
                self.refcount[b] -= 1     # still > 0: other holders remain
                self.n_cow += 1
            elif b in self.block_hash:
                h = self.block_hash.pop(b)
                self.hash_block.pop(h, None)
        if pairs:
            self._copy_blocks(pairs)

    def _copy_blocks(self, pairs: list):
        raise NotImplementedError

    def _slot_arrays(self, rid: int, start: int, n: int):
        """(block ids, in-block offsets) for token positions [start, start+n)."""
        pos = np.arange(start, start + n)
        bs = self.spec.block_size
        table = np.asarray(self.tables.get(rid, []), np.int64)
        return table[pos // bs], pos % bs

    def row_slots(self, rid: int, start: int, n: int) -> np.ndarray:
        """Within-plane row slots (``block * bs + offset``) for token
        positions [start, start+n) — the device-side gather/scatter
        addresses of those tokens."""
        blks, offs = self._slot_arrays(rid, start, n)
        return (blks * self.spec.block_size + offs).astype(np.int32)

    # ------------------------------------------------------------------
    # migration transfer interface (paper §4.3, unified for KV/image)
    # ------------------------------------------------------------------
    def export_control(self, rid: int) -> dict:
        """Step 1: control info (page table metadata), no bulk data."""
        return {"rid": rid, "length": self.lengths.get(rid, 0),
                "blocks": list(self.tables.get(rid, []))}

    def nbytes(self, rid: int) -> int:
        s = self.spec
        return (len(self.tables.get(rid, [])) * s.n_tensors * s.n_layers *
                s.block_size * s.width * _itemsize(s.dtype))


class PagedCache(PagedCacheBase):
    """Host (numpy) paged cache.  Storage: [T, L, num_blocks, bs, width]."""

    def __init__(self, spec: PagedCacheSpec, *, sharing: bool = False):
        super().__init__(spec, sharing=sharing)
        s = spec
        self.data = np.zeros((s.n_tensors, s.n_layers, s.num_blocks,
                              s.block_size, s.width), s.dtype)

    def _copy_blocks(self, pairs: list):
        src = [a for a, _ in pairs]
        dst = [b for _, b in pairs]
        self.data[:, :, dst] = self.data[:, :, src]

    def append(self, rid: int, values: np.ndarray):
        """values: [T(=n_tensors), L, n_new, width] appended at the tail."""
        n_new = values.shape[2]
        start = self.lengths.get(rid, 0)
        self._ensure_capacity(rid, start + n_new)
        self._prepare_write(rid, start, n_new)
        blks, offs = self._slot_arrays(rid, start, n_new)
        self.data[:, :, blks, offs] = np.asarray(values)
        self.lengths[rid] = start + n_new
        self._maybe_register(rid)

    def gather(self, rid: int) -> np.ndarray:
        """Contiguous [n_tensors, L, length, width] view-copy."""
        n = self.lengths.get(rid, 0)
        blks, offs = self._slot_arrays(rid, 0, n)
        return self.data[:, :, blks, offs]

    def read_blocks(self, rid: int) -> np.ndarray:
        """Step 3: source-side bulk read of the request's blocks."""
        table = self.tables.get(rid, [])
        return self.data[:, :, table].copy()

    def import_blocks(self, rid: int, length: int, payload: np.ndarray):
        """Step 2+3 target side: allocate pages, then write pulled blocks."""
        n_blocks = payload.shape[2]
        blocks = self._alloc(n_blocks)
        self.tables[rid] = blocks
        self.lengths[rid] = length
        self.data[:, :, blocks] = np.asarray(payload)
        self._maybe_register(rid)


class DevicePagedCache(PagedCacheBase):
    """Device-resident paged cache: block storage lives as one torch tensor
    of the same ``[T, L, num_blocks(+1), bs, width]`` layout on ``device``,
    so the serving steps hand pages + block tables straight to the
    paged-attention / cache-write kernels without any host round-trip.

    One extra *scratch* block (physical index ``num_blocks``) absorbs the
    writes and reads of padded batch lanes introduced by batch-size
    bucketing; the allocator never hands it out.  Migration payloads cross
    as host numpy arrays (the transfer checksum reads them with
    ``np.asarray``); bf16 pools travel as their int16 bit patterns, since
    numpy has no bf16.
    """

    def __init__(self, spec: PagedCacheSpec, *, sharing: bool = False,
                 device="cuda"):
        super().__init__(spec, sharing=sharing)
        self.device = resolve_device(device)
        s = spec
        self.data = torch.zeros((s.n_tensors, s.n_layers, s.num_blocks + 1,
                                 s.block_size, s.width),
                                dtype=_torch_dtype(s.dtype),
                                device=self.device)

    @property
    def scratch_block(self) -> int:
        return self.spec.num_blocks

    def _index(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _copy_blocks(self, pairs: list):
        """The COW copy: block columns ``src`` land at ``dst`` in place."""
        src = self._index([a for a, _ in pairs])
        dst = self._index([b for _, b in pairs])
        self.data.index_copy_(2, dst, self.data.index_select(2, src))

    # -- host-interop append/gather (media install, migration) -------------
    def append(self, rid: int, values):
        """values: [T, L, n_new, width] (numpy or tensor) appended at the
        tail through the fused cache-write kernel, in place: the pool seen
        as T*L single-layer planes takes the rows of every plane in one
        launch."""
        n_new = values.shape[2]
        start = self.lengths.get(rid, 0)
        self._ensure_capacity(rid, start + n_new)
        self._prepare_write(rid, start, n_new)
        T, L, NB, bs, w = self.data.shape
        rows = torch.as_tensor(values).to(self.device, self.data.dtype) \
            .contiguous()
        slots = torch.as_tensor(self.row_slots(rid, start, n_new),
                                device=self.device)
        paged_chunk_write(self.data.view(T * L, 1, NB, bs, w), 0,
                          rows.reshape(T * L, 1, n_new, w), slots[None])
        self.lengths[rid] = start + n_new
        self._maybe_register(rid)

    def gather(self, rid: int) -> torch.Tensor:
        """Contiguous [n_tensors, L, length, width] *device* tensor."""
        n = self.lengths.get(rid, 0)
        blks, offs = self._slot_arrays(rid, 0, n)
        return self.data[:, :, self._index(blks), self._index(offs)]

    def read_blocks(self, rid: int) -> np.ndarray:
        """Source-side bulk read of the request's blocks, as a host copy."""
        x = self.data.index_select(2, self._index(self.tables.get(rid, [])))
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy()

    def import_blocks(self, rid: int, length: int, payload):
        n_blocks = payload.shape[2]
        blocks = self._alloc(n_blocks)
        self.tables[rid] = blocks
        self.lengths[rid] = length
        t = torch.from_numpy(np.ascontiguousarray(payload))
        if t.dtype == torch.int16 and self.data.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        self.data.index_copy_(2, self._index(blocks),
                              t.to(self.device, self.data.dtype))
        self._maybe_register(rid)

    # -- decode hot path ---------------------------------------------------
    def prepare_decode(self, rids: list, batch_pad: int, pages_pad: int):
        """Per-step control tensors for the paged decode step.

        Allocates one-token headroom per request (copy-on-writing a shared
        tail block), then returns host int32 arrays (tiny; the bulk cache
        never moves):

          tables [batch_pad, pages_pad]  block table, scratch-padded
          slots  [batch_pad]             within-plane row slot (block*bs+off)
                                         of the token being appended
        Padded lanes point at the scratch block so their writes land off to
        the side and their (discarded) reads stay in bounds.
        """
        bs = self.spec.block_size
        scratch = self.scratch_block
        tables = np.full((batch_pad, pages_pad), scratch, np.int32)
        slots = np.full((batch_pad,), scratch * bs, np.int32)
        for b, rid in enumerate(rids):
            n = self.lengths.get(rid, 0)
            self._ensure_capacity(rid, n + 1)
            self._prepare_write(rid, n, 1)
            table = self.tables[rid]
            tables[b, :len(table)] = table
            slots[b] = table[n // bs] * bs + n % bs
        return tables, slots

    def commit_decode(self, rids: list):
        """Account the one token per request that the kernel just wrote."""
        for rid in rids:
            self.lengths[rid] = self.lengths.get(rid, 0) + 1
            self._maybe_register(rid)

    # -- batched chunked prefill -------------------------------------------
    def prepare_prefill(self, rids: list, n_new: list, batch_pad: int,
                        chunk_pad: int, pages_pad: int):
        """Per-chunk control tensors for the batched prefill step.

        Allocates ``n_new[i]``-token headroom per request (copy-on-writing
        any shared block the chunk lands in), then returns host int32
        arrays (tiny; the bulk cache never moves):

          tables [batch_pad, pages_pad]   block table, scratch-padded
          slots  [batch_pad, chunk_pad]   within-plane row slot of each
                                          chunk token being appended
        Padded lanes and padded chunk positions point at the scratch block
        so their writes land off to the side and their (discarded) reads
        stay in bounds.
        """
        bs = self.spec.block_size
        scratch = self.scratch_block
        tables = np.full((batch_pad, pages_pad), scratch, np.int32)
        slots = np.full((batch_pad, chunk_pad), scratch * bs, np.int32)
        for b, (rid, n) in enumerate(zip(rids, n_new)):
            start = self.lengths.get(rid, 0)
            self._ensure_capacity(rid, start + n)
            self._prepare_write(rid, start, n)
            table = self.tables[rid]
            tables[b, :len(table)] = table
            slots[b, :n] = self.row_slots(rid, start, n)
        return tables, slots

    def commit_prefill(self, rids: list, n_new: list):
        """Account the chunk tokens the kernel just wrote per request."""
        for rid, n in zip(rids, n_new):
            self.lengths[rid] = self.lengths.get(rid, 0) + n
            self._maybe_register(rid)


class StateStore:
    """Fixed-size per-request state (SSM state/conv, MLA rope cache, cross-KV)
    with the same export/import surface as PagedCache.  Leaves are host
    numpy arrays or torch tensors (the Mamba state stays on its device);
    a transfer hands them over as they are, checksummed."""

    def __init__(self):
        self.store: dict[int, dict] = {}

    def put(self, rid: int, tree: dict):
        self.store[rid] = tree

    def get(self, rid: int) -> Optional[dict]:
        return self.store.get(rid)

    def free(self, rid: int):
        self.store.pop(rid, None)

    def export_control(self, rid: int) -> dict:
        return {"rid": rid, "keys": sorted(self.store.get(rid, {}).keys())}

    def read_blocks(self, rid: int) -> dict:
        return self.store.get(rid, {})

    def import_blocks(self, rid: int, payload: dict):
        self.store[rid] = payload

    def nbytes(self, rid: int) -> int:
        tree = self.store.get(rid, {})
        total = 0

        def walk(x):
            nonlocal total
            if isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif hasattr(x, "nbytes"):
                total += x.nbytes
        walk(tree)
        return total


def migrate_request(rid: int, src, dst, *, fault: Optional[str] = None,
                    timeout: Optional[float] = None) -> int:
    """Transactional pull-based migration (paper §4.3, hardened per
    DESIGN.md §15) over the unified interface.

    Three phases, so a failed transfer never strands the request:

    1. *read*: the source exports control info and bulk payloads for EVERY
       store, and each payload is checksummed end-to-end (blake2b) —
       StateStore payloads are snapshotted since ``read_blocks`` returns
       the live dict.
    2. *verify + import*: each payload is re-checksummed against its phase-1
       digest (detecting wire corruption) and imported at the destination.
       Any failure — checksum mismatch, destination OOM, wall-clock timeout
       — rolls back every import already landed and raises a typed
       :class:`~repro_torch.engine.faults.TransferError`; the SOURCE copy is
       untouched, so the caller can retry against the same or another
       destination.
    3. *release*: only after every store imported does the source release
       its references (blocks shared with other requests survive).

    ``fault`` injects a wire failure for this attempt ("drop" loses the
    payload before import; "corrupt" bit-flips one payload so the checksum
    must catch it).  ``timeout`` bounds the whole transfer in seconds.
    Returns bytes moved.
    """
    t0 = time.monotonic()
    staged = []           # (s_cache, d_cache, ctrl, payload, checksum)
    moved = 0
    for s_cache, d_cache in zip(src, dst):                   # phase 1: read
        ctrl = s_cache.export_control(rid)
        payload = s_cache.read_blocks(rid)
        if not isinstance(s_cache, PagedCacheBase):
            payload = dict(payload)        # snapshot the live StateStore dict
        moved += s_cache.nbytes(rid)
        staged.append([s_cache, d_cache, ctrl, payload,
                       payload_checksum(payload)])
    if fault == "drop":
        raise TransferError("drop",
                            f"rid={rid}: transfer payload lost in flight")
    if fault == "corrupt" and staged:
        staged[0][3] = corrupt_payload(staged[0][3])
    if timeout is not None and time.monotonic() - t0 > timeout:
        raise TransferError("timeout",
                            f"rid={rid}: transfer exceeded {timeout}s")
    imported = []
    try:                                         # phase 2: verify + import
        for s_cache, d_cache, ctrl, payload, digest in staged:
            if payload_checksum(payload) != digest:
                raise TransferError(
                    "corrupt", f"rid={rid}: transfer checksum mismatch")
            try:
                if isinstance(s_cache, PagedCacheBase):
                    d_cache.import_blocks(rid, ctrl["length"], payload)
                else:
                    d_cache.import_blocks(rid, payload)
            except MemoryError as e:
                raise TransferError("oom", f"rid={rid}: {e}") from e
            imported.append(d_cache)
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TransferError(
                    "timeout", f"rid={rid}: transfer exceeded {timeout}s")
    except TransferError:
        for d_cache in imported:                 # roll back partial imports
            d_cache.free(rid)
        raise
    for s_cache, *_ in staged:                   # phase 3: release source
        s_cache.free(rid)
    return moved
