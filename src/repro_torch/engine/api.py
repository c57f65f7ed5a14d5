"""Streaming engine API (DESIGN.md §13).

``Engine`` turns :class:`~repro_torch.engine.server.HydraServer` — a step-driven
continuous-batching scheduler since the `step()` extraction — into an
open-loop serving surface:

  generate(prompt, media=..., sampling=..., slo=...)  ->  RequestStream
      per-request stream of StreamEvents: the first token, token deltas,
      and a finish event carrying the reason ("length" | "stop" | "abort")
  submit() / events()     the same, split into enqueue + stream halves;
                          submit is legal at ANY time — requests join the
                          live loop (continuous batching), they are not
                          collected up front
  abort(rid)              cancel at any stage; the request's KV/image
                          blocks are freed on whichever instance holds it
                          (a retired/unknown rid is a no-op returning False)
  step()                  drive one scheduler iteration by hand
  start() / close()       background serve loop (open-loop serving);
                          ``close()`` gracefully drains in-flight requests
                          with a configurable timeout, then aborts the
                          remainder and reclaims their blocks

Two driving modes share one code path:

  step-driven   no thread: iterating a ``RequestStream`` (or calling
                ``step()``) advances the whole engine, so every in-flight
                request progresses while you consume one stream
  threaded      ``start()`` spawns the serve loop; streams then block on a
                condition variable until their events arrive

All public methods are thread-safe: a single re-entrant lock serializes
scheduler iterations with submissions/aborts, so requests and cancels land
*between* iterations, never inside one.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.request import SLO, SamplingParams, StreamEvent
from repro_torch.engine.server import HydraServer, ServeItem


class RequestStream:
    """Iterable over one request's StreamEvents (ends after "finish")."""

    def __init__(self, engine: "Engine", rid: int):
        self.engine = engine
        self.rid = rid

    def __iter__(self) -> Iterator[StreamEvent]:
        return self.engine.events(self.rid)

    def tokens(self) -> list:
        """Drain the stream; returns the full token-id list."""
        for _ in self:
            pass
        return list(self.engine.result(self.rid).generated)

    def abort(self) -> bool:
        return self.engine.abort(self.rid)


class Engine:
    """Streaming facade over a live ``HydraServer`` (see module docstring).
    ``server_kw`` passes on to the server, ``device`` (default ``"cuda"``)
    included."""

    def __init__(self, cfg, params, disagg, **server_kw):
        self.server = HydraServer(cfg, params, disagg, **server_kw)
        self.server.on_event = self._on_event
        self._cv = threading.Condition(threading.RLock())
        self._queues: dict[int, deque] = {}
        self._finished: set[int] = set()
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = False

    # ------------------------------------------------------------------
    # event plumbing (called from inside server.step, under the lock)
    # ------------------------------------------------------------------
    def _on_event(self, ev: StreamEvent):
        q = self._queues.get(ev.rid)
        if q is not None:
            q.append(ev)
        if ev.kind == "finish":
            self._finished.add(ev.rid)
        self._cv.notify_all()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt, *, media=None,
               sampling: Optional[SamplingParams] = None,
               slo: Optional[SLO] = None,
               max_new_tokens: Optional[int] = None) -> int:
        """Enqueue a request into the live loop; returns its rid.  The
        arrival timestamp is *now* on the engine clock (open-loop)."""
        with self._cv:
            rid = self.server.submit(np.asarray(prompt), media=media,
                                     sampling=sampling, slo=slo,
                                     max_new_tokens=max_new_tokens,
                                     arrival=self.server.now())
            self._queues[rid] = deque()
            self._cv.notify_all()
            return rid

    def generate(self, prompt, *, media=None,
                 sampling: Optional[SamplingParams] = None,
                 slo: Optional[SLO] = None,
                 max_new_tokens: Optional[int] = None) -> RequestStream:
        rid = self.submit(prompt, media=media, sampling=sampling, slo=slo,
                          max_new_tokens=max_new_tokens)
        return RequestStream(self, rid)

    def abort(self, rid: int) -> bool:
        """Cancel ``rid`` wherever it is (queued / encode / prefill /
        decode); frees its cache blocks and emits the finish event."""
        with self._cv:
            return self.server.abort(rid)

    def step(self) -> bool:
        """One scheduler iteration (step-driven mode)."""
        with self._cv:
            return self.server.step()

    def result(self, rid: int) -> ServeItem:
        """The request's ServeItem (tokens so far, Request with metrics)."""
        return self.server.items[rid]

    def cache_stats(self) -> dict:
        """Prefix/encode cache hit rates + COW/eviction counters (all zero
        unless the server was built with ``prefix_cache=True``)."""
        with self._cv:
            return self.server.cache_stats()

    def release(self, rid: int):
        """Drop a finished (or aborted) request's retained state — its
        event queue, finish marker, and ServeItem.  Long-lived servers
        call this after responding so memory stays bounded;
        ``result``/``events`` are invalid for the rid afterwards.
        """
        with self._cv:
            self._queues.pop(rid, None)
            self._finished.discard(rid)
            self.server.items.pop(rid, None)

    def events(self, rid: int) -> Iterator[StreamEvent]:
        """Yield ``rid``'s StreamEvents until (and including) "finish".

        Without a serve thread, this *drives* the engine: each pass with an
        empty queue runs one ``step()``, so all in-flight requests advance
        while one stream is consumed (capacity-deadlock stall guard
        included, same as ``HydraServer.run``).
        """
        q = self._queues[rid]
        stalled = 0
        while True:
            ev = None
            with self._cv:
                if not q and self._thread is not None:
                    self._cv.wait(timeout=0.1)
                if q:
                    ev = q.popleft()
                done = rid in self._finished
            if ev is None:
                if done:
                    return  # finish already consumed elsewhere
                if self._thread is None:
                    if self.step():
                        stalled = 0
                    else:
                        with self._cv:
                            candidate = self.server.deadlock_candidate()
                        if candidate:
                            stalled += 1
                            if stalled >= 100:
                                raise RuntimeError(
                                    self.server.stall_diagnosis()[1])
                        else:
                            stalled = 0
                            time.sleep(0.001)  # future work: wait
                continue
            yield ev
            if ev.kind == "finish":
                return

    # ------------------------------------------------------------------
    # loop control
    # ------------------------------------------------------------------
    def start(self) -> "Engine":
        """Spawn the background serve loop (threaded mode)."""
        if self._thread is None:
            self._stop_flag = False
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="hydra-engine")
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop_flag:
            if not self.step():
                time.sleep(0.001)

    def _live_rids(self) -> list:
        """Rids submitted but not yet finished (caller holds the lock)."""
        return [rid for rid, it in self.server.items.items()
                if not it.req.done]

    def close(self, drain_timeout: Optional[float] = 5.0):
        """Graceful shutdown: keep stepping until every in-flight request
        finishes or ``drain_timeout`` (seconds) elapses, then abort the
        stragglers — freeing their cache blocks and emitting "abort" finish
        events so open streams terminate — and stop the background loop.
        ``drain_timeout=0`` aborts immediately; ``None`` waits forever."""
        deadline = None if drain_timeout is None \
            else time.monotonic() + drain_timeout
        while True:
            with self._cv:
                live = self._live_rids()
            if not live:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if self._thread is None:
                with self._cv:
                    worked = self.server.step()
                if not worked:
                    time.sleep(0.001)
            else:
                time.sleep(0.01)   # the serve thread is doing the work
        with self._cv:
            for rid in self._live_rids():
                self.server.abort(rid)
        self._stop_flag = True
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def wait(self, rids, timeout: Optional[float] = None) -> bool:
        """Threaded mode: block until every rid finished.  Returns False on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not all(r in self._finished for r in rids):
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(timeout=0.2 if left is None
                              else min(left, 0.2))
        return True

    def drain(self, max_iters: int = 10_000):
        """Step-driven mode: step until the server is idle (the streaming
        analogue of ``HydraServer.run``, stall guard included)."""
        stalled = 0
        for _ in range(max_iters):
            with self._cv:
                if self.server.idle():
                    return
                worked = self.server.step()
                if worked:
                    stalled = 0
                    continue
                candidate = self.server.deadlock_candidate()
            if candidate:
                stalled += 1
                if stalled >= 100:
                    raise RuntimeError(self.server.stall_diagnosis()[1])
            else:
                stalled = 0
                time.sleep(0.001)
        raise RuntimeError("drain: max_iters exceeded")
