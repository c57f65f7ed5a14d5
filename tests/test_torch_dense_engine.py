"""The port's dense host-cache fallback (``device_cache=False``) through its
runner and server on the CPU: greedy streams of ``HydraServer`` equal to
the JAX package's dense server's and to the port's own device-cache
server's for the disaggregations of tests/test_engine.py (every pool
reclaimed after), the dense runner's prefill chunks and decode steps
against its paged ones (tests/test_device_cache.py,
tests/test_prefill_paged.py), and a request migrated between host-cache
instances and back.  Set-up: tests/_torch_dense.py.

The JAX dense server runs its own ``prefill_chunk`` under ``jax.jit``
(patched in for the test; eagerly it costs seconds a chunk), once per
model under colocation: its greedy tokens do not depend on the
disaggregation (tests/test_engine.py holds every disaggregation to the
same direct generation).

Tolerances: logits within 2e-4 of the dense side's largest logit and
cache rows within 2e-4 absolute, the reference's bars for paged vs dense
(tests/test_device_cache.py, tests/test_prefill_paged.py); greedy tokens
and migrated rows exact.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.core.simulator import DisaggConfig as JDisagg
from repro.engine.server import HydraServer as JServer
from repro.models import model as JM
from repro_torch.core.simulator import DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.paged_cache import PagedCache
from repro_torch.engine.server import HydraServer

from _torch_dense import close, weights
from conftest import assert_all_reclaimed

_JIT_CHUNK = jax.jit(JM.prefill_chunk, static_argnums=0)

SERVER_CASES = [
    ("llava-1.5-7b", {"E": 1, "P": 1, "D": 1}),
    ("llava-1.5-7b", {"EP": 1, "D": 1}),
    ("falcon-mamba-7b", {"P": 1, "D": 1}),
    ("zamba2-7b", {"PD": 1}),
    ("whisper-small", {"E": 1, "PD": 1}),
    ("granite-moe-1b-a400m", {"EPD": 1}),
]


def _requests(cfg, seed=0, n=3, n_prompt=9, n_new=4):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        prompt = rng.integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
        media = None
        if cfg.frontend != "none":
            media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
                     * 0.1).astype(np.float32)
        reqs.append((prompt, media, n_new))
    return reqs


def _serve(srv, reqs):
    rids = [srv.submit(p, media=m, max_new_tokens=n) for p, m, n in reqs]
    out = srv.run()
    return [list(out[r].generated) for r in rids]


@functools.lru_cache(maxsize=None)
def _jax_dense_tokens(arch):
    """The JAX package's dense server (host caches), colocated."""
    cfg, jparams, _ = weights(arch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "prefill_chunk", _JIT_CHUNK)
        return _serve(JServer(cfg, jparams, JDisagg({"EPD": 1}),
                              device_cache=False), _requests(cfg))


@pytest.mark.parametrize("arch,disagg", SERVER_CASES,
                         ids=[f"{a}-{'-'.join(d)}" for a, d in SERVER_CASES])
def test_dense_server_matches_jax_and_paged(arch, disagg):
    cfg, _, tparams = weights(arch)
    reqs = _requests(cfg)
    got = {}
    for device_cache in (False, True):
        srv = HydraServer(cfg, tparams, DisaggConfig(dict(disagg)),
                          device_cache=device_cache, device="cpu")
        got[device_cache] = _serve(srv, reqs)
        if len(disagg) > 1:
            assert srv.n_migrations > 0
        assert_all_reclaimed(srv)
        assert all(isinstance(c, PagedCache) != device_cache
                   for i in srv.instances for _, c in i.caches.seq_pools())
    assert got[False] == got[True] == _jax_dense_tokens(arch)
    assert all(len(toks) == 4 for toks in got[False])


def _pair(arch, rng, n_req=3):
    """A dense (host-cache) and a paged runner on the same weights, with
    media encoded; ``reqs``: [(rid, prompt)] of uneven lengths."""
    cfg, _, tparams = weights(arch, 7)
    runners = {dc: R.ModelRunner(cfg, tparams, R.RunnerCaches(
        cfg, kv_blocks=32, img_blocks=4, device="cpu", device_cache=dc),
        device="cpu") for dc in (False, True)}
    reqs = []
    for rid in range(n_req):
        prompt = rng.integers(0, cfg.vocab_size, 18 + 5 * rid).astype(
            np.int32)
        if cfg.frontend != "none":
            media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
                     * 0.1).astype(np.float32)
            for r in runners.values():
                r.encode([(rid, media)])
        reqs.append((rid, prompt))
    return cfg, runners[False], runners[True], reqs


def _chunks(cfg, dense, paged, reqs, chunk=11):
    """Media chunks, then chunks of 11 tokens (they straddle the 16-row
    blocks): the paged runner batched, the dense one a request at a time;
    each chunk's logits compared.  Returns the last greedy tokens."""
    if cfg.frontend != "none" and not cfg.cross_attention:
        items = [(rid, None, True) for rid, _ in reqs]
        close(paged.prefill_chunks(items), dense.prefill_chunks(items))
    last = {}
    for lo in range(0, max(len(p) for _, p in reqs), chunk):
        items = [(rid, p[lo:lo + chunk], False) for rid, p in reqs
                 if lo < len(p)]
        want = dense.prefill_chunks(items)
        close(paged.prefill_chunks(items), want)
        last.update({rid: int(np.argmax(lg))
                     for (rid, _, _), lg in zip(items, want)})
    return np.asarray([last[rid] for rid, _ in reqs])


RUNNER_ARCHS = ["llava-1.5-7b", "deepseek-v2-236b", "whisper-small",
                "gemma3-4b", "zamba2-7b"]


@pytest.mark.parametrize("arch", RUNNER_ARCHS)
def test_dense_prefill_matches_paged(rng, arch):
    """Per-chunk logits and then the cached rows of every pool (the host
    pool against the device one), then two decode steps off both."""
    cfg, dense, paged, reqs = _pair(arch, rng)
    toks = _chunks(cfg, dense, paged, reqs)
    for (_, d_c), (_, p_c) in zip(dense.caches.seq_pools(),
                                  paged.caches.seq_pools()):
        assert isinstance(d_c, PagedCache)
        for rid, _ in reqs:
            np.testing.assert_allclose(p_c.gather(rid).numpy(),
                                       d_c.gather(rid), atol=2e-4)
    rids = [rid for rid, _ in reqs]
    for _ in range(2):
        want = dense.decode(rids, toks)
        close(paged.decode(rids, toks), want)
        toks = np.argmax(want, axis=-1)


@pytest.mark.parametrize("arch", RUNNER_ARCHS)
def test_dense_decode_matches_paged(rng, arch):
    """Whole prompts in one chunk each, then four batched decode steps
    over heterogeneous context lengths, greedy (the token ids) and as
    logits."""
    cfg, dense, paged, reqs = _pair(arch, rng)
    toks = _chunks(cfg, dense, paged, reqs, chunk=64)
    rids = [rid for rid, _ in reqs]
    greedy = {"temp": np.zeros(len(rids)), "top_k": np.zeros(len(rids)),
              "top_p": np.ones(len(rids)), "seed": np.zeros(len(rids)),
              "step": np.zeros(len(rids))}
    for _ in range(3):
        want = dense.decode(rids, toks)
        close(paged.decode(rids, toks), want)
        toks = np.argmax(want, axis=-1)
    np.testing.assert_array_equal(paged.decode(rids, toks, greedy),
                                  dense.decode(rids, toks, greedy))


def test_dense_single_chunk_routes_dense(rng):
    """``prefill_chunk`` on host caches runs the dense path (never the
    paged step), on device caches the batched paged path (never the dense
    gather); both give the same logits."""
    cfg, dense, paged, reqs = _pair("llama3-8b", rng, n_req=1)
    paged._gather_prior = None           # raises if the dense path ran
    rid, prompt = reqs[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R.M, "prefill_chunk_paged", None)
        want = dense.prefill_chunk(rid, prompt[:8])
    close(paged.prefill_chunk(rid, prompt[:8]), want)


def test_dense_migrate_round_trip(rng):
    """A prefilled request moves from one host-cache instance to another
    and back, rows and state exact; decode there equals decode on a
    runner that never moved it; then every block is reclaimed."""
    cfg, _, tparams = weights("zamba2-7b", 7)
    runners = [R.ModelRunner(cfg, tparams, R.RunnerCaches(
        cfg, kv_blocks=16, device="cpu", device_cache=False),
        device="cpu") for _ in range(3)]
    a, b, ref = runners
    prompt = rng.integers(0, cfg.vocab_size, 21).astype(np.int32)
    for r in (a, ref):
        tok = np.argmax(r.prefill_chunk(0, prompt))
    rows = a.caches.kv.gather(0).copy()
    assert R.migrate(0, a.caches, b.caches) > 0
    np.testing.assert_array_equal(b.caches.kv.gather(0), rows)
    assert R.migrate(0, b.caches, a.caches) > 0
    np.testing.assert_array_equal(a.caches.kv.gather(0), rows)
    assert not b.caches.live_rids()
    np.testing.assert_array_equal(a.decode([0], [tok]),
                                  ref.decode([0], [tok]))
    for r in runners:
        r.caches.release(0)
    assert_all_reclaimed(SimpleNamespace(instances=[
        SimpleNamespace(iid=i, running=[], waiting=[], caches=r.caches)
        for i, r in enumerate(runners)]))
