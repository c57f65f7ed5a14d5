"""The port's runner, server and Engine against the JAX package's on the same
weights, on CPU: per-step logits of ``ModelRunner`` (teacher-forced, within
2e-4 of the largest logit, the reference's own bar), identical greedy token
streams through ``Engine`` under colocated and disaggregated instances, and
the device paged cache's append/gather and migration round-trips."""
import jax
import numpy as np
import pytest
import torch

from repro.core.simulator import DisaggConfig as JDisagg
from repro.engine import runner as JR
from repro.engine.api import Engine as JEngine
from repro.engine.paged_cache import DevicePagedCache as JDevicePagedCache
from repro.models import model as JM
from repro_torch.core.request import SamplingParams
from repro_torch.core.simulator import DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.api import Engine
from repro_torch.engine.paged_cache import (DevicePagedCache, PagedCache,
                                            PagedCacheSpec, StateStore,
                                            migrate_request)
from repro_torch.params import params_from_numpy

from conftest import assert_all_reclaimed, reduced_cfg


@pytest.fixture(scope="module")
def llava():
    cfg = reduced_cfg("llava-1.5-7b")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


def _media(rng, cfg):
    return (rng.standard_normal((cfg.media_tokens, cfg.d_model))
            * 0.1).astype(np.float32)


def _close(got, want):
    scale = np.abs(want).max() + 1e-9
    assert np.abs(np.asarray(got) - np.asarray(want)).max() / scale < 2e-4


def test_runner_matches_jax_runner(rng, llava, monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_IMPL", "ref")
    cfg, jparams, tparams = llava
    jr = JR.ModelRunner(cfg, jparams, JR.RunnerCaches(
        cfg, kv_blocks=32, img_blocks=4, device=True))
    tr = R.ModelRunner(cfg, tparams, R.RunnerCaches(
        cfg, kv_blocks=32, img_blocks=4, device="cpu"), device="cpu")
    rids, toks = [0, 1, 2], []
    for rid in rids:
        prompt = rng.integers(0, cfg.vocab_size, 6 + 3 * rid).astype(np.int32)
        media = _media(rng, cfg) if rid != 1 else None
        outs = []
        for r in (jr, tr):
            if media is not None:
                r.encode([(rid, media)])
                r.prefill_chunk(rid, None, use_media=True)
            outs.append(r.prefill_chunk(rid, prompt))
        _close(outs[1], outs[0])
        toks.append(int(np.argmax(outs[0])))
    toks = np.asarray(toks)
    for step in range(4):
        want = jr.decode(rids, toks)
        got = tr.decode(rids, toks) if step % 2 == 0 else \
            tr.joint_encode_decode([], rids, toks)
        _close(got, want)
        toks = np.argmax(want, axis=-1)
    # the greedy fast path samples the argmax on device
    greedy = {"temp": np.zeros(3), "top_k": np.zeros(3), "top_p": np.ones(3),
              "seed": np.zeros(3), "step": np.zeros(3)}
    np.testing.assert_array_equal(tr.decode(rids, toks, sample=greedy),
                                  np.argmax(jr.decode(rids, toks), -1))


def _trace(rng, cfg, n=4):
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab_size, 10 + i).astype(np.int32)
        reqs.append((prompt, _media(rng, cfg) if i % 2 == 0 else None))
    return reqs


@pytest.mark.parametrize("disagg", [{"EPD": 1}, {"E": 1, "P": 1, "D": 1}],
                         ids=["EPD", "E-P-D"])
def test_engine_greedy_streams_match_jax(rng, llava, monkeypatch, disagg):
    monkeypatch.setenv("REPRO_PAGED_IMPL", "ref")
    cfg, jparams, tparams = llava
    reqs = _trace(rng, cfg)
    jeng = JEngine(cfg, jparams, JDisagg(dict(disagg)))
    want = [jeng.generate(p, media=m, max_new_tokens=6).tokens()
            for p, m in reqs]
    teng = Engine(cfg, tparams, DisaggConfig(dict(disagg)), device="cpu")
    streams = [teng.generate(p, media=m,
                             sampling=SamplingParams(max_tokens=6))
               for p, m in reqs]
    assert [s.tokens() for s in streams] == want
    assert all(len(t) == 6 for t in want)
    if "D" in disagg:
        assert teng.server.n_migrations > 0
    assert_all_reclaimed(teng.server)


def test_engine_seeded_sampling_is_batch_invariant(rng, llava):
    """Seeded non-greedy streams differ from the JAX package's by design
    (torch generators, not threefry), but stay a function of the request
    seed and token index alone."""
    cfg, _, tparams = llava
    prompt = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    sp = SamplingParams(temperature=0.9, top_k=50, top_p=0.95, seed=42,
                        max_tokens=6)
    others = _trace(rng, cfg, n=2)
    outs = []
    for companions in ([], others):
        eng = Engine(cfg, tparams, DisaggConfig({"EPD": 1}), device="cpu")
        target = eng.generate(prompt, sampling=sp)
        for p, m in companions:
            eng.generate(p, media=m, sampling=SamplingParams(
                temperature=0.7, seed=7, max_tokens=6))
        eng.drain()
        outs.append(list(eng.result(target.rid).generated))
        assert_all_reclaimed(eng.server)
    assert outs[0] == outs[1] and len(outs[0]) == 6


def test_server_refuses_dense_host_caches(llava):
    cfg, _, tparams = llava
    with pytest.raises(NotImplementedError, match="not ported"):
        Engine(cfg, tparams, DisaggConfig({"EPD": 1}), device="cpu",
               device_cache=False)


# ---------------------------------------------------------------------------
# DevicePagedCache: host-interop surface + migration round-trip
# ---------------------------------------------------------------------------
def test_device_cache_append_gather_matches_numpy_and_jax(rng):
    spec = PagedCacheSpec(n_tensors=2, n_layers=3, block_size=4, width=8,
                          num_blocks=16)
    host, dev = PagedCache(spec), DevicePagedCache(spec, device="cpu")
    jdev = JDevicePagedCache(spec)
    data = rng.standard_normal((2, 3, 10, 8)).astype(np.float32)
    for c in (host, dev, jdev):
        c.append(7, data[:, :, :6])
        c.append(7, data[:, :, 6:])
    np.testing.assert_array_equal(dev.gather(7).numpy(), host.gather(7))
    np.testing.assert_array_equal(dev.data.numpy(), np.asarray(jdev.data))
    assert dev.nbytes(7) == host.nbytes(7)


@pytest.mark.parametrize("direction", ["dev->host", "host->dev", "dev->dev"])
def test_device_cache_migrate_roundtrip(rng, direction):
    spec = PagedCacheSpec(2, 2, 4, 8, 16)
    mk = {"dev": lambda: DevicePagedCache(spec, device="cpu"),
          "host": lambda: PagedCache(spec)}
    s_kind, d_kind = direction.split("->")
    src, dst = mk[s_kind](), mk[d_kind]()
    src_st, dst_st = StateStore(), StateStore()
    kv = rng.standard_normal((2, 2, 9, 8)).astype(np.float32)
    src.append(3, kv)
    src_st.put(3, {"state": np.ones((1, 4, 2), np.float32)})
    moved = migrate_request(3, [src, src_st], [dst, dst_st])
    assert moved > 0
    np.testing.assert_allclose(np.asarray(torch.as_tensor(dst.gather(3))), kv)
    assert 3 not in src.tables and src_st.get(3) is None
    assert src.allocator.n_free == spec.num_blocks


def test_device_cache_bf16_migrates_bit_exact(rng):
    """bf16 pools cross the host as their int16 bit patterns."""
    spec = PagedCacheSpec(2, 2, 4, 8, 16, dtype=torch.bfloat16)
    src = DevicePagedCache(spec, device="cpu")
    dst = DevicePagedCache(spec, device="cpu")
    kv = torch.from_numpy(rng.standard_normal((2, 2, 9, 8)).astype(np.float32))
    src.append(3, kv)
    before = src.gather(3).clone()
    payload = src.read_blocks(3)
    assert payload.dtype == np.int16
    migrate_request(3, [src], [dst])
    assert torch.equal(dst.gather(3), before)
    assert torch.equal(before, kv.to(torch.bfloat16))


def test_device_cache_cow_copy_keeps_sharers_apart(rng):
    """A write into a shared block copies it first (``_copy_blocks``), so
    the other holder's pages are untouched."""
    spec = PagedCacheSpec(1, 1, 4, 8, 8)
    dev = DevicePagedCache(spec, sharing=True, device="cpu")
    keys = list(range(8))
    dev.set_keys(0, keys)
    dev.append(0, rng.standard_normal((1, 1, 8, 8)).astype(np.float32))
    first = dev.gather(0).clone()
    assert dev.probe_prefix(keys, 0, 6) == 6
    dev.take_prefix(1, 6, keys, 0)                   # shares block 1 mid-way
    dev.append(1, np.full((1, 1, 2, 8), 7.0, np.float32))
    assert dev.n_cow == 1
    assert torch.equal(dev.gather(0), first)
    np.testing.assert_array_equal(dev.gather(1)[0, 0, :6].numpy(),
                                  first[0, 0, :6].numpy())
    assert (dev.gather(1)[0, 0, 6:] == 7).all()


def test_device_cache_scratch_block_reserved():
    spec = PagedCacheSpec(1, 1, 4, 8, 8)
    dev = DevicePagedCache(spec, device="cpu")
    blocks = dev.allocator.alloc(8)
    assert dev.scratch_block not in blocks  # pad lanes own it exclusively
    tables, slots = DevicePagedCache(spec, device="cpu").prepare_decode(
        [], 2, 2)
    assert (tables == spec.num_blocks).all()
    assert (slots == spec.num_blocks * spec.block_size).all()
