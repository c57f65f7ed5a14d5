"""The port's absorbed MLA over the paged latent pool and the DeepSeek-V2
model (reduced: kv_lora 64 + rope 16, so the kernels run at head dim 80,
one KV head) against ``repro`` on the same weights, in f32 on the CPU;
then the serving paths the latent pool walks: migration P -> D, prefix
sharing with copy-on-write, crash replay, admission.

Tolerances: MLA outputs and pools within 1e-5; model logits within 2e-4
of the largest logit, the reference's own bar; greedy Engine streams
identical to ``repro``'s, and a prefix-cache hit or a replay identical to
the port's own cold run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simulator import DisaggConfig as JDisagg
from repro.engine.api import Engine as JEngine
from repro.engine.faults import AdmissionError as JAdmissionError
from repro.engine.server import HydraServer as JHydraServer
from repro.models import mla as JMLA
from repro.models import model as JM
from repro_torch.core.budgets import Budgets
from repro_torch.core.request import SamplingParams
from repro_torch.core.simulator import DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.api import Engine
from repro_torch.engine.faults import AdmissionError
from repro_torch.engine.server import HydraServer
from repro_torch.models import mla
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy

from _torch_steps import run_steps, t
from conftest import assert_all_reclaimed, reduced_cfg

ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module")
def deepseek():
    cfg = reduced_cfg(ARCH)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(6))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


def test_check_supported_admits_the_moe_family():
    for arch in (ARCH, "granite-moe-1b-a400m"):
        M.check_supported(reduced_cfg(arch))
    cfg = reduced_cfg(ARCH)
    assert cfg.kv_lora_rank + cfg.qk_rope_head_dim == 80


def _pool(rng, cfg, NB=8):
    """A [1, L_mla, NB + 1, 16, R + rope] latent pool of random rows."""
    w = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return (rng.standard_normal((1, cfg.num_layers, NB + 1, 16, w))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("layer", [0, 1])
def test_mla_decode_paged_matches_jax(rng, deepseek, layer):
    cfg, jparams, tparams = deepseek
    B, NB = 3, 8
    pool = _pool(rng, cfg, NB)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    tables = np.stack([rng.permutation(NB)[:4] for _ in range(B)]) \
        .astype(np.int32)
    lens = np.asarray([5, 17, 40], np.int32)
    slots = (tables[np.arange(B), lens // 16] * 16 + lens % 16) \
        .astype(np.int32)
    want, jdata = JMLA.mla_decode_paged(
        jparams["layers"][layer], jnp.asarray(x), cfg, jnp.asarray(pool),
        layer, jnp.asarray(tables), jnp.asarray(slots), jnp.asarray(lens),
        use_kernel=False)
    tpool = t(pool)
    got, out_pool = mla.mla_decode_paged(
        tparams.layers[layer], t(x), cfg, tpool, layer, t(tables), t(slots),
        t(lens))
    assert out_pool is tpool                 # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jdata), atol=1e-5,
                               rtol=0)


def test_mla_chunk_paged_matches_jax(rng, deepseek):
    cfg, jparams, tparams = deepseek
    B, C, NB = 2, 8, 8
    pool = _pool(rng, cfg, NB)
    x = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    tables = np.asarray([[3, 5, 0, 1], [6, 2, 4, 7]], np.int32)
    ctx = np.asarray([12, 3], np.int32)
    n_new = [8, 5]
    slots = np.full((B, C), NB * 16, np.int32)          # scratch
    for b in range(B):
        pos = ctx[b] + np.arange(n_new[b])
        slots[b, :n_new[b]] = tables[b, pos // 16] * 16 + pos % 16
    want, jdata = JMLA.mla_chunk_paged(
        jparams["layers"][1], jnp.asarray(x), cfg, jnp.asarray(pool), 0,
        jnp.asarray(tables), jnp.asarray(slots), jnp.asarray(ctx),
        use_kernel=False)
    tpool = t(pool)
    got, _ = mla.mla_chunk_paged(tparams.layers[1], t(x), cfg, tpool, 0,
                                 t(tables), t(slots), t(ctx))
    for b in range(B):                       # padded positions: garbage
        np.testing.assert_allclose(got.numpy()[b, :n_new[b]],
                                   np.asarray(want)[b, :n_new[b]],
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(tpool.numpy()[:, :, :NB],
                               np.asarray(jdata)[:, :, :NB], atol=1e-5,
                               rtol=0)


def test_deepseek_paged_steps_match_jax(rng, deepseek):
    cfg, jparams, tparams = deepseek
    run_steps(cfg, jparams, tparams, rng)


def test_runner_builds_the_latent_pool(deepseek):
    cfg, _, _ = deepseek
    caches = R.RunnerCaches(cfg, kv_blocks=8, device="cpu")
    assert caches.kv is None and caches.mla_layers == [0, 1]
    spec = caches.mla.spec
    assert (spec.n_tensors, spec.n_layers, spec.block_size, spec.width) == \
        (1, 2, 16, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    # the least over the sequence pools, not 2^30 for a model without kv
    assert caches.kv_tokens_total() == 8 * 16
    assert caches.kv_tokens_free() == caches.mla.available_blocks * 16


def test_admission_rejects_request_larger_than_the_latent_pool(deepseek):
    """As in the reference: a request whose tokens exceed the whole MLA
    pool is refused at submit, and one that fits is taken."""
    cfg, jparams, tparams = deepseek
    prompt = np.arange(200, dtype=np.int32) % cfg.vocab_size
    jsrv = JHydraServer(cfg, jparams, JDisagg({"EPD": 1}),
                        shed_policy="deadline", kv_blocks=4)
    with pytest.raises(JAdmissionError, match="KV tokens"):
        jsrv.submit(prompt, max_new_tokens=8)
    srv = HydraServer(cfg, tparams, DisaggConfig({"EPD": 1}), device="cpu",
                      shed_policy="deadline", kv_blocks=4)
    with pytest.raises(AdmissionError, match="KV tokens"):
        srv.submit(prompt, max_new_tokens=8)
    srv.submit(prompt[:20], max_new_tokens=2)


@pytest.mark.parametrize("disagg", [{"EPD": 1}, {"P": 1, "D": 1}],
                         ids=["EPD", "P-D"])
def test_deepseek_engine_greedy_streams_match_jax(rng, deepseek,
                                                  monkeypatch, disagg):
    monkeypatch.setenv("REPRO_PAGED_IMPL", "ref")
    cfg, jparams, tparams = deepseek
    prompts = [rng.integers(0, cfg.vocab_size, 9 + 5 * i).astype(np.int32)
               for i in range(3)]
    jeng = JEngine(cfg, jparams, JDisagg(dict(disagg)))
    want = [jeng.generate(p, max_new_tokens=6).tokens() for p in prompts]
    teng = Engine(cfg, tparams, DisaggConfig(dict(disagg)), device="cpu")
    streams = [teng.generate(p, sampling=SamplingParams(max_tokens=6))
               for p in prompts]
    assert [s.tokens() for s in streams] == want
    if "D" in disagg:                         # the latent pool migrated
        assert teng.server.n_migrations > 0
    assert_all_reclaimed(teng.server)


def test_deepseek_prefix_hit_matches_cold_run(deepseek):
    """Two sharers adopt the same resident latent prefix capped mid-block;
    their suffix writes copy-on-write the shared tail block and both decode
    exactly as the cold run (the reference pins the same for MLA,
    tests/test_cache_sharing.py)."""
    cfg, _, tparams = deepseek
    prompt = np.random.default_rng(21).integers(
        0, cfg.vocab_size, 48).astype(np.int32)
    sp = SamplingParams(max_tokens=5)
    cold = Engine(cfg, tparams, DisaggConfig({"EPD": 1}), device="cpu")
    ref = cold.generate(prompt, sampling=sp).tokens()
    warm = Engine(cfg, tparams, DisaggConfig({"EPD": 1}), device="cpu",
                  prefix_cache=True)
    assert warm.generate(prompt, sampling=sp).tokens() == ref
    b = warm.generate(prompt, sampling=sp)
    c = warm.generate(prompt, sampling=sp)
    warm.drain()
    assert list(warm.result(b.rid).generated) == ref
    assert list(warm.result(c.rid).generated) == ref
    assert warm.result(b.rid).req.prefix_cached_tokens > 0
    assert warm.cache_stats()["cow_copies"] >= 1
    assert_all_reclaimed(warm.server)


def test_deepseek_crash_replay_mid_prefill_bit_exact(deepseek):
    """The instance holding a request mid-prefill dies; its journal replays
    it elsewhere and every stream equals the uninterrupted run."""
    cfg, _, tparams = deepseek
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
               for _ in range(3)]
    kw = dict(budgets=Budgets(16, 4), device="cpu")

    def server():
        srv = HydraServer(cfg, tparams, DisaggConfig({"EPD": 2}), **kw)
        return srv, [srv.submit(p, max_new_tokens=6) for p in prompts]

    base, rids = server()
    out = base.run()
    expected = [list(out[r].generated) for r in rids]
    srv, rids = server()
    r0 = srv.items[rids[0]].req
    for _ in range(2000):
        if 0 < r0.prefill_done < r0.prefill_total:
            break
        srv.step()
    assert 0 < r0.prefill_done < r0.prefill_total
    holder = next(i for i in srv.instances
                  if r0 in i.running or r0 in i.waiting)
    assert srv.kill_instance(holder.iid)
    srv.run()
    assert [list(srv.items[r].generated) for r in rids] == expected
    assert srv.fault_stats()["dead_instances"] == [holder.iid]
    assert_all_reclaimed(srv)


def test_deepseek_abort_mid_decode_frees_the_latent_pool(deepseek):
    cfg, _, tparams = deepseek
    rng = np.random.default_rng(3)
    eng = Engine(cfg, tparams, DisaggConfig({"P": 1, "D": 1}), device="cpu")
    victim = eng.generate(rng.integers(0, cfg.vocab_size, 60)
                          .astype(np.int32),
                          sampling=SamplingParams(max_tokens=64))
    bystander = eng.generate(rng.integers(0, cfg.vocab_size, 6)
                             .astype(np.int32),
                             sampling=SamplingParams(max_tokens=4))
    req = eng.result(victim.rid).req
    for _ in range(200):
        if req.tokens_out >= 2:
            break
        eng.step()
    assert eng.abort(victim.rid)
    eng.drain()
    assert len(eng.result(bystander.rid).generated) == 4
    assert_all_reclaimed(eng.server)
