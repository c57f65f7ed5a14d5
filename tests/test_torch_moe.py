"""The port's MoE FFN and the MoE family (granite-moe-1b-a400m, reduced)
against ``repro`` on the same weights (``params_from_numpy``), in f32 on
the CPU.

Tolerances: expert ids identical, then the FFN output within 1e-5
(per-expert products over the routed rows sum in another order than the
reference's [E, T + 1, d] buffer products); model logits within 2e-4 of
the largest logit, the reference's own bar; greedy Engine streams
identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simulator import DisaggConfig as JDisagg
from repro.engine.api import Engine as JEngine
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.core.request import SamplingParams
from repro_torch.core.simulator import DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.api import Engine
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.params import ParamTree, params_from_numpy

from _torch_steps import run_steps, t
from conftest import assert_all_reclaimed, reduced_cfg

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]


@pytest.fixture(scope="module")
def granite():
    cfg = reduced_cfg("granite-moe-1b-a400m")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(4))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (3, 17)],
                         ids=["T1", "decode-B4", "chunk-3x17"])
def test_moe_ffn_matches_jax_lossless(rng, arch, shape):
    cfg = reduced_cfg(arch)
    jp = JMoE.init_moe(jax.random.PRNGKey(9), cfg, jnp.float32)
    tp = ParamTree({k: t(np.asarray(v)) for k, v in jp.items()})
    assert ("sh_w_gate" in jp) == (arch == "deepseek-v2-236b")
    x = (rng.standard_normal(shape + (cfg.d_model,))).astype(np.float32)
    # expert ids first: the same tokens go to the same experts
    logits = jnp.asarray(x.reshape(-1, cfg.d_model)) @ jp["router"]
    want_gates, want_ids = jax.lax.top_k(jax.nn.softmax(logits, -1),
                                         cfg.experts_per_token)
    gates, ids = moe.route(tp, t(x).reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    want_gates = want_gates / want_gates.sum(-1, keepdims=True)
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates),
                               atol=1e-6, rtol=0)
    want, _ = JMoE.moe_ffn(jp, jnp.asarray(x), cfg, lossless=True)
    got = moe.moe_ffn(tp, t(x), cfg)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_moe_ffn_runs_only_routed_experts(rng, monkeypatch):
    """An expert that no token picked is never multiplied: its weights
    can be NaN without touching the output."""
    cfg = reduced_cfg("granite-moe-1b-a400m")
    jp = JMoE.init_moe(jax.random.PRNGKey(2), cfg, jnp.float32)
    tp = ParamTree({k: t(np.asarray(v)) for k, v in jp.items()})
    x = t(rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32))
    _, ids = moe.route(tp, x.reshape(1, -1), cfg)
    idle = sorted(set(range(cfg.num_experts)) - set(ids[0].tolist()))
    assert idle
    want = moe.moe_ffn(tp, x, cfg)
    with torch.no_grad():
        for name in ("moe_w_gate", "moe_w_up", "moe_w_down"):
            getattr(tp, name)[idle] = float("nan")
    torch.testing.assert_close(moe.moe_ffn(tp, x, cfg), want, rtol=0, atol=0)


def test_moe_params_carry_across_leaf_for_leaf(granite):
    cfg, jparams, tparams = granite
    for jl, tl in zip(jparams["layers"], tparams.layers):
        assert {n for n, _ in tl.named_parameters()} == set(jl)
        for name, arr in jl.items():
            np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                          np.asarray(arr))
    bf = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                           dtype=torch.bfloat16)
    assert bf.layers[0].router.dtype == torch.float32
    assert bf.layers[0].moe_w_up.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_jax_tree(arch):
    """Names, shapes and types (f32 router and norm scales) of the port's
    own random tree follow the JAX package's."""
    cfg = reduced_cfg(arch)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    p = M.init_params(cfg, torch.Generator().manual_seed(0))
    flat = dict(p.named_parameters())
    want = {f"layers.{i}.{n}": a for i, layer in enumerate(jparams["layers"])
            for n, a in layer.items()}
    want.update({k: v for k, v in jparams.items() if k != "layers"})
    assert set(flat) == set(want)
    for k, a in want.items():
        assert tuple(flat[k].shape) == a.shape, k
        assert str(flat[k].dtype).split(".")[-1] == str(a.dtype), k


def test_granite_paged_steps_match_jax(rng, granite):
    cfg, jparams, tparams = granite
    run_steps(cfg, jparams, tparams, rng)


def test_granite_runner_has_kv_pool_only(granite):
    cfg, _, tparams = granite
    caches = R.RunnerCaches(cfg, kv_blocks=8, device="cpu")
    assert caches.attn_layers == [0, 1] and caches.mla is None
    assert caches.kv_tokens_total() == 8 * R.KV_BLOCK


@pytest.mark.parametrize("disagg", [{"EPD": 1}, {"P": 1, "D": 1}],
                         ids=["EPD", "P-D"])
def test_granite_engine_greedy_streams_match_jax(rng, granite, monkeypatch,
                                                 disagg):
    monkeypatch.setenv("REPRO_PAGED_IMPL", "ref")
    cfg, jparams, tparams = granite
    prompts = [rng.integers(0, cfg.vocab_size, 9 + 5 * i).astype(np.int32)
               for i in range(3)]
    jeng = JEngine(cfg, jparams, JDisagg(dict(disagg)))
    want = [jeng.generate(p, max_new_tokens=6).tokens() for p in prompts]
    teng = Engine(cfg, tparams, DisaggConfig(dict(disagg)), device="cpu")
    streams = [teng.generate(p, sampling=SamplingParams(max_tokens=6))
               for p in prompts]
    assert [s.tokens() for s in streams] == want
    if "D" in disagg:
        assert teng.server.n_migrations > 0
    assert_all_reclaimed(teng.server)
