"""The port's MoE FFN and the MoE family (granite-moe-1b-a400m, reduced)
against ``repro`` on the same weights (``params_from_numpy``), in f32 on
the CPU.

Tolerances: expert ids identical, then the FFN output within 1e-5
(per-expert products over the routed rows sum in another order than the
reference's [E, T + 1, d] buffer products); model logits within 2e-4 of
the largest logit, the reference's own bar; greedy Engine streams
identical.  The capacity-dropping training path: output and aux loss
within 1e-5, gradients within 1e-5 of each one's largest magnitude (the
same products, summed in another order).
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
    got = moe.moe_ffn(tp, t(x), cfg, lossless=True)[0]
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.5, 1.0, 16.0],
                         ids=["cf0.5", "cf1", "cf16"])
def test_moe_ffn_capacity_path_matches_jax(rng, arch, cf):
    """lossless=False at capacity factors that drop pairs (0.5, 1.0) and
    one that does not (16): the output, the aux loss and the gradients of
    a random projection of the output plus the aux loss with respect to
    x, the router and every expert weight (shared experts too), against
    jax.grad of the reference's moe_ffn."""
    import dataclasses
    cfg = dataclasses.replace(reduced_cfg(arch), moe_capacity_factor=cf)
    jp = JMoE.init_moe(jax.random.PRNGKey(11), cfg, jnp.float32)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    T, k, E = 26, cfg.experts_per_token, cfg.num_experts
    C = moe.capacity(cfg, T)
    assert C == min(max(1, int(cf * T * k / E)), T)

    def jloss(p, xx):
        y, aux = JMoE.moe_ffn(p, xx, cfg, lossless=False)
        return (y * w).sum() + aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tp = ParamTree({k_: t(np.asarray(v)) for k_, v in jp.items()},
                   trainable=True)
    tx = t(x).requires_grad_()
    y, aux = moe.moe_ffn(tp, tx, cfg, lossless=False)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5,
                               rtol=0)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5)
    names = sorted(jp)
    grads = torch.autograd.grad((y * t(w)).sum() + aux,
                                [tx] + [getattr(tp, n) for n in names])
    want = [np.asarray(jgx)] + [np.asarray(jgp[n]) for n in names]
    for name, g, wg in zip(["x"] + names, grads, want):
        scale = max(np.abs(wg).max(), 1e-30)
        assert np.abs(g.numpy() - wg).max() <= 1e-5 * scale, name
    # drops happen at cf < 16: some (token, slot) pairs find a full expert
    ids = moe.route(tp, tx.detach().reshape(T, -1), cfg)[1]
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    assert (counts > C).any() == (cf < 16)


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
    want = moe.moe_ffn(tp, x, cfg, lossless=True)[0]
    with torch.no_grad():
        for name in ("moe_w_gate", "moe_w_up", "moe_w_down"):
            getattr(tp, name)[idle] = float("nan")
    torch.testing.assert_close(moe.moe_ffn(tp, x, cfg, lossless=True)[0],
                               want, rtol=0, atol=0)


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
