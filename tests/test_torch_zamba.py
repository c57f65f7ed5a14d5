"""The port's zamba2 path against the JAX package's, on CPU: the per-head
selective scan's plain version (which the wrapper takes for CPU tensors)
against the Mamba-1 plain version on expanded dt and A; ``mamba2_seq``
against ``repro.models.mamba.mamba2_seq`` (right-padded chunks from a
nonzero state, a chunk continuing another); reduced zamba2-7b (4 Mamba-2
and 2 shared-attention layers, d 256, d_inner 512, 8 heads of 64, N 64)
paged prefill + decode steps on the same weights (converted through
``params_from_numpy``); and P1+D1 servers whose greedy streams match the
JAX server's, with each request's KV and recurrent state migrated P -> D
and no prefix hit taken for the hybrid.

Tolerances: the two plain scans 1e-6 (the same f32 arithmetic, A and dt
repeated); ``mamba2_seq`` outputs 1e-5 absolute in f32; logits within
2e-4 of the reference's largest logit (tests/test_device_cache.py),
pools 1e-5.  Recurrent states and conv prefixes are held to 1e-5
absolute plus 1e-5 relative: the two packages' f32 projections round
differently, and the recurrence carries that into states that reach
|h| ~ 10 here (5e-6 to 1.1e-5 apart on CPU, about 10 ulps there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simulator import DisaggConfig as JDisagg
from repro.engine.server import HydraServer as JServer
from repro.models import mamba as JMamba
from repro.models import model as JM
from repro_torch.configs.base import MAMBA2, SHARED_ATTN
from repro_torch.core.request import SamplingParams
from repro_torch.core.simulator import DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.api import Engine
from repro_torch.engine.server import HydraServer
from repro_torch.kernels.selective_scan.ops import selective_scan_heads
from repro_torch.kernels.selective_scan.ref import (selective_scan_heads_ref,
                                                    selective_scan_ref)
from repro_torch.models import mamba
from repro_torch.models import model as M
from repro_torch.params import ParamTree, params_from_numpy

from _torch_steps import run_steps, t
from conftest import assert_all_reclaimed, reduced_cfg

ARCH = "zamba2-7b"


@pytest.fixture(autouse=True)
def _f32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def zamba():
    cfg = reduced_cfg(ARCH)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


def test_reduced_zamba_shape():
    cfg = reduced_cfg(ARCH)
    kinds = cfg.layer_kinds()
    assert kinds.count(MAMBA2) == 4 and kinds.count(SHARED_ATTN) == 2
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_state) == (256, 512, 64)
    assert cfg.d_inner // cfg.mamba2_head_dim == 8
    assert R._seq_layers(cfg) == ([2, 5], [])


# ---------------------------------------------------------------------------
# the per-head scan
# ---------------------------------------------------------------------------
def _heads_inputs(rng, B, S, Hh, P, N):
    return (np.abs(rng.standard_normal((B, S, Hh))).astype(np.float32) * 0.1,
            rng.standard_normal((B, S, Hh * P)).astype(np.float32),
            -np.abs(rng.standard_normal(Hh)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, Hh, P, N)).astype(np.float32))


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
def test_heads_ref_is_the_mamba1_scan_on_expanded_inputs(rng, with_h0):
    B, S, Hh, P, N = 2, 12, 3, 32, 64
    dt, x, A, Bm, Cm, h0 = [t(a) for a in _heads_inputs(rng, B, S, Hh, P, N)]
    h0 = h0 if with_h0 else None
    y, h = selective_scan_heads(dt, x, A, Bm, Cm, h0)
    assert y.shape == (B, S, Hh * P) and h.shape == (B, Hh, P, N)
    assert y.dtype == h.dtype == torch.float32
    y1, h1 = selective_scan_ref(dt.repeat_interleave(P, dim=2), x,
                                A.repeat_interleave(P)[:, None].expand(-1, N),
                                Bm, Cm,
                                None if h0 is None else h0.reshape(B, -1, N))
    np.testing.assert_allclose(y.numpy(), y1.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(h.reshape(B, -1, N).numpy(), h1.numpy(),
                               atol=1e-6, rtol=0)


def test_heads_zero_dt_leaves_state_unchanged(rng):
    dt, x, A, Bm, Cm, h0 = [t(a) for a in _heads_inputs(rng, 2, 20, 2, 32, 64)]
    _, h_head = selective_scan_heads_ref(dt[:, :13], x[:, :13], A,
                                         Bm[:, :13], Cm[:, :13], h0)
    dt[:, 13:] = 0
    _, h = selective_scan_heads(dt, x, A, Bm, Cm, h0)
    assert torch.equal(h, h_head)


# ---------------------------------------------------------------------------
# the Mamba-2 block
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    cfg = reduced_cfg(ARCH)
    jp = JMamba.init_mamba2(jax.random.PRNGKey(3), cfg, jnp.float32)
    # nonzero skip, bias, decay and norm scales, so each one is exercised
    r = np.random.default_rng(4)
    jp = dict(jp, **{k: jnp.asarray(r.standard_normal(jp[k].shape)
                                    .astype(np.float32) * 0.3)
                     for k in ("dt_bias2", "A_log2", "D2", "ssm_norm",
                               "conv_b")})
    return cfg, jp, ParamTree({k: t(v) for k, v in jp.items()})


def _start(rng, cfg, B):
    shapes = mamba.mamba2_cache_shape(cfg, B)
    return [rng.standard_normal(shapes[k]).astype(np.float32) * 0.5
            for k in ("state", "conv")]


def _close(got, want, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=rtol)


def _close_state(got, want):
    _close(got, want, rtol=1e-5)


def test_mamba2_seq_matches_jax(rng, block):
    cfg, jp, tp = block
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    st, conv = _start(rng, cfg, 2)
    got = mamba.mamba2_seq(tp, t(x), cfg, t(st), t(conv))
    want = JMamba.mamba2_seq(jp, jnp.asarray(x), cfg, jnp.asarray(st),
                             jnp.asarray(conv))
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close_state(g, w)
    assert got[1][0].dtype == torch.float32


def test_mamba2_seq_masked_chunk_matches_jax_unpadded(rng, block):
    """A right-padded chunk, from a nonzero state and conv prefix, returns
    the outputs, state and conv prefix of running each request's valid
    tokens alone through the JAX block, and what the JAX block returns
    for the same padded chunk."""
    cfg, jp, tp = block
    x = rng.standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    st, conv = _start(rng, cfg, 3)
    n_valid = [7, 4, 2]
    mask = np.arange(7)[None, :] < np.asarray(n_valid)[:, None]
    y_pad, (st_pad, conv_pad) = mamba.mamba2_seq(tp, t(x), cfg, t(st),
                                                 t(conv), mask=t(mask))
    jy, (jst, jconv) = JMamba.mamba2_seq(
        jp, jnp.asarray(x), cfg, jnp.asarray(st), jnp.asarray(conv),
        mask=jnp.asarray(mask))
    _close_state(st_pad, jst)
    _close_state(conv_pad, jconv)
    for b, n in enumerate(n_valid):
        sl = slice(b, b + 1)
        y, (s1, c1) = JMamba.mamba2_seq(jp, jnp.asarray(x[sl, :n]), cfg,
                                        jnp.asarray(st[sl]),
                                        jnp.asarray(conv[sl]))
        _close(y_pad[sl, :n], y)
        _close(y_pad[sl, :n], np.asarray(jy)[sl, :n])
        _close_state(st_pad[sl], s1)
        _close_state(conv_pad[sl], c1)


def test_mamba2_second_chunk_continues_the_first(rng, block):
    cfg, jp, tp = block
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    y1, (s1, c1) = mamba.mamba2_seq(tp, t(x[:, :6]), cfg)
    y2, (s2, c2) = mamba.mamba2_seq(tp, t(x[:, 6:]), cfg, s1, c1)
    want, (jst, jconv) = JMamba.mamba2_seq(jp, jnp.asarray(x), cfg)
    _close(torch.cat([y1, y2], 1), want)
    _close_state(s2, jst)
    _close_state(c2, jconv)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_init_params_follows_jax_zamba_tree(zamba):
    """Names, shapes and types of the port's own random tree (bf16
    weights; f32 norms and Mamba-2 dt_bias2, A_log2, D2, ssm_norm) follow
    the JAX package's, and so does a tree converted to bf16."""
    cfg, jparams, _ = zamba
    want = {f"layers.{i}.{n}": a for i, layer in enumerate(jparams["layers"])
            for n, a in layer.items()}
    want.update({f"shared.{n}": a for n, a in jparams["shared"].items()})
    want.update({k: v for k, v in jparams.items()
                 if k not in ("layers", "shared")})
    f32 = ("norm", "norm1", "norm2", "final_norm", "dt_bias2", "A_log2",
           "D2", "ssm_norm")
    own = M.init_params(cfg, torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    conv = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                             dtype=torch.bfloat16)
    for p in (own, conv):
        flat = dict(p.named_parameters())
        assert set(flat) == set(want)
        for k, a in want.items():
            assert tuple(flat[k].shape) == a.shape, k
            assert flat[k].dtype == (torch.float32 if k.split(".")[-1] in f32
                                     else torch.bfloat16), k


def test_zamba_paged_steps_match_jax(rng, zamba):
    cfg, jparams, tparams = zamba
    run_steps(cfg, jparams, tparams, rng, state_rtol=1e-5)


def test_runner_caches_for_the_hybrid(zamba):
    """A KV pool over the two shared-attention layers only, and no prefix
    sharing of it (an adopted KV prefix would pair with a zero recurrent
    state), though sharing is asked for."""
    cfg, _, _ = zamba
    caches = R.RunnerCaches(cfg, kv_blocks=8, device="cpu", sharing=True)
    assert caches.attn_layers == [2, 5] and caches.mla is None
    assert caches.has_recurrent and not caches.kv.sharing
    assert caches.kv.spec.n_layers == 2
    zero = M.empty_state(cfg)
    for i, kind in enumerate(cfg.layer_kinds()):
        e = zero["layers"][i]
        if kind == MAMBA2:
            assert tuple(e["state"].shape) == (1, 8, 64, 64)
            assert tuple(e["conv"].shape) == (1, 3, 512 + 128)
        else:
            assert e == {}


def test_server_p1_d1_greedy_streams_match_jax(rng, zamba, monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_IMPL", "ref")
    cfg, jparams, tparams = zamba
    reqs = [rng.integers(0, cfg.vocab_size,
                         size=int(rng.integers(6, 20))).astype(np.int32)
            for _ in range(3)]
    jsrv = JServer(cfg, jparams, JDisagg({"P": 1, "D": 1}))
    jrids = [jsrv.submit(p, max_new_tokens=5) for p in reqs]
    jout = jsrv.run()
    srv = HydraServer(cfg, tparams, DisaggConfig({"P": 1, "D": 1}),
                      device="cpu")
    rids = [srv.submit(p, max_new_tokens=5) for p in reqs]
    out = srv.run()
    for rid, jrid in zip(rids, jrids):
        assert out[rid].generated == jout[jrid].generated
        assert len(out[rid].generated) == 5
    # each request's recurrent state and its KV over the 2 attention layers
    shapes = mamba.mamba2_cache_shape(cfg, 1)
    state_bytes = 4 * (4 * int(np.prod(shapes["state"]))
                       + 4 * int(np.prod(shapes["conv"])))
    assert srv.n_migrations >= len(reqs)
    kv_bytes = srv.migrated_bytes - srv.n_migrations * state_bytes
    assert kv_bytes >= srv.n_migrations * 2 * 2 * R.KV_BLOCK * \
        cfg.num_kv_heads * cfg.head_dim * 4
    assert_all_reclaimed(srv)


def test_engine_prefix_cache_takes_no_hit_for_the_hybrid(zamba):
    """As in the reference (tests/test_cache_sharing.py): with the prefix
    cache on, a repeated prompt is served cold, identically."""
    cfg, _, tparams = zamba
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab_size, 40).astype(np.int32)
    sp = SamplingParams(max_tokens=4)
    cold = Engine(cfg, tparams, DisaggConfig({"EPD": 1}), device="cpu")
    ref = cold.generate(prompt, sampling=sp).tokens()
    warm = Engine(cfg, tparams, DisaggConfig({"EPD": 1}), device="cpu",
                  prefix_cache=True)
    assert warm.generate(prompt, sampling=sp).tokens() == ref
    assert warm.generate(prompt, sampling=sp).tokens() == ref
    assert warm.cache_stats()["cached_prompt_tokens"] == 0
    assert_all_reclaimed(warm.server)
