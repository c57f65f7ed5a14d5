"""The port's Mamba-1 path against the JAX package's, on CPU: the selective
scan's plain version (which the wrapper takes for CPU tensors) against
``repro``'s oracle and its Pallas kernel in interpret mode; ``mamba1_seq``
with right-padded chunks; reduced falcon-mamba prefill + decode steps on
the same weights (converted through ``params_from_numpy``); and greedy
token streams of P1+D1 servers, with the recurrent state migrated P -> D
as device tensors, checksummed and transactional.

Tolerances: the scan 2e-4 in f32 and 6e-2 in bf16, the JAX package's own
bars for its kernel (tests/test_kernels.py); chunk continuity 1e-4;
masked ``mamba1_seq`` and per-layer states 1e-5 absolute; logits within
2e-4 of the reference's largest logit (tests/test_device_cache.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simulator import DisaggConfig as JDisagg
from repro.engine.server import HydraServer as JServer
from repro.kernels.selective_scan.ops import selective_scan as jscan
from repro.kernels.selective_scan.ref import selective_scan_ref as jscan_ref
from repro.models import mamba as JMamba
from repro.models import model as JM
from repro_torch.core.simulator import DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.faults import TransferError, payload_checksum
from repro_torch.engine.paged_cache import StateStore, migrate_request
from repro_torch.engine.server import HydraServer
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models import mamba
from repro_torch.models import model as M
from repro_torch.params import ParamTree, params_from_numpy

from conftest import assert_all_reclaimed, reduced_cfg

REL = 2e-4


@pytest.fixture(autouse=True)
def _f32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def fm():
    cfg = reduced_cfg("falcon-mamba-7b")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(7))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-9
    assert np.abs(got - want).max() / scale < REL


def _scan_inputs(rng, B, S, d, N):
    return (np.abs(rng.standard_normal((B, S, d))).astype(np.float32) * 0.1,
            rng.standard_normal((B, S, d)).astype(np.float32),
            -np.abs(rng.standard_normal((d, N))).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, d, N)).astype(np.float32))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("B,S,d,N,bd,ch", [(2, 64, 128, 16, 64, 32),
                                           (1, 100, 64, 8, 64, 50)])
def test_scan_matches_jax_oracle_and_kernel(rng, dtype, with_h0, B, S, d, N,
                                            bd, ch):
    dt, x, A, Bm, Cm, h0 = _scan_inputs(rng, B, S, d, N)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    jin = [jnp.asarray(a, jd) for a in (dt, x)] + [jnp.asarray(A)] + \
        [jnp.asarray(a, jd) for a in (Bm, Cm)]
    tin = [_t(a).to(td) for a in (dt, x)] + [_t(A)] + \
        [_t(a).to(td) for a in (Bm, Cm)]
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = _t(h0) if with_h0 else None
    y, h = selective_scan(*tin, th0)
    assert y.dtype == h.dtype == torch.float32
    tol = 2e-4 if dtype == "float32" else 6e-2
    for want in (jscan_ref(*jin, jh0),
                 jscan(*jin, jh0, block_d=bd, chunk=ch, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), atol=tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(want[1]), atol=tol)


def test_scan_chunk_continuity(rng):
    """Scanning two halves with the carried state == one full scan."""
    dt, x, A, Bm, Cm, _ = [_t(a) for a in _scan_inputs(rng, 1, 64, 32, 8)]
    y_full, h_full = selective_scan(dt, x, A, Bm, Cm)
    y1, h1 = selective_scan(dt[:, :32], x[:, :32], A, Bm[:, :32], Cm[:, :32])
    y2, h2 = selective_scan(dt[:, 32:], x[:, 32:], A, Bm[:, 32:], Cm[:, 32:],
                            h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-4)


def test_scan_zero_dt_leaves_state_unchanged(rng):
    dt, x, A, Bm, Cm, h0 = [_t(a) for a in _scan_inputs(rng, 2, 40, 16, 4)]
    _, h_head = selective_scan(dt[:, :25], x[:, :25], A, Bm[:, :25],
                               Cm[:, :25], h0)
    dt[:, 25:] = 0
    _, h = selective_scan(dt, x, A, Bm, Cm, h0)
    assert torch.equal(h, h_head)


# ---------------------------------------------------------------------------
# the Mamba-1 block
# ---------------------------------------------------------------------------
def test_mamba1_seq_masked_chunk_matches_jax_unpadded(rng):
    """A right-padded chunk returns the outputs, state and conv prefix of
    running each request's valid tokens alone through the JAX block."""
    cfg = reduced_cfg("falcon-mamba-7b")
    jp = JMamba.init_mamba1(jax.random.PRNGKey(3), cfg, jnp.float32)
    tp = ParamTree({k: _t(v) for k, v in jp.items()})
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    n_valid = [7, 4]
    mask = np.arange(7)[None, :] < np.asarray(n_valid)[:, None]
    y_pad, (st_pad, conv_pad) = mamba.mamba1_seq(tp, _t(x), cfg,
                                                 mask=_t(mask))
    for b, n in enumerate(n_valid):
        y, (st, conv) = JMamba.mamba1_seq(jp, jnp.asarray(x[b:b + 1, :n]),
                                          cfg)
        np.testing.assert_allclose(y_pad[b:b + 1, :n].numpy(), np.asarray(y),
                                   atol=1e-5)
        np.testing.assert_allclose(st_pad[b:b + 1].numpy(), np.asarray(st),
                                   atol=1e-5)
        np.testing.assert_allclose(conv_pad[b:b + 1].numpy(),
                                   np.asarray(conv), atol=1e-5)


def test_init_params_follows_jax_mamba_tree(fm):
    cfg, jparams, _ = fm
    p = M.init_params(cfg, torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    for jl, tl in zip(jparams["layers"], p.layers):
        got = {n: (tuple(t.shape), t.dtype) for n, t in tl.named_parameters()}
        assert set(got) == set(jl)
        for name, a in jl.items():
            f32 = name in ("norm", "dt_bias", "A_log", "D")
            assert got[name] == (a.shape, torch.float32 if f32
                                 else torch.bfloat16), name


def _steps_state(cfg, jst):
    return {"layers": [{k: _t(np.asarray(v)) for k, v in e.items()}
                       for e in jst["layers"]]}


def _close_states(got, want):
    for g, w in zip(got["layers"], want["layers"]):
        for k in ("state", "conv"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=1e-5, rtol=0)


def test_prefill_and_decode_steps_match_jax(rng, fm):
    """Two chunks (lanes of different lengths, so padded positions), then
    four teacher-forced decode steps; both packages carry their own copy of
    the per-layer state from step to step."""
    cfg, jparams, tparams = fm
    B, C = 2, 8
    jstate = JM.init_cache(cfg, B, 1)          # zero mamba state / conv
    tstate = _steps_state(cfg, jstate)
    ctx = np.zeros(B, np.int32)
    for n_new in ([8, 5], [3, 8]):
        toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        mask = np.arange(C)[None] < np.asarray(n_new)[:, None]
        last = np.asarray(n_new, np.int32) - 1
        want, _, jstate = JM.prefill_chunk_paged(
            cfg, jparams, {}, {"mask": jnp.asarray(mask),
                               "last": jnp.asarray(last)},
            jstate, jnp.asarray(ctx), jnp.asarray(toks))
        got, paged, tstate = M.prefill_chunk_paged(
            cfg, tparams, {}, {"mask": _t(mask), "last": _t(last)}, tstate,
            _t(ctx), _t(toks))
        assert paged == {}
        _close_logits(got.numpy(), want)
        _close_states(tstate, jstate)
        ctx += np.asarray(n_new, np.int32)
    tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    for _ in range(4):
        want, _, jstate = JM.decode_step_paged(
            cfg, jparams, {}, {}, jstate, jnp.asarray(ctx),
            jnp.asarray(tok[:, None]))
        got, _, tstate = M.decode_step_paged(
            cfg, tparams, {}, {}, tstate, _t(ctx), _t(tok[:, None]))
        _close_logits(got.numpy(), want)
        _close_states(tstate, jstate)
        ctx += 1
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)


# ---------------------------------------------------------------------------
# runner and server
# ---------------------------------------------------------------------------
def test_runner_caches_for_an_attention_free_model(fm):
    cfg, _, _ = fm
    caches = R.RunnerCaches(cfg, kv_blocks=8, device="cpu", sharing=True)
    assert caches.kv is None and caches.img is None
    assert caches.has_recurrent and caches.stores == [caches.states]
    assert caches.kv_tokens_free() == caches.kv_tokens_total() == 1 << 30


def test_runner_keeps_f32_state_as_tensors_with_bf16_weights(rng, fm):
    cfg, _, _ = fm
    params = M.init_params(cfg, torch.Generator().manual_seed(1),
                           dtype=torch.bfloat16)
    caches = R.RunnerCaches(cfg, dtype=torch.bfloat16, device="cpu")
    runner = R.ModelRunner(cfg, params, caches, device="cpu")
    runner.prefill_chunks([(0, rng.integers(0, cfg.vocab_size, 9), False),
                           (1, rng.integers(0, cfg.vocab_size, 5), False)])
    runner.decode([0, 1], np.asarray([3, 4], np.int32))
    for rid, n in ((0, 10), (1, 6)):
        st = caches.states.get(rid)
        assert runner._ctx_len(rid) == st["ctx_len"] == n
        for i in range(cfg.num_layers):
            e = st[f"mamba{i}"]
            assert e["state"].dtype == torch.float32
            assert e["conv"].dtype == torch.bfloat16
            assert tuple(e["state"].shape) == (1, cfg.d_inner, cfg.ssm_state)
    per_layer = cfg.d_inner * cfg.ssm_state * 4 + \
        (cfg.conv_kernel - 1) * cfg.d_inner * 2
    assert caches.states.nbytes(0) == cfg.num_layers * per_layer


def test_server_p1_d1_greedy_streams_match_jax(rng, fm):
    cfg, jparams, tparams = fm
    reqs = [rng.integers(0, cfg.vocab_size,
                         size=int(rng.integers(6, 14))).astype(np.int32)
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
    assert srv.n_migrations > 0
    assert srv.migrated_bytes >= srv.n_migrations * cfg.num_layers * \
        cfg.d_inner * cfg.ssm_state * 4
    assert_all_reclaimed(srv)


@pytest.mark.parametrize("fault", ["corrupt", "drop"])
def test_state_transfer_fault_raises_and_rolls_back(rng, fm, fault):
    """A tensor-valued Mamba state payload that is corrupted or lost in
    flight raises TransferError; the destination holds nothing and the
    source keeps its copy, bit for bit."""
    cfg, _, tparams = fm
    src = R.RunnerCaches(cfg, device="cpu")
    dst = R.RunnerCaches(cfg, device="cpu")
    runner = R.ModelRunner(cfg, tparams, src, device="cpu")
    runner.prefill_chunk(4, rng.integers(0, cfg.vocab_size, 7))
    before = payload_checksum(src.states.read_blocks(4))
    with pytest.raises(TransferError) as e:
        R.migrate(4, src, dst, fault=fault)
    assert e.value.kind == fault
    assert dst.states.get(4) is None
    assert payload_checksum(src.states.read_blocks(4)) == before
    moved = R.migrate(4, src, dst)
    assert moved == dst.states.nbytes(4) > 0
    assert src.states.get(4) is None
    assert payload_checksum(dst.states.read_blocks(4)) == before


def test_state_store_migrates_tensor_payloads(rng):
    src, dst = StateStore(), StateStore()
    st = {"ctx_len": 3,
          "mamba0": {"state": _t(rng.standard_normal((1, 8, 4))
                                 .astype(np.float32)),
                     "conv": _t(rng.standard_normal((1, 3, 8))
                                .astype(np.float32)).to(torch.bfloat16)}}
    src.put(0, st)
    assert migrate_request(0, [src], [dst]) == 8 * 4 * 4 + 3 * 8 * 2
    got = dst.get(0)["mamba0"]
    assert torch.equal(got["state"], st["mamba0"]["state"])
    assert torch.equal(got["conv"], st["mamba0"]["conv"])
