"""Teacher-forced paged steps through both packages, for the port's
model-level parity tests: two prefill chunks (lanes of different lengths,
so padded positions), then decode steps, each package reading and writing
its own copy of the same page pools ("kv" and/or "mla") built from the
same control tensors, and carrying its own copy of the per-layer Mamba
state and conv prefix from step to step.

Tolerances: logits within 2e-4 of the reference's largest logit, the
reference's own bar for paged vs dense steps (tests/test_device_cache.py);
pools and Mamba states within 1e-5 absolute (a caller may add a
relative bar for states that grow large, ``state_rtol``).
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import model as JM
from repro_torch.engine import runner as R
from repro_torch.engine.paged_cache import DevicePagedCache, PagedCacheSpec
from repro_torch.models import model as M

REL = 2e-4


def close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-9
    assert np.abs(got - want).max() / scale < REL


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pools(cfg, n_blocks=16):
    """{"kv" / "mla": DevicePagedCache} on the CPU, as RunnerCaches builds
    them."""
    attn, mla = R._seq_layers(cfg)
    out = {}
    if attn:
        out["kv"] = DevicePagedCache(PagedCacheSpec(
            2, len(attn), R.KV_BLOCK, cfg.num_kv_heads * cfg.head_dim,
            n_blocks), device="cpu")
    if mla:
        out["mla"] = DevicePagedCache(PagedCacheSpec(
            1, len(mla), R.KV_BLOCK, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
            n_blocks), device="cpu")
    return out


def _close_states(got, want, rtol):
    """Per-layer Mamba state and conv prefix (layers without: empty)."""
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=1e-5, rtol=rtol)


def run_steps(cfg, jparams, tparams, rng, *, n_decode=4, state_rtol=0.0):
    """Prefill chunks of [8, 5] then [3, 8] tokens for two lanes, then
    ``n_decode`` greedy teacher-forced decode steps; asserts logits, Mamba
    states and pools against the JAX package's ``*_paged`` steps ("ref"
    kernels)."""
    B = 2
    pools = _pools(cfg)
    jdata = {n: jnp.asarray(c.data.numpy()) for n, c in pools.items()}
    zero = M.empty_state(cfg)              # one lane: Mamba layers' zeros
    tstate = {"layers": [{k: v.expand(B, *v.shape[1:]).contiguous()
                          for k, v in e.items()} for e in zero["layers"]]}
    jstate = {"layers": [{k: jnp.asarray(v.numpy()) for k, v in e.items()}
                         for e in tstate["layers"]]}
    rids = list(range(B))
    lens0 = next(iter(pools.values())).lengths

    def ctl(prep):
        jc, tc = {}, {}
        for n, c in pools.items():
            tables, slots = prep(c)
            jc[n] = {"tables": jnp.asarray(tables),
                     "slots": jnp.asarray(slots)}
            tc[n] = {"tables": t(tables), "slots": t(slots)}
        return jc, tc

    def chunk(n_new):
        nonlocal jdata, jstate, tstate
        C = R.bucket_pow2(max(n_new))
        tokens = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        ctx = np.asarray([lens0.get(b, 0) for b in rids], np.int32)
        pages = max(-(-(c + n) // R.KV_BLOCK) for c, n in zip(ctx, n_new))
        jc, tc = ctl(lambda c: c.prepare_prefill(
            rids, n_new, B, C, R.bucket_pow2(int(pages))))
        mask = np.arange(C)[None] < np.asarray(n_new)[:, None]
        last = np.asarray(n_new, np.int32) - 1
        for c, v in ((jc, jnp.asarray), (tc, t)):
            c.update(mask=v(mask), last=v(last))
        want, jdata, jstate = JM.prefill_chunk_paged(
            cfg, jparams, jdata, jc, jstate, jnp.asarray(ctx),
            jnp.asarray(tokens), attn_impl="ref")
        got, _, tstate = M.prefill_chunk_paged(
            cfg, tparams, {n: c.data for n, c in pools.items()}, tc, tstate,
            t(ctx), t(tokens))
        for c in pools.values():
            c.commit_prefill(rids, n_new)
        close_logits(got.numpy(), want)
        _close_states(tstate, jstate, state_rtol)
        return want

    chunk([8, 5])
    want = chunk([3, 8])
    tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    for _ in range(n_decode):
        lens = np.asarray([lens0[b] for b in rids], np.int32)
        pages = max(-(-(n + 1) // R.KV_BLOCK) for n in lens)
        jc, tc = ctl(lambda c: c.prepare_decode(rids, B,
                                                R.bucket_pow2(int(pages))))
        want, jdata, jstate = JM.decode_step_paged(
            cfg, jparams, jdata, jc, jstate, jnp.asarray(lens),
            jnp.asarray(tok[:, None]), attn_impl="ref")
        got, _, tstate = M.decode_step_paged(
            cfg, tparams, {n: c.data for n, c in pools.items()}, tc, tstate,
            t(lens), t(tok[:, None]))
        for c in pools.values():
            c.commit_decode(rids)
        close_logits(got.numpy(), want)
        _close_states(tstate, jstate, state_rtol)
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    for n, c in pools.items():
        nb = c.spec.num_blocks      # scratch excluded: padded writes collide
        np.testing.assert_allclose(c.data.numpy()[:, :, :nb],
                                   np.asarray(jdata[n])[:, :, :nb],
                                   atol=1e-5, rtol=0)
