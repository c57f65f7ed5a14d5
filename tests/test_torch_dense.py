"""The port's dense decode path against ``repro.models`` on the same
weights and the same seeded numpy inputs, on the CPU:
``layers.decode_attention`` / ``cache_write`` / ``ring_write``, and
``prefill`` + ``build_cache_from_prefill`` + ``decode_step``
teacher-forced (the reference's ``_ref_generate``, tests/test_engine.py)
for every layer kind (set-up: tests/_torch_dense.py).

Tolerances: decode attention 1e-5 absolute (f32, the same sums in
another order); cache writes exact; logits within 2e-4 of the
reference's largest logit, the reference's bar for one step path
against another (tests/test_device_cache.py); cache rows 1e-4 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.models import layers as L
from repro_torch.models import model as M

from _torch_dense import close, jax_steps, t, weights


# (B, S, H, Kh, D, cache_len, ring, window): per-lane lengths (one past
# the cache: clamped to it), GQA, a ring buffer, a window on a
# full-length cache, a scalar length
DECODE_CASES = [
    (3, 32, 4, 2, 64, [0, 13, 40], False, 0),
    (2, 16, 4, 4, 32, [5, 20], True, 16),
    (3, 48, 8, 2, 64, [10, 30, 47], False, 12),
    (2, 24, 4, 1, 80, 17, False, 0),
]


@pytest.mark.parametrize("B,S,H,Kh,D,cache_len,ring,window", DECODE_CASES)
def test_decode_attention_matches_jax(rng, B, S, H, Kh, D, cache_len, ring,
                                      window):
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, Kh * D)).astype(np.float32)
    vc = rng.standard_normal((B, S, Kh * D)).astype(np.float32)
    want = jax.jit(JL.decode_attention, static_argnames=(
        "n_kv_heads", "ring", "window"))(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(cache_len), n_kv_heads=Kh, ring=ring, window=window)
    got = L.decode_attention(t(q), t(kc), t(vc), torch.tensor(cache_len),
                             n_kv_heads=Kh, ring=ring, window=window)
    assert got.shape == (B, 1, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("index,T,ring", [(5, 3, False), ([0, 7, 15], 1,
                                                          False),
                                          ([3, 21, 40], 1, True)])
def test_cache_write_matches_jax(rng, index, T, ring):
    cache = rng.standard_normal((3, 16, 24)).astype(np.float32)
    new = rng.standard_normal((3, T, 24)).astype(np.float32)
    jfn, tfn = (JL.ring_write, L.ring_write) if ring else \
        (JL.cache_write, L.cache_write)
    want = jfn(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(index))
    got = t(cache)
    assert tfn(got, t(new), torch.tensor(index)) is got    # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _inputs(cfg, rng, n_prompt):
    prompt = rng.integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
    media = None
    if cfg.frontend != "none":
        media = (rng.standard_normal((1, cfg.media_tokens, cfg.d_model))
                 * 0.1).astype(np.float32)
    kw = {"audio": "frames", "vision": "media"}.get(cfg.frontend)
    return prompt, media, kw


# prompts past gemma3's window of 16 make its local layers' caches rings
DECODE_ARCHS = [("llava-1.5-7b", 9), ("gemma3-4b", 21), ("whisper-small", 7),
                ("falcon-mamba-7b", 11), ("zamba2-7b", 10),
                ("granite-moe-1b-a400m", 8), ("deepseek-v2-236b", 12)]


@pytest.mark.parametrize("arch,n_prompt", DECODE_ARCHS,
                         ids=[a for a, _ in DECODE_ARCHS])
def test_decode_steps_match_jax(rng, arch, n_prompt):
    """prefill, build_cache_from_prefill, then six decode steps fed the
    reference's greedy tokens (gemma3's ring wraps past its window)."""
    cfg, jparams, tparams = weights(arch)
    J = jax_steps(cfg)
    prompt, media, kw = _inputs(cfg, rng, n_prompt)
    n_new = 6
    jkw = {kw: jnp.asarray(media)} if kw else {}
    tkw = {kw: t(media)} if kw else {}
    with torch.inference_mode():
        jl, jc = J["prefill"](jparams, jnp.asarray(prompt)[None], **jkw)
        tl, tc = M.prefill(cfg, tparams, t(prompt)[None], **tkw)
        close(tl.numpy(), jl)
        S = n_prompt + (cfg.media_tokens if kw == "media" else 0)
        max_len = S + n_new + 1
        jc = JM.build_cache_from_prefill(cfg, jc, max_len)
        tc = M.build_cache_from_prefill(cfg, tc, max_len)
        tok = int(np.argmax(np.asarray(jl[0])))
        for step in range(n_new):
            jl, jc = J["decode_step"](jparams, jc, jnp.int32(S + step),
                                      jnp.asarray([[tok]], jnp.int32))
            tl, tc = M.decode_step(cfg, tparams, tc, torch.tensor(S + step),
                                   torch.tensor([[tok]], dtype=torch.int32))
            close(tl.numpy(), jl)
            tok = int(np.argmax(np.asarray(jl[0])))
    for kind, je, te in zip(cfg.layer_kinds(), jc["layers"], tc["layers"]):
        if "lat" in te:           # the JAX package keeps ckv/krope apart
            je = {"lat": np.concatenate([je["ckv"], je["krope"]], -1)}
        for name, arr in je.items():
            np.testing.assert_allclose(te[name].numpy(), np.asarray(arr),
                                       atol=1e-4, err_msg=f"{kind} {name}")


@pytest.mark.parametrize("arch", [a for a, _ in DECODE_ARCHS])
def test_init_cache_matches_jax(arch):
    """The zero dense caches: the JAX package's shapes and types (a
    sliding-window layer's as long as its window, Mamba states f32), an
    MLA layer's ``ckv`` and ``krope`` side by side in one ``lat``."""
    cfg, _, _ = weights(arch)
    want = JM.init_cache(cfg, 2, 40, dtype=jnp.bfloat16)
    got = M.init_cache(cfg, 2, 40, dtype=torch.bfloat16)
    for je, te in zip(want["layers"], got["layers"]):
        if "ckv" in je:
            je = {"lat": jnp.zeros(je["ckv"].shape[:2] + (
                je["ckv"].shape[2] + je["krope"].shape[2],), jnp.bfloat16)}
        assert {n: (tuple(a.shape), str(a.dtype)) for n, a in je.items()} \
            == {n: (tuple(a.shape), str(a.dtype).split(".")[1])
                for n, a in te.items()}
        assert all(not a.any() for a in te.values())
