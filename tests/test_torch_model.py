"""The port's model steps against ``repro.models.model`` on the same weights
(converted through ``params_from_numpy``), the same page pools and the same
control tensors, on reduced LLaVA-1.5-7B in f32, and reduced gemma3-4b
(sliding-window local layers, tied embeddings, GeGLU) and stablelm-12b (at
its head dim of 160) through the shared teacher-forced steps of
tests/_torch_steps.py.  Also: every served config's attention width is one
the kernels are built for.

Tolerances: logits within 2e-4 of the reference's largest logit, the
reference's own bar for paged vs dense steps (tests/test_device_cache.py);
page pools within 1e-5 absolute; sampled ids identical when both sides get
the same Gumbel noise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.engine.paged_cache import DevicePagedCache, PagedCacheSpec
from repro_torch.engine.runner import _seq_layers, bucket_pow2
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy

from _torch_steps import run_steps
from conftest import reduced_cfg

REL = 2e-4


@pytest.fixture(scope="module")
def llava():
    cfg = reduced_cfg("llava-1.5-7b")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-9
    assert np.abs(got - want).max() / scale < REL


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_params_tree_follows_jax_names(llava):
    cfg, jparams, tparams = llava
    assert tparams.embed.shape == jparams["embed"].shape
    assert tparams.media_proj_w2.shape == jparams["media_proj_w2"].shape
    for jl, tl in zip(jparams["layers"], tparams.layers):
        assert {n for n, _ in tl.named_parameters()} == set(jl)
        for name, arr in jl.items():
            np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                          np.asarray(arr))


def test_init_params_matches_jax_tree_shapes(llava):
    cfg, jparams, _ = llava
    p = M.init_params(cfg, torch.Generator().manual_seed(0))
    flat = dict(p.named_parameters())
    want = {}
    for k, v in jparams.items():
        if k == "layers":
            for i, layer in enumerate(v):
                want.update({f"layers.{i}.{n}": a for n, a in layer.items()})
        else:
            want[k] = v
    assert set(flat) == set(want)
    for k, a in want.items():
        assert tuple(flat[k].shape) == a.shape
        assert str(flat[k].dtype).split(".")[-1] == str(a.dtype), k


@pytest.mark.parametrize("arch", ["zamba2-7b"])
def test_unported_families_raise(arch):
    """Every layer kind is ported; a Mamba model with a media frontend is
    not, and says where it is queued."""
    cfg = dataclasses.replace(get_config(arch).reduced(), frontend="vision",
                              media_tokens=16)
    M.check_supported(get_config(arch).reduced())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_params(cfg, torch.Generator().manual_seed(0))


def test_gemma3_paged_steps_match_jax(rng):
    """Reduced gemma3-4b: sliding window 16 on the local layers, one
    global layer in 2, tied embeddings, GeGLU; prefill chunks and decode
    steps past the window against the JAX package's."""
    cfg = reduced_cfg("gemma3-4b")
    assert cfg.sliding_window == 16 and cfg.tie_embeddings
    assert [cfg.is_local_layer(i) for i in range(2)] == [True, False]
    jparams = JM.init_params(cfg, jax.random.PRNGKey(9))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert "lm_head" not in dict(tparams.named_parameters())
    run_steps(cfg, jparams, tparams, rng, n_decode=6)


def test_encode_media_matches_jax(rng, llava):
    cfg, jparams, tparams = llava
    media = (rng.standard_normal((2, cfg.media_tokens, cfg.d_model))
             * 0.1).astype(np.float32)
    want = JM.encode_media(cfg, jparams, jnp.asarray(media))
    got = M.encode_media(cfg, tparams, _t(media))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_prefill_and_decode_steps_match_jax(rng, llava):
    """Media chunk, then a text chunk (lanes of different lengths, so
    padded positions), then four teacher-forced decode steps, with both
    packages reading and writing their own copy of the same pools."""
    cfg, jparams, tparams = llava
    B, n_media = 2, cfg.media_tokens
    kv_spec = PagedCacheSpec(2, cfg.num_layers, 16,
                             cfg.num_kv_heads * cfg.head_dim, 16)
    img_spec = PagedCacheSpec(1, 1, n_media, cfg.d_model, 4)
    kv = DevicePagedCache(kv_spec, device="cpu")       # bookkeeping + pool
    img = DevicePagedCache(img_spec, device="cpu")
    media = (rng.standard_normal((B, n_media, cfg.d_model))
             * 0.1).astype(np.float32)
    emb = M.encode_media(cfg, tparams, _t(media))
    for b in range(B):
        img.append(b, emb[b][None, None])
    jkv = jnp.asarray(kv.data.numpy())
    jimg = jnp.asarray(img.data.numpy())
    state = {"layers": [{} for _ in range(cfg.num_layers)]}

    def chunk(n_new, tokens, img_slots):
        C = tokens.shape[1]
        ctx = np.asarray([kv.lengths.get(b, 0) for b in range(B)], np.int32)
        pages = max(-(-(c + n) // 16) for c, n in zip(ctx, n_new))
        tables, slots = kv.prepare_prefill(list(range(B)), n_new, B, C,
                                           bucket_pow2(int(pages)))
        mask = np.arange(C)[None] < np.asarray(n_new)[:, None]
        last = np.asarray(n_new, np.int32) - 1
        jctl = {"kv": {"tables": jnp.asarray(tables),
                       "slots": jnp.asarray(slots)},
                "mask": jnp.asarray(mask), "last": jnp.asarray(last)}
        tctl = {"kv": {"tables": _t(tables), "slots": _t(slots)},
                "mask": _t(mask), "last": _t(last)}
        if img_slots is not None:
            jctl["img"] = {"slots": jnp.asarray(img_slots), "pages": jimg}
            tctl["img"] = {"slots": _t(img_slots), "pages": img.data}
        want, jdata, _ = JM.prefill_chunk_paged(
            cfg, jparams, {"kv": jkv}, jctl, state, jnp.asarray(ctx),
            jnp.asarray(tokens), attn_impl="ref")
        got, _, _ = M.prefill_chunk_paged(cfg, tparams, {"kv": kv.data},
                                          tctl, state, _t(ctx), _t(tokens))
        kv.commit_prefill(list(range(B)), n_new)
        return got, want, jdata["kv"]

    img_slots = np.stack([img.row_slots(b, 0, n_media) for b in range(B)])
    got, want, jkv = chunk([n_media] * B, np.zeros((B, n_media), np.int32),
                           img_slots)
    _close_logits(got.numpy(), want)
    n_text = [8, 5]
    toks = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    got, want, jkv = chunk(n_text, toks, None)
    _close_logits(got.numpy(), want)
    tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    for _ in range(4):
        lens = np.asarray([kv.lengths[b] for b in range(B)], np.int32)
        pages = max(-(-(n + 1) // 16) for n in lens)
        tables, slots = kv.prepare_decode(list(range(B)), B,
                                          bucket_pow2(int(pages)))
        want, jdata, _ = JM.decode_step_paged(
            cfg, jparams, {"kv": jkv}, {"kv": {"tables": jnp.asarray(tables),
                                               "slots": jnp.asarray(slots)}},
            state, jnp.asarray(lens), jnp.asarray(tok[:, None]),
            attn_impl="ref")
        got, _, _ = M.decode_step_paged(
            cfg, tparams, {"kv": kv.data},
            {"kv": {"tables": _t(tables), "slots": _t(slots)}}, state,
            _t(lens), _t(tok[:, None]))
        kv.commit_decode(list(range(B)))
        jkv = jdata["kv"]
        _close_logits(got.numpy(), want)
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    n = kv.spec.num_blocks        # scratch excluded: padded writes collide
    np.testing.assert_allclose(kv.data.numpy()[:, :, :n],
                               np.asarray(jkv)[:, :, :n], atol=1e-5, rtol=0)


def test_sample_from_logits_matches_jax_with_shared_noise(rng):
    """Greedy, top-k, top-p and top-k+top-p lanes pick identical ids when
    the port is handed the Gumbel noise the JAX sampler draws."""
    B, V = 6, 97
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    sample = {"temp": np.asarray([0, 1.0, 0.7, 1.3, 0.9, 1.0], np.float32),
              "top_k": np.asarray([0, 5, 0, 12, 1, 0], np.int32),
              "top_p": np.asarray([1, 1, 0.6, 0.8, 1, 0.95], np.float32),
              "seed": np.arange(B, dtype=np.uint32) + 11,
              "step": np.asarray([0, 1, 2, 3, 4, 5], np.int32)}
    want = np.asarray(JM.sample_from_logits(
        jnp.asarray(logits), {k: jnp.asarray(v) for k, v in sample.items()}))

    def gumbel(seed, step):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        return jax.random.gumbel(key, (V,), jnp.float32)

    noise = np.asarray(jax.vmap(gumbel)(jnp.asarray(sample["seed"]),
                                        jnp.asarray(sample["step"])))
    tsample = {k: _t(v.astype(np.int64) if v.dtype == np.uint32 else v)
               for k, v in sample.items()}
    got = M.sample_from_logits(_t(logits), tsample, noise=_t(noise)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.argmax(logits[0]))


def test_own_gumbel_draw_is_a_function_of_seed_and_step():
    """Without shared noise the port draws per lane from (seed, step):
    the same pair gives the same draw whatever the batch around it."""
    a = M.gumbel_noise([5, 9], [3, 0], 64, "cpu")
    b = M.gumbel_noise([9, 1, 5], [0, 0, 3], 64, "cpu")
    np.testing.assert_array_equal(a[0].numpy(), b[2].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[0].numpy())
    assert not torch.equal(a[0], a[1])


def test_stablelm_paged_steps_match_jax():
    """Reduced stablelm-12b kept at its published head dim, D = 160, and
    its GQA ratio of 4 query heads a KV head; prefill chunks and decode
    steps against the JAX package's (inputs from a generator of its own,
    so the shared ``rng`` fixture's stream is what it was for later
    tests)."""
    cfg = reduced_cfg("stablelm-12b", head_dim=160, num_kv_heads=1)
    full = get_config("stablelm-12b")
    assert cfg.head_dim == full.head_dim
    assert cfg.num_heads // cfg.num_kv_heads == \
        full.num_heads // full.num_kv_heads
    jparams = JM.init_params(cfg, jax.random.PRNGKey(12))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    run_steps(cfg, jparams, tparams, np.random.default_rng(160), n_decode=4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_served_head_dim_is_built(arch):
    """Every config is admitted, and has its paged attention width (the
    head dim, or MLA's latent row) among the widths the decode and bf16
    chunked-prefill kernels are built for, and its training attention pair
    (Dqk, Dv) among flash attention's (forward and backward): (head_dim,
    head_dim), or (qk_nope + qk_rope, v_head_dim) for MLA; a
    cross-attention model's head dim among them too.  A gap fails here,
    not on the card."""
    cfg = get_config(arch)
    M.check_supported(cfg)
    attn, mla = _seq_layers(cfg)
    widths = ([cfg.head_dim] if attn else []) + \
        ([cfg.kv_lora_rank + cfg.qk_rope_head_dim] if mla else [])
    for D in widths:
        assert D in tpa.DECODE_HEAD_DIMS, (arch, D)
        assert D in tpa.PREFILL_BF16_HEAD_DIMS, (arch, D)
    pairs = ([(cfg.head_dim, cfg.head_dim)] if attn else []) + \
        ([(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)]
         if mla else [])
    for pair in pairs:
        assert pair in tfa.HEAD_DIMS, (arch, pair)
    if cfg.cross_attention:
        assert (cfg.head_dim, cfg.head_dim) in tfa.HEAD_DIMS, arch
