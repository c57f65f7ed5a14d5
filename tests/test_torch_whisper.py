"""The port's whisper path against the JAX package's, on CPU: the flash
attention wrapper's plain version (which it takes for CPU tensors) against
``repro``'s oracle and its Pallas kernel in interpret mode; the
full-sequence attention and sinusoidal positions of ``models.layers``; the
audio encoder; reduced whisper-small prefill + teacher-forced decode steps
on the same weights (converted through ``params_from_numpy``) and the same
page pools; and greedy token streams of E1+PD1 and E1+P1+D1 servers, with
the encoder output and cross K/V migrated as device tensors, checksummed.

Tolerances: attention and the encoder 1e-5 absolute (f32, summation order
only); logits within 2e-4 of the reference's largest logit
(tests/test_device_cache.py); cross K/V 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simulator import DisaggConfig as JDisagg
from repro.engine.server import HydraServer as JServer
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import flash_attention_ref as jflash_ref
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.core.request import SamplingParams
from repro_torch.core.simulator import DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.api import Engine
from repro_torch.engine.faults import TransferError, payload_checksum
from repro_torch.engine.paged_cache import DevicePagedCache, PagedCacheSpec
from repro_torch.engine.server import HydraServer
from repro_torch.engine.runner import bucket_pow2
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy

from conftest import assert_all_reclaimed, reduced_cfg

ATOL = 1e-5
REL = 2e-4


@pytest.fixture(autouse=True)
def _f32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def whisper():
    cfg = reduced_cfg("whisper-small")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(9))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-9
    assert np.abs(got - want).max() / scale < REL


def _clip(rng, cfg):
    return (rng.standard_normal((cfg.media_tokens, cfg.d_model))
            * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
# (B, H, Kh, Sq, Sk, D, causal, window, kv_offset): odd lengths that are not
# block multiples, Sq != Sk, GQA, windows, a decode row (Sq = 1)
FLASH_CASES = [
    (1, 4, 4, 37, 150, 64, False, 0, 0),
    (2, 4, 2, 40, 40, 64, True, 0, 0),
    (1, 8, 2, 33, 100, 128, True, 16, 0),
    (2, 2, 2, 1, 75, 64, False, 0, 0),
    (1, 4, 1, 70, 131, 64, False, 48, 0),
    (1, 4, 2, 29, 129, 64, True, 0, 100),
    (2, 4, 4, 23, 90, 64, True, 20, 67),
]


@pytest.mark.parametrize("B,H,Kh,Sq,Sk,D,causal,window,off", FLASH_CASES)
def test_flash_attention_matches_jax_oracle_and_kernel(rng, B, H, Kh, Sq, Sk,
                                                       D, causal, window,
                                                       off):
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Kh, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Kh, Sk, D)).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                          kv_offset=off).numpy()
    want = jflash_ref(q, k, v, causal=causal, window=window, kv_offset=off)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    if off == 0:         # the Pallas kernel has no offset: queries start at 0
        want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window, block_q=16, block_k=64,
                      interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_flash_attention_rows_without_keys_are_zero(rng):
    """A query that sees no key (it sits before k[0]) comes out 0, as the
    JAX oracle gives it."""
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 2, 6, 64), (1, 2, 10, 64), (1, 2, 10, 64)))
    got = flash_attention(q, k, v, causal=True, window=4, kv_offset=-3)
    want = jflash_ref(q.numpy(), k.numpy(), v.numpy(), causal=True, window=4,
                      kv_offset=-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[:, :, :3].any() and got[:, :, 3:].abs().min() > 0


@pytest.mark.parametrize("Sq,Sk,H,Kh,causal,window,off", [
    (24, 24, 4, 4, False, 0, 0),          # encoder self-attention
    (9, 16, 4, 4, False, 0, 0),           # cross-attention of a chunk
    (24, 24, 4, 2, True, 0, 0),
    (20, 20, 4, 4, True, 8, 0),
    (7, 19, 4, 1, True, 0, 12),           # a chunk after a cached prefix
])
def test_blockwise_attention_matches_jax(rng, Sq, Sk, H, Kh, causal, window,
                                         off):
    q = rng.standard_normal((2, Sq, H, 64)).astype(np.float32)
    k = rng.standard_normal((2, Sk, Kh, 64)).astype(np.float32)
    v = rng.standard_normal((2, Sk, Kh, 64)).astype(np.float32)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, kv_offset=off, q_chunk=8)
    got = layers.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                     window=window, kv_offset=off)
    assert got.shape == (2, Sq, H, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# XLA's and torch's f32 exp differ by one ulp on some frequencies; an angle
# pos * freq then differs by up to pos * 6e-8, 9e-5 at the encoder's last
# frame (1499), so the long positions get 2e-4
@pytest.mark.parametrize("positions,atol", [([0, 1, 7, 31, 63], ATOL),
                                            ([511, 1024, 1499], 2e-4)],
                         ids=["short", "long"])
@pytest.mark.parametrize("d_model", [256, 768])
def test_sinusoidal_positions_match_jax(d_model, positions, atol):
    pos = np.asarray(positions, np.int32)
    want = JL.sinusoidal_positions(jnp.asarray(pos), d_model)
    got = layers.sinusoidal_positions(_t(pos), d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# params and the encoder
# ---------------------------------------------------------------------------
def test_params_keep_norms_f32_in_bf16(whisper):
    """``xnorm`` and every other norm scale stay f32 after a bf16
    conversion, as the JAX package keeps them; the rest becomes bf16."""
    cfg, jparams, _ = whisper
    p = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                          dtype=torch.bfloat16)
    for name, t in p.named_parameters():
        leaf = name.split(".")[-1]
        norm = leaf in ("xnorm", "norm", "norm1", "norm2", "final_norm")
        assert t.dtype == (torch.float32 if norm else torch.bfloat16), name
    assert p.layers[0].xnorm.dtype == torch.float32
    np.testing.assert_array_equal(p.layers[1].xnorm.numpy(),
                                  np.asarray(jparams["layers"][1]["xnorm"]))


def test_init_params_follows_jax_whisper_tree(whisper):
    cfg, jparams, _ = whisper
    p = M.init_params(cfg, torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    want = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif isinstance(v, list):
                for i, e in enumerate(v):
                    walk(e, f"{prefix}{k}.{i}.")
            else:
                want[prefix + k] = v
    walk(jparams, "")
    got = dict(p.named_parameters())
    assert set(got) == set(want)
    for name, a in want.items():
        f32 = a.dtype == jnp.float32 and a.ndim == 1
        assert tuple(got[name].shape) == a.shape, name
        assert got[name].dtype == (torch.float32 if f32
                                   else torch.bfloat16), name


def test_encode_media_matches_jax(rng, whisper):
    cfg, jparams, tparams = whisper
    media = np.stack([_clip(rng, cfg) for _ in range(2)])
    want = JM.encode_media(cfg, jparams, jnp.asarray(media))
    got = M.encode_media(cfg, tparams, _t(media))
    assert got.shape == (2, cfg.media_tokens, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# the paged steps
# ---------------------------------------------------------------------------
def test_prefill_and_decode_steps_match_jax(rng, whisper):
    """Two prompt chunks (lanes of different lengths, so padded positions)
    cross-attending each lane's own encoder output, then four
    teacher-forced decode steps over the cross K/V the prefill returned;
    both packages read and write their own copy of the same pool."""
    cfg, jparams, tparams = whisper
    B, C = 2, 8
    kv = DevicePagedCache(PagedCacheSpec(2, cfg.num_layers, 16,
                                         cfg.num_kv_heads * cfg.head_dim,
                                         16), device="cpu")
    jkv = jnp.asarray(kv.data.numpy())
    media = np.stack([_clip(rng, cfg) for _ in range(B)])
    enc = M.encode_media(cfg, tparams, _t(media))
    jenc = JM.encode_media(cfg, jparams, jnp.asarray(media))
    empty = [{} for _ in range(cfg.num_layers)]
    rids = list(range(B))
    for n_new in ([8, 5], [3, 8]):
        toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        ctx = np.asarray([kv.lengths.get(b, 0) for b in rids], np.int32)
        pages = max(-(-(c + n) // 16) for c, n in zip(ctx, n_new))
        tables, slots = kv.prepare_prefill(rids, n_new, B, C,
                                           bucket_pow2(int(pages)))
        mask = np.arange(C)[None] < np.asarray(n_new)[:, None]
        last = np.asarray(n_new, np.int32) - 1
        want, jdata, jnew = JM.prefill_chunk_paged(
            cfg, jparams, {"kv": jkv},
            {"kv": {"tables": jnp.asarray(tables),
                    "slots": jnp.asarray(slots)},
             "mask": jnp.asarray(mask), "last": jnp.asarray(last)},
            {"layers": empty, "enc_out": jenc}, jnp.asarray(ctx),
            jnp.asarray(toks), attn_impl="ref")
        got, _, new = M.prefill_chunk_paged(
            cfg, tparams, {"kv": kv.data},
            {"kv": {"tables": _t(tables), "slots": _t(slots)},
             "mask": _t(mask), "last": _t(last)},
            {"layers": empty, "enc_out": enc}, _t(ctx), _t(toks))
        kv.commit_prefill(rids, n_new)
        jkv = jdata["kv"]
        _close_logits(got.numpy(), want)
        for g, w in zip(new["layers"], jnew["layers"]):
            for name in ("xk", "xv"):
                np.testing.assert_allclose(g[name].numpy(),
                                           np.asarray(w[name]), atol=ATOL,
                                           rtol=0)
    jstate = {"layers": [{"xk": e["xk"], "xv": e["xv"]}
                         for e in jnew["layers"]]}
    state = {"layers": [{"xk": e["xk"], "xv": e["xv"]}
                        for e in new["layers"]]}
    tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    for _ in range(4):
        lens = np.asarray([kv.lengths[b] for b in rids], np.int32)
        pages = max(-(-(n + 1) // 16) for n in lens)
        tables, slots = kv.prepare_decode(rids, B, bucket_pow2(int(pages)))
        want, jdata, _ = JM.decode_step_paged(
            cfg, jparams, {"kv": jkv}, {"kv": {"tables": jnp.asarray(tables),
                                               "slots": jnp.asarray(slots)}},
            jstate, jnp.asarray(lens), jnp.asarray(tok[:, None]),
            attn_impl="ref")
        got, _, new = M.decode_step_paged(
            cfg, tparams, {"kv": kv.data},
            {"kv": {"tables": _t(tables), "slots": _t(slots)}}, state,
            _t(lens), _t(tok[:, None]))
        assert all(e == {} for e in new["layers"])
        kv.commit_decode(rids)
        jkv = jdata["kv"]
        _close_logits(got.numpy(), want)
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    n = kv.spec.num_blocks        # scratch excluded: padded writes collide
    np.testing.assert_allclose(kv.data.numpy()[:, :, :n],
                               np.asarray(jkv)[:, :, :n], atol=ATOL, rtol=0)


def test_empty_state_covers_the_cross_layers(whisper):
    cfg, _, _ = whisper
    st = M.empty_state(cfg, dtype=torch.bfloat16)
    T, kvd = cfg.media_tokens, cfg.num_kv_heads * cfg.head_dim
    assert st["enc_out"].shape == (1, T, cfg.d_model)
    for e in st["layers"]:
        assert set(e) == {"xk", "xv"}
        assert e["xk"].shape == (1, T, kvd) and e["xk"].dtype == torch.bfloat16
        assert not e["xk"].any() and not e["xv"].any()


# ---------------------------------------------------------------------------
# runner and server
# ---------------------------------------------------------------------------
def test_runner_stores_encoder_output_and_cross_kv(rng, whisper):
    """The encode stage leaves ``enc_out`` in the state store (a later clip
    of the same request after the first) and nothing in the image pool;
    prefill leaves each layer's cross K/V there, in the pool's type."""
    cfg, _, tparams = whisper
    caches = R.RunnerCaches(cfg, kv_blocks=16, img_blocks=2, device="cpu")
    runner = R.ModelRunner(cfg, tparams, caches, device="cpu")
    a, b = _clip(rng, cfg), _clip(rng, cfg)
    runner.encode([(0, a), (1, a), (1, b)])
    assert not caches.img.lengths
    enc0 = caches.states.get(0)["enc_out"]
    enc1 = caches.states.get(1)["enc_out"]
    assert enc0.shape == (1, cfg.media_tokens, cfg.d_model)
    assert enc1.shape == (1, 2 * cfg.media_tokens, cfg.d_model)
    np.testing.assert_array_equal(enc1[:, :cfg.media_tokens].numpy(),
                                  enc0.numpy())
    runner.prefill_chunk(0, rng.integers(0, cfg.vocab_size, 7))
    st = caches.states.get(0)
    kvd = cfg.num_kv_heads * cfg.head_dim
    for i in range(cfg.num_layers):
        assert st[f"xk{i}"].shape == (1, cfg.media_tokens, kvd)
        assert st[f"xv{i}"].dtype == caches.dtype
    assert st["ctx_len"] == 7


def test_batched_state_pads_missing_cross_kv(whisper):
    """A decode batch whose FIRST request lacks cross K/V keeps every other
    request's entries; lanes without them, and padded lanes, get zeros
    (the port's mirror of tests/test_prefill_paged.py's check)."""
    cfg, _, tparams = whisper
    runner = R.ModelRunner(cfg, tparams, R.RunnerCaches(
        cfg, kv_blocks=32, device="cpu"), device="cpu")
    kvd = cfg.num_kv_heads * cfg.head_dim
    xk = torch.ones((1, cfg.media_tokens, kvd))
    runner.caches.states.put(0, {})                       # no cross K/V
    runner.caches.states.put(1, {"xk0": xk, "xv0": xk})   # has cross K/V
    state = runner._batched_state([0, 1], 4)
    ent = state["layers"][0]
    assert ent["xk"].shape == (4, cfg.media_tokens, kvd)
    assert ent["xk"][1].max() == 1.0 and ent["xv"][1].min() == 1.0
    assert not ent["xk"][0].any() and not ent["xk"][2:].any()
    assert not state["layers"][1]["xk"].any()             # nobody has it


@pytest.mark.parametrize("disagg", [{"E": 1, "PD": 1},
                                    {"E": 1, "P": 1, "D": 1}],
                         ids=["E-PD", "E-P-D"])
def test_server_greedy_streams_match_jax(rng, whisper, monkeypatch, disagg):
    monkeypatch.setenv("REPRO_PAGED_IMPL", "ref")
    cfg, jparams, tparams = whisper
    reqs = [(rng.integers(0, cfg.vocab_size,
                          size=int(rng.integers(6, 14))).astype(np.int32),
             _clip(rng, cfg)) for _ in range(3)]
    jsrv = JServer(cfg, jparams, JDisagg(dict(disagg)))
    jrids = [jsrv.submit(p, media=m, max_new_tokens=5) for p, m in reqs]
    jout = jsrv.run()
    srv = HydraServer(cfg, tparams, DisaggConfig(dict(disagg)), device="cpu")
    rids = [srv.submit(p, media=m, max_new_tokens=5) for p, m in reqs]
    out = srv.run()
    for rid, jrid in zip(rids, jrids):
        assert out[rid].generated == jout[jrid].generated
        assert len(out[rid].generated) == 5
    assert srv.n_migrations == jsrv.n_migrations == \
        len(reqs) * (len(disagg) - 1)
    # P -> D carries enc_out and every layer's cross K/V (2 + 2 x 2 rows of
    # T x d f32 per request), E -> P the encoder output alone
    row = cfg.media_tokens * cfg.d_model * 4
    assert srv.migrated_bytes >= len(reqs) * row * (len(disagg) - 1)
    assert_all_reclaimed(srv)


def test_cross_state_transfer_fault_raises_and_rolls_back(rng, whisper):
    """A corrupted encoder-output / cross K/V payload raises TransferError;
    the destination holds nothing and the source keeps its copy."""
    cfg, _, tparams = whisper
    src = R.RunnerCaches(cfg, device="cpu")
    dst = R.RunnerCaches(cfg, device="cpu")
    runner = R.ModelRunner(cfg, tparams, src, device="cpu")
    runner.encode([(4, _clip(rng, cfg))])
    runner.prefill_chunk(4, rng.integers(0, cfg.vocab_size, 7))
    before = payload_checksum(src.states.read_blocks(4))
    with pytest.raises(TransferError) as e:
        R.migrate(4, src, dst, fault="corrupt")
    assert e.value.kind == "corrupt"
    assert dst.states.get(4) is None and 4 not in dst.kv.tables
    assert payload_checksum(src.states.read_blocks(4)) == before
    R.migrate(4, src, dst)
    assert src.states.get(4) is None
    assert payload_checksum(dst.states.read_blocks(4)) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_embedding_cache_hit_matches_cold_run(rng, whisper, dtype):
    """A repeated clip skips the encode stage: its encoder output comes
    from the embedding cache's host copy, goes back to the device in the
    pool's type, and the stream equals the cold run's (bf16 included)."""
    cfg, _, tparams = whisper
    if dtype == torch.bfloat16:
        tparams = M.init_params(cfg, torch.Generator().manual_seed(4),
                                dtype=dtype)
    prompt = rng.integers(0, cfg.vocab_size, 11).astype(np.int32)
    clip = _clip(rng, cfg)
    sp = SamplingParams(max_tokens=5)
    disagg = DisaggConfig({"E": 1, "P": 1, "D": 1})
    cold = Engine(cfg, tparams, disagg, device="cpu")
    ref = cold.generate(prompt, media=clip, sampling=sp).tokens()
    warm = Engine(cfg, tparams, disagg, device="cpu", prefix_cache=True)
    assert warm.generate(prompt, media=clip, sampling=sp).tokens() == ref
    hit = warm.generate(prompt, media=clip, sampling=sp)
    assert hit.tokens() == ref
    assert warm.result(hit.rid).req.encode_cached
    assert warm.cache_stats()["encode_hit_rate"] == 0.5
    (emb,) = warm.server.embed_cache.store.values()
    assert emb.dtype == np.float32 and emb.shape == (cfg.media_tokens,
                                                     cfg.d_model)
    assert_all_reclaimed(warm.server)
