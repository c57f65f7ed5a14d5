"""The port's dense chunked prefill against ``repro.models`` on the same
weights and the same seeded numpy inputs, on the CPU: ``prefill_chunk`` +
``extend_prior`` over three uneven chunks, after a media chunk on a
vision model (tests/test_engine.py::test_chunked_prefill_matches_forward),
against the JAX package's chunks and against the port's one full
``forward``; for media first, a sliding window, cross-attention, Mamba-2
with shared attention, and MLA (``mla_chunk``).  Set-up:
tests/_torch_dense.py.

Tolerances: logits within 2e-4 of the reference's largest logit, the
reference's bar for one step path against another
(tests/test_device_cache.py); the chunk's cache rows 1e-4 absolute; the
last chunk against the full forward 1e-3, the reference's bar for that
comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.models import model as M

from _torch_dense import close, jax_steps, t, weights

CHUNK_ARCHS = ["pixtral-12b", "gemma3-4b", "whisper-small", "zamba2-7b",
               "deepseek-v2-236b"]


def _rows(ent):
    """A layer's chunk entries in the port's layout (MLA: one ``lat``)."""
    if "ckv" in ent:
        return {"lat": np.concatenate([ent["ckv"], ent["krope"]], -1)}
    return ent


@pytest.mark.parametrize("arch", CHUNK_ARCHS)
def test_prefill_chunks_match_jax_and_forward(rng, arch):
    """Three uneven chunks (after the media chunk on vision models, with
    the encoder output on whisper) extend the prefix; every chunk's logits
    and cache entries match the JAX package's, and the last chunk's
    logits the port's full forward."""
    cfg, jparams, tparams = weights(arch)
    chunk = jax_steps(cfg)["prefill_chunk"]
    S = 30
    tokens = rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    media = None
    if cfg.frontend != "none":
        media = (rng.standard_normal((1, cfg.media_tokens, cfg.d_model))
                 * 0.1).astype(np.float32)
    kw = {"audio": "frames", "vision": "media"}.get(cfg.frontend)
    with torch.inference_mode():
        ref, _, _ = M.forward(cfg, tparams, t(tokens),
                              **({kw: t(media)} if kw else {}))
        jprior, tprior = JM.empty_prior(cfg, 1), M.empty_prior(cfg, 1)
        chunks = [(slice(0, 11), 0), (slice(11, 17), 11), (slice(17, S), 17)]
        jenc = tenc = jmedia = tmedia = None
        if kw == "frames":
            jenc = JM.encode_media(cfg, jparams, jnp.asarray(media))
            tenc = M.encode_media(cfg, tparams, t(media))
        if kw == "media":
            jmedia = JM.encode_media(cfg, jparams, jnp.asarray(media))
            tmedia = M.encode_media(cfg, tparams, t(media))
            chunks = [(None, 0)] + [(sl, off + cfg.media_tokens)
                                    for sl, off in chunks]
        for sl, off in chunks:
            jtok = None if sl is None else jnp.asarray(tokens[:, sl])
            ttok = None if sl is None else t(tokens[:, sl])
            jl, jents = chunk(jparams, jtok, jprior, off, enc_out=jenc,
                              media_emb=jmedia if sl is None else None)
            tl, tents = M.prefill_chunk(
                cfg, tparams, ttok, tprior, off, enc_out=tenc,
                media_emb=tmedia if sl is None else None)
            close(tl.numpy(), jl)
            for je, te in zip(jents["layers"], tents["layers"]):
                je = _rows(je)
                assert set(je) == set(te)
                for name, arr in je.items():
                    np.testing.assert_allclose(te[name].numpy(),
                                               np.asarray(arr), atol=1e-4)
            jprior = JM.extend_prior(cfg, jprior, jents)
            tprior = M.extend_prior(cfg, tprior, tents)
    close(tl.numpy(), ref[:, -1].numpy(), rel=1e-3)
