"""Training at every attention width of the repo's configs, on the CPU.

Flash attention's plain versions at the (Dqk, Dv) pairs added for
training: zamba2-7b's D = 112, stablelm-12b's 160, gemma's 256 and
DeepSeek-V2's MLA, queries and keys 192 wide and values 128.  Forward,
log-sum-exp and backward (``flash_attention_fwd_ref`` /
``flash_attention_bwd_ref``) against autograd through
``flash_attention_ref`` and against the JAX package's
``blockwise_attention`` (which its training forward differentiates) and
``jax.grad`` through it, at causal, window, GQA and kv_offset cases; then
the port's ``forward`` and loss gradients on reduced zamba2-7b,
stablelm-12b and gemma3-4b at their full models' head dims against
``repro.models.model.forward``.

Tolerances: 1e-5 absolute for the attention (f32, the same arithmetic in
another order; ``blockwise_attention`` scales q before the product, the
port after it); the models as tests/test_torch_train.py's (logits 2e-4 of
the largest, gradient leaves 1e-4 of each leaf's largest magnitude).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import model as JM
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import train as jtrain
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_fwd_ref, flash_attention_ref)
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.train.data import to_device
from repro_torch.train.train import loss_fn

from conftest import reduced_cfg

ATOL = 1e-5
REL = 2e-4
GRAD_REL = 1e-4
WIDTHS = [(112, 112), (160, 160), (256, 256), (192, 128)]

# (tag, G, Sq, Sk, causal, window, kv_offset): every row sees a key
MASKS = [("causal-g1", 1, 24, 24, True, 0, 0),
         ("causal-g4", 4, 19, 19, True, 0, 0),
         ("full-g2", 2, 9, 21, False, 0, 0),
         ("window-g1", 1, 30, 30, True, 7, 0),
         ("window-g4", 4, 20, 20, True, 5, 0),
         ("offset-g4", 4, 11, 27, True, 0, 16),
         ("window-offset-g1", 1, 13, 30, True, 9, 17)]
CASES = [(w, m) for w in WIDTHS for m in MASKS]


def _inputs(seed, B, H, Kh, Sq, Sk, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Kh, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Kh, Sk, Dv)).astype(np.float32),
            rng.standard_normal((B, H, Sq, Dv)).astype(np.float32))


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_()


def _bshd(a):
    """[B, H, S, D] numpy -> the model's [B, S, H, D] as a jax array."""
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("widths,mask", CASES,
                         ids=[f"{w[0]}x{w[1]}-{m[0]}" for w, m in CASES])
def test_flash_refs_match_autograd_and_jax(widths, mask):
    D, Dv = widths
    _, G, Sq, Sk, causal, window, off = mask
    Kh = 2
    q, k, v, do = _inputs(D + Dv, 2, Kh * G, Kh, Sq, Sk, D, Dv)
    kw = dict(causal=causal, window=window, kv_offset=off)
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    ref_out = flash_attention_ref(tq, tk, tv, **kw)
    ref_out.backward(torch.from_numpy(do))
    out, lse = flash_attention_fwd_ref(*map(torch.from_numpy, (q, k, v)),
                                       **kw)
    assert out.shape == (2, Kh * G, Sq, Dv)
    got = flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v)), out,
                                  lse, torch.from_numpy(do), **kw)
    # the JAX package's attention, [B, S, H, D], and its gradient
    w = _bshd(do)
    jout, vjp = jax.vjp(
        lambda a, b, c: JL.blockwise_attention(a, b, c, q_chunk=8, **kw),
        _bshd(q), _bshd(k), _bshd(v))
    jgrads = vjp(w)
    jout = np.asarray(jout).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ref_out.detach().numpy(), jout, atol=ATOL,
                               rtol=0)
    # lse: the log-sum-exp of the scaled, masked scores, scaled by Dqk
    qpos = off + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    vis = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        vis &= kpos <= qpos
    if window:
        vis &= kpos > qpos - window
    s = torch.einsum("bkgqd,bksd->bkgqs",
                     torch.from_numpy(q).reshape(2, Kh, G, Sq, D),
                     torch.from_numpy(k)) / math.sqrt(D)
    want_lse = torch.logsumexp(s.masked_fill(~vis, float("-inf")), -1)
    torch.testing.assert_close(lse, want_lse.reshape(2, Kh * G, Sq),
                               atol=ATOL, rtol=0)
    for g, auto, jx in zip(got, (tq.grad, tk.grad, tv.grad), jgrads):
        assert g.shape == auto.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), auto.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(
            g.numpy(), np.asarray(jx).transpose(0, 2, 1, 3), atol=ATOL,
            rtol=0)


@pytest.mark.parametrize("widths", WIDTHS, ids=[f"{a}x{b}" for a, b in WIDTHS])
def test_wrapper_gradients_on_cpu_at_width(widths):
    """flash_attention with grad on (FlashAttentionFn, the plain backward
    on CPU tensors) at each width, V narrower than Q and K at MLA's."""
    D, Dv = widths
    q, k, v, do = _inputs(7, 1, 4, 2, 17, 17, D, Dv)
    a = [_leaf(x) for x in (q, k, v)]
    out = tfa.flash_attention(*a, causal=True, window=5)
    assert out.shape == (1, 4, 17, Dv)
    out.backward(torch.from_numpy(do))
    b = [_leaf(x) for x in (q, k, v)]
    flash_attention_ref(*b, causal=True, window=5).backward(
        torch.from_numpy(do))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=ATOL,
                                   rtol=0)


# reduced models at their full configs' head dims (gemma3-4b keeps its
# reduced window of 16 on the local layers)
MODELS = [("zamba2-7b", 112), ("stablelm-12b", 160), ("gemma3-4b", 256)]


def _setup(arch, head_dim, seed=0, B=2, S=24):
    assert get_config(arch).head_dim == head_dim
    cfg = reduced_cfg(arch, head_dim=head_dim)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           trainable=True)
    b = next(jdata.batches(cfg, jdata.DataConfig(batch_size=B, seq_len=S,
                                                 seed=seed)))
    return cfg, jp, tp, b


@pytest.fixture(scope="module", params=MODELS,
                ids=[f"{a}-d{d}" for a, d in MODELS])
def model(request):
    return _setup(*request.param)


def test_forward_matches_reference_at_width(model):
    cfg, jp, tp, b = model
    want, _, _ = JM.forward(cfg, jp, jnp.asarray(b["tokens"]))
    with torch.no_grad():
        got, _, aux = M.forward(cfg, tp, torch.from_numpy(b["tokens"]))
    want = np.asarray(want)
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_array_less(
        np.abs(got.numpy() - want).max(), REL * np.abs(want).max())


@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_match_reference_at_width(model, remat):
    cfg, jp, tp, b = model
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtrain.loss_fn(cfg, p, jb, remat=False), has_aux=True)(jp)
    want = jckpt._flatten(jg)
    leaves = tp.leaves()
    assert set(leaves) == set(want)
    loss, _ = loss_fn(cfg, tp, to_device(b, "cpu"), remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    for k, g in zip(leaves, grads):
        scale = np.abs(want[k]).max()
        assert np.abs(g.numpy() - want[k]).max() <= GRAD_REL * scale, k
