"""DeepSeek-V2's training path in the port (``repro_torch.models.mla.
mla_full`` under ``repro_torch.models.model.forward``) against the JAX
package's (``repro.models.mla.mla_full`` under ``repro.models.model.
forward``) on the CPU, on the same weights and numpy batches: reduced
DeepSeek-V2 has one MLA + dense MLP layer and one MLA + MoE layer, with
queries and keys 32 + 16 wide and values 32 (flash attention's plain
version at (Dqk, Dv) = (48, 32)).

Tolerances as tests/test_torch_train.py's: logits within 2e-4 of the
reference's largest logit, each gradient leaf within 1e-4 of that leaf's
largest magnitude (f32 summed in another order), the loss within 1e-5
relative, the caches within 1e-5 of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import train as jtrain
from repro_torch.configs.base import MLA_MLP, MLA_MOE
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.train.data import to_device
from repro_torch.train.train import loss_fn

from conftest import reduced_cfg

REL = 2e-4
GRAD_REL = 1e-4
ARCH = "deepseek-v2-236b"


def _setup(seed=0, B=2, S=24, **overrides):
    cfg = reduced_cfg(ARCH, **overrides)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           trainable=True)
    b = next(jdata.batches(cfg, jdata.DataConfig(batch_size=B, seq_len=S,
                                                 seed=seed)))
    return cfg, jp, tp, b


# capacity factor 16: no pair dropped; 1.0: the capacity path drops
@pytest.fixture(scope="module", params=[16.0, 1.0], ids=["cf16", "cf1"])
def model(request):
    return _setup(moe_capacity_factor=request.param)


def test_reduced_config_has_both_mla_kinds(model):
    cfg = model[0]
    assert cfg.layer_kinds() == [MLA_MLP, MLA_MOE]
    assert (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
            cfg.v_head_dim) == (48, 32)


def test_forward_matches_reference(model):
    """Logits and the MoE layer's aux loss."""
    cfg, jp, tp, b = model
    want, _, jaux = JM.forward(cfg, jp, jnp.asarray(b["tokens"]))
    with torch.no_grad():
        got, caches, aux = M.forward(cfg, tp, torch.from_numpy(b["tokens"]))
    want = np.asarray(want)
    assert got.shape == want.shape and caches is None
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5)
    assert float(aux) != 0.0
    np.testing.assert_array_less(
        np.abs(got.numpy() - want).max(), REL * np.abs(want).max())


@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_match_reference(model, remat):
    """jax.grad of the reference's loss_fn against the port's, every leaf
    of both MLA layers, the dense MLP, the experts and the router."""
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
    assert any("kv_b" in k and np.abs(want[k]).max() > 0 for k in want)


def test_forward_collects_latent_caches():
    """collect_cache: each MLA layer's post-norm latent and rotated shared
    key, {"ckv", "krope"}, equal the reference's."""
    cfg, jp, tp, b = _setup(B=1, S=10)
    _, jc, _ = JM.forward(cfg, jp, jnp.asarray(b["tokens"]),
                          collect_cache=True)
    with torch.no_grad():
        _, tc, _ = M.forward(cfg, tp, torch.from_numpy(b["tokens"]),
                             collect_cache=True)
    assert len(tc) == len(jc) == cfg.num_layers
    for jent, tent in zip(jc, tc):
        assert set(jent) == set(tent) == {"ckv", "krope"}
        for name in jent:
            want = np.asarray(jent[name])
            assert tent[name].shape == want.shape
            np.testing.assert_allclose(tent[name].numpy(), want,
                                       atol=1e-5 * max(np.abs(want).max(), 1))
