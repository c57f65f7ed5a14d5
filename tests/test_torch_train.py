"""The port's training path (``repro_torch.models.model.forward`` and
``repro_torch.train``) against the JAX package's (``repro.models.model.
forward``, ``repro.train``) on the CPU, on the same weights (the JAX tree
converted through ``params_from_numpy``) and the same numpy batches.

Tolerances: logits within 2e-4 of the reference's largest logit (the
reference's own bar, tests/test_device_cache.py); each gradient leaf
within 1e-4 of that leaf's largest magnitude (f32, summed in another
order; the port's attention scales after the product, the reference's
before it); AdamW's params, m and v within 1e-6 on identical gradients
(its first step moves a weight by about lr * sign(g), so it is held on
the same gradients, and the whole step by its loss over a few steps, 1e-3
relative); data and checkpoints exact.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optim as jopt
from repro.train import train as jtrain
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_mm
from repro_torch.train.data import DataConfig, batches, to_device
from repro_torch.train.optim import (AdamWConfig, _global_norm, adamw_update,
                                     init_opt_state, lr_at)
from repro_torch.train.train import AUX_LOSS_WEIGHT, loss_fn, make_train_step

from conftest import reduced_cfg

REL = 2e-4
GRAD_REL = 1e-4
ARCHS = ["llama3-8b", "llava-1.5-7b", "gemma3-4b", "whisper-small",
         "falcon-mamba-7b", "zamba2-7b", "granite-moe-1b-a400m"]


def _setup(arch, seed=0, B=2, S=32):
    cfg = reduced_cfg(arch)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           trainable=True)
    b = next(jdata.batches(cfg, jdata.DataConfig(batch_size=B, seq_len=S,
                                                 seed=seed)))
    return cfg, jp, tp, b


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _setup(request.param)


def test_forward_matches_reference(model):
    """llama3 (dense GQA), LLaVA (a media prefix through the projector),
    gemma3 (sliding-window layers), whisper (frames through the audio
    encoder, cross-attention, sinusoidal positions), falcon-mamba (Mamba-1
    layers), zamba2 (Mamba-2 layers and the shared attention block) and
    granite-moe (the MoE FFN's capacity path and its aux loss, which is 0
    for the others)."""
    cfg, jp, tp, b = model
    want, _, jaux = JM.forward(cfg, jp, jnp.asarray(b["tokens"]),
                               media=b.get("media"), frames=b.get("frames"))
    tb = to_device(b, "cpu")
    with torch.no_grad():
        got, caches, aux = M.forward(cfg, tp, tb["tokens"],
                                     media=tb.get("media"),
                                     frames=tb.get("frames"))
    want = np.asarray(want)
    assert got.shape == want.shape and caches is None
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5)
    assert (float(aux) == 0.0) == (not cfg.num_experts)
    np.testing.assert_array_less(
        np.abs(got.numpy() - want).max(), REL * np.abs(want).max())


def test_loss_grads_match_reference_with_and_without_remat(model):
    """jax.grad of the reference's loss_fn (jax.checkpoint changes no
    number, so once) against the port's, remat off and on; the port's two
    are equal."""
    cfg, jp, tp, b = model
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtrain.loss_fn(cfg, p, jb, remat=False), has_aux=True)(jp)
    want = jckpt._flatten(jg)
    leaves = tp.leaves()
    tb = to_device(b, "cpu")
    runs = []
    for remat in (False, True):
        loss, stats = loss_fn(cfg, tp, tb, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        loss = loss.detach()
        runs.append((loss, grads))
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
        assert float(stats["ce"].detach()) + AUX_LOSS_WEIGHT * float(
            stats["aux"]) == pytest.approx(float(loss))
        assert set(leaves) == set(want)
        for k, g in zip(leaves, grads):
            scale = np.abs(want[k]).max()
            assert np.abs(g.numpy() - want[k]).max() <= GRAD_REL * scale, k
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, atol=1e-7, rtol=0)


def test_forward_collects_caches():
    cfg, jp, tp, b = _setup("llama3-8b", B=1, S=8)
    tb = to_device(b, "cpu")
    _, jc, _ = JM.forward(cfg, jp, jnp.asarray(b["tokens"]),
                          collect_cache=True)
    with torch.no_grad():
        _, tc, _ = M.forward(cfg, tp, tb["tokens"], collect_cache=True)
    assert len(tc) == cfg.num_layers
    for jent, tent in zip(jc, tc):
        assert set(jent) == set(tent) == {"k", "v"}
        for name in jent:
            np.testing.assert_allclose(tent[name].numpy(),
                                       np.asarray(jent[name]), atol=1e-5)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_forward_collects_mamba_caches(arch):
    """collect_cache: each Mamba layer's final state and conv prefix (and
    zamba2's shared-attention K/V) equal the reference's."""
    cfg, jp, tp, b = _setup(arch, B=2, S=12)
    tb = to_device(b, "cpu")
    _, jc, _ = JM.forward(cfg, jp, jnp.asarray(b["tokens"]),
                          collect_cache=True)
    with torch.no_grad():
        _, tc, _ = M.forward(cfg, tp, tb["tokens"], collect_cache=True)
    assert len(tc) == cfg.num_layers
    kinds = set()
    for jent, tent in zip(jc, tc):
        assert set(jent) == set(tent)
        kinds.add(tuple(sorted(tent)))
        for name in jent:
            want = np.asarray(jent[name])
            np.testing.assert_allclose(tent[name].numpy(), want,
                                       atol=1e-5 * max(np.abs(want).max(), 1))
    assert ("conv", "state") in kinds
    assert (("k", "v") in kinds) == (arch == "zamba2-7b")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 7, 100, 5000, 10_000, 20_000])
def test_lr_schedule_matches_reference(step):
    """At 0, during warmup, at its end, mid-decay, at and past
    total_steps."""
    opt = AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    want = float(jopt.lr_at(jopt.AdamWConfig(**dataclasses.asdict(opt)),
                            step))
    assert float(lr_at(opt, step)) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_adamw_matches_reference_on_identical_grads():
    """Two steps (the second with nonzero moments and bias corrections)
    on the same numpy gradients, with clipping active and weight decay on
    matrices only: params, m and v within 1e-6."""
    cfg = reduced_cfg("llava-1.5-7b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(5))
    flat = jckpt._flatten(jp)
    rng = np.random.default_rng(5)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                      grad_clip=0.5)
    jo = jopt.AdamWConfig(**dataclasses.asdict(opt))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           trainable=True)
    js, ts = jopt.init_opt_state(jp), init_opt_state(tp)
    for _ in range(2):
        g = {k: rng.standard_normal(a.shape).astype(np.float32)
             for k, a in flat.items()}
        jg = jax.tree.map(lambda a, path: g[path], jp,
                          _paths(jp))
        jp, js, jst = jopt.adamw_update(jo, jp, jg, js)
        tp, ts, tst = adamw_update(opt, tp, {k: torch.from_numpy(v)
                                             for k, v in g.items()}, ts)
        assert float(tst["grad_norm"]) == pytest.approx(
            float(jst["grad_norm"]), rel=1e-6)
        assert float(tst["lr"]) == pytest.approx(float(jst["lr"]), rel=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    jflat = jckpt._flatten({"params": jp, "m": js["m"], "v": js["v"]})
    got = {f"params/{k}": p for k, p in tp.leaves().items()}
    got.update({f"{n}/{k}": t for n in ("m", "v") for k, t in ts[n].items()})
    assert set(got) == set(jflat)
    for k, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[k], atol=1e-6,
                                   rtol=0, err_msg=k)


def _paths(tree, prefix=""):
    """The tree with each leaf replaced by its checkpoint path."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_paths(v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return prefix.rstrip("/")


def test_grad_clip_reports_raw_norm():
    from repro_torch.params import ParamTree
    opt = AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0, total_steps=10,
                      weight_decay=0.0)
    params = ParamTree({"w": torch.ones((4, 4))}, trainable=True)
    grads = {"w": torch.full((4, 4), 1e6)}
    assert float(_global_norm(grads)) == pytest.approx(4e6)
    _, _, stats = adamw_update(opt, params, grads, init_opt_state(params))
    assert float(stats["grad_norm"]) > 1e5


# ---------------------------------------------------------------------------
# data, checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3-8b", "llava-1.5-7b",
                                  "whisper-small", "pixtral-12b"])
def test_batches_equal_reference_bit_for_bit(arch):
    cfg = reduced_cfg(arch)
    dc = dict(batch_size=3, seq_len=48, seed=11)
    mine = batches(cfg, DataConfig(**dc))
    ref = jdata.batches(cfg, jdata.DataConfig(**dc))
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_checkpoint_roundtrips_between_packages(dtype):
    """port -> port, reference -> port and port -> reference, exact, with
    the optimizer state; bf16 leaves included."""
    cfg = reduced_cfg("llava-1.5-7b")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = JM.init_params(cfg, jax.random.PRNGKey(2), dtype=jdt)
    js = jopt.init_opt_state(jp)
    js = {**js, "step": jnp.asarray(3, jnp.int32),
          "m": jax.tree.map(lambda a: a.astype(jnp.float32) + 0.5, js["m"])}
    tp = params_from_numpy(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp), "cpu",
        dtype=dtype, trainable=True)
    ts = init_opt_state(tp)
    ts["step"] = torch.tensor(3, dtype=torch.int32)
    for t in ts["m"].values():
        t.add_(0.5)
    like = {"params": tp, "opt": ts}
    with tempfile.TemporaryDirectory() as d:
        mine, theirs = os.path.join(d, "t.npz"), os.path.join(d, "j.npz")
        ckpt.save(mine, like)
        jckpt.save(theirs, {"params": jp, "opt": js})
        back = ckpt.load(mine, like)
        from_ref = ckpt.load(theirs, like)
        to_ref = jckpt.load(mine, {"params": jp, "opt": js})
    assert back["params"].layers[0].wq.requires_grad
    want = ckpt._flatten(like)
    for tree in (back, from_ref):
        got = ckpt._flatten(tree)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, t in back["params"].leaves().items():
        assert t.dtype == tp.leaves()[k].dtype
    ref_flat = jckpt._flatten(to_ref)
    assert set(ref_flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(ref_flat[k]).astype(jnp.float32)),
            want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the training step and train_mm
# ---------------------------------------------------------------------------
def test_loss_decreases_and_follows_reference():
    """12 steps of the port's train_step on reduced llama3-8b: finite, the
    last loss below the first (as test_train.py holds the reference); the
    first three losses within 1e-3 of the reference's on the same weights
    and batches."""
    cfg = reduced_cfg("llama3-8b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           trainable=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    jstep = jax.jit(jtrain.make_train_step(
        cfg, jopt.AdamWConfig(**dataclasses.asdict(opt))))
    tstep = make_train_step(cfg, opt)
    js, ts = jopt.init_opt_state(jp), init_opt_state(tp)
    it = batches(cfg, DataConfig(batch_size=4, seq_len=64))
    losses, ref = [], []
    for i in range(12):
        b = next(it)
        tp, ts, stats = tstep(tp, ts, to_device(b, "cpu"))
        losses.append(float(stats["loss"]))
        if i < 3:
            jp, js, jst = jstep(jp, js, {k: jnp.asarray(v)
                                         for k, v in b.items()})
            ref.append(float(jst["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses[:3], ref, rtol=1e-3)


def test_train_mm_on_cpu(capsys):
    """train_mm's loop, printing and checkpoint at a reduced config (its
    mini config is ~47M parameters)."""
    cfg = reduced_cfg("llava-1.5-7b")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "c.npz")
        losses = train_mm.train(cfg, steps=3, ckpt_path=path, device="cpu")
        keys = set(np.load(path).files)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "params/layers/0/wq" in keys and "opt/m/embed" in keys \
        and "opt/step" in keys
    out = capsys.readouterr().out
    assert "step    0" in out and "step    2" in out and "checkpoint ->" in out
    mini = train_mm.mini_config("llava-1.5-7b")
    assert (mini.num_layers, mini.d_model, mini.vocab_size,
            mini.media_tokens) == (4, 512, 32000, 64)


def test_train_mm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mm.main(["--steps", "1"])
