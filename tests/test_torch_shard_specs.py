"""The port's sharding specs against the JAX package's, leaf by leaf, for
every config of ``configs/`` at its published size (shapes only: the
port's trees on the meta device, the JAX package's from ``eval_shape``):
``model.param_specs``, ``sharding.param_pspecs``, ``model.cache_pspecs``
in both layouts, and ``sharding.param_shardings`` plain, with ``fsdp``
and with ``expert_2d`` on the (1, 1), (16, 16) and (2, 16, 16) meshes
(the JAX package's over an ``AbstractMesh``: no devices needed)."""
import functools

import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import sharding as JSH
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.models import model as M
from repro_torch.models import sharding as SH

MESHES = {"1x1": {"data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MODES = {"plain": {}, "fsdp": {"fsdp": True}, "expert_2d": {"expert_2d": True}}


@functools.lru_cache(maxsize=None)
def specs(arch):
    """(the JAX package's param specs, the port's) of ``arch``."""
    return (JM.param_specs(jax_config(arch)),
            M.param_specs(get_config(arch)).tree())


def leaves(tree, path=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in leaves(sub, f"{path}/{name}").items()}
    if isinstance(tree, (list, tuple)) and \
            not isinstance(tree, (SH.P, PartitionSpec)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in leaves(sub, f"{path}/{i}").items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch):
    """The tree's paths, shapes and types on the meta device (bf16
    weights, f32 norms, router and Mamba scalars) are the JAX package's."""
    want, got = (leaves(t) for t in specs(arch))
    assert set(got) == set(want)
    for path, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[path].shape), path
        assert str(t.dtype).split(".")[1] == str(want[path].dtype), path


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_pspecs_match_reference(arch):
    jtree, ttree = specs(arch)
    want = leaves(JSH.param_pspecs(jtree))
    got = leaves(SH.param_pspecs(ttree))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert isinstance(spec, SH.P)
        assert tuple(spec) == tuple(want[path]), path


@pytest.mark.parametrize("layout", ["kvdim", "seq"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_pspecs_match_reference(arch, layout):
    """An MLA layer's ``lat`` takes the spec of the JAX package's ``ckv``
    and ``krope`` (the same for both)."""
    want = JM.cache_pspecs(jax_config(arch), layout)["layers"]
    got = M.cache_pspecs(get_config(arch), layout)["layers"]
    assert len(got) == len(want)
    for t, j in zip(got, want):
        if "lat" in t:
            assert set(j) == {"ckv", "krope"} and j["ckv"] == j["krope"]
            j = {"lat": j["ckv"]}
        assert t == j


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_shardings_match_reference(arch, mesh, mode):
    shape = MESHES[mesh]
    jtree, ttree = specs(arch)
    want = leaves(JSH.param_shardings(
        AbstractMesh(tuple(shape.values()), tuple(shape)), jtree,
        **MODES[mode]))
    got = leaves(SH.param_shardings(shape, ttree, **MODES[mode]))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert tuple(spec) == tuple(want[path].spec), path


def test_cache_specs_are_init_caches_shapes_on_meta():
    cfg = get_config("llava-1.5-7b")
    got = M.cache_specs(cfg, 2, 64)["layers"]
    want = M.init_cache(cfg.reduced(), 2, 64)["layers"]
    assert len(got) == cfg.num_layers
    ent = got[0]
    assert {n: (tuple(t.shape), t.dtype, t.device.type)
            for n, t in ent.items()} == \
        {n: ((2, 64, cfg.num_kv_heads * cfg.head_dim), torch.bfloat16,
             "meta") for n in want[0]}
