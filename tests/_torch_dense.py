"""Shared set-up of the dense serving path's parity tests: one reduced
model's weights for both packages, and the JAX package's dense steps
compiled once per model.

The weights are drawn by the port's ``init_params`` (in the JAX package's
tree and layout) and handed to both packages as the same numpy tree: to
the port through ``params_from_numpy``, to the JAX package as jnp arrays.
That skips the JAX package's eager init, which costs seconds a model on
the CPU.  The JAX steps run under ``jax.jit`` with the config static, so
a test pays one compile per step shape instead of the eager dispatch of
every op; the functions and their numbers are the package's own.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import model as JM
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy

from conftest import reduced_cfg


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.detach().numpy().copy()


@functools.lru_cache(maxsize=None)
def weights(arch: str, seed: int = 5):
    """(cfg, JAX param tree, the port's ParamTree on the CPU) of reduced
    ``arch`` (``conftest.reduced_cfg``: MoE capacity 16, no drops), the
    same numbers on both sides."""
    cfg = reduced_cfg(arch)
    tree = _numpy(M.init_params(cfg, torch.Generator().manual_seed(seed))
                  .tree())
    return cfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree,
                                                                   "cpu")


@functools.lru_cache(maxsize=None)
def jax_steps(cfg):
    """The JAX package's dense steps of ``cfg``, each under ``jax.jit``:
    {"prefill", "decode_step", "prefill_chunk"}."""
    return {name: jax.jit(functools.partial(getattr(JM, name), cfg))
            for name in ("prefill", "decode_step", "prefill_chunk")}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, rel=2e-4):
    """Within ``rel`` of the reference's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-9
    assert np.abs(got - want).max() / scale < rel
