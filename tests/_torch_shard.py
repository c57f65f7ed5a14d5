"""Shared set-up of the sharded serving tests: reduced models' weights, the
JAX package's unsharded results on them (computed in the test process),
and the port's sharded runs in ranks spawned by ``torch.multiprocessing``
over gloo on the CPU (``tests/_torch_shard_rank.py``, which imports no
JAX).

A group of ranks is one mesh shape; it runs every case of a list and
writes each rank's results to a file that the test process reads back.
Each data rank takes its rows of the batch, as the caller of a sharded
step gives them; the model ranks of a data rank must return the same
numbers.
"""
import dataclasses
import functools
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.multiprocessing as mp

from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

from _torch_shard_rank import B, N_STEPS, S, TIMEOUT_S, Case, rank_main
from conftest import reduced_cfg


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return tree.detach().numpy().copy()


@functools.lru_cache(maxsize=None)
def _jax_steps(cfg):
    fwd = jax.jit(lambda p, t, m: JM.forward(cfg, p, t, media=m)[::2])
    return (fwd, jax.jit(functools.partial(JM.prefill, cfg)),
            jax.jit(functools.partial(JM.decode_step, cfg)))


def make_case(name: str, arch: str, seed: int = 7, **overrides) -> Case:
    """Reduced ``arch`` (``conftest.reduced_cfg`` with ``overrides``), its
    weights and inputs from ``seed``, and the JAX package's unsharded
    forward, prefill and decode steps on them."""
    jcfg = reduced_cfg(arch, **overrides)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})
    tree = numpy_tree(M.init_params(cfg, torch.Generator().manual_seed(seed))
                      .tree())
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    media = None
    if cfg.frontend == "vision":
        media = (rng.standard_normal((B, cfg.media_tokens, cfg.d_model))
                 * 0.1).astype(np.float32)
    fwd, prefill, decode = _jax_steps(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jm = None if media is None else jnp.asarray(media)
    logits, aux = fwd(jp, jnp.asarray(tokens), jm)
    last, cache = prefill(jp, jnp.asarray(tokens), media=jm)
    n_in = S + (0 if media is None else cfg.media_tokens)
    cache = JM.build_cache_from_prefill(jcfg, cache, n_in + N_STEPS + 1)
    steps, fed = [np.asarray(last)], []
    for i in range(N_STEPS):
        tok = np.argmax(steps[-1], -1).astype(np.int32)[:, None]
        fed.append(tok)
        out, cache = decode(jp, cache, jnp.int32(n_in + i), jnp.asarray(tok))
        steps.append(np.asarray(out))
    want = {"logits": np.asarray(logits), "aux": float(aux),
            "steps": steps, "fed": fed}
    return Case(name, cfg, tree, tokens, media, want)


def run_group(mesh_shape: tuple, cases: list) -> list:
    """Every rank's results ({case name: run_case's dict, "coords": (data
    rank, model rank)}) of ``cases`` on a (data, model) = ``mesh_shape``
    group of CPU ranks over gloo."""
    world = mesh_shape[0] * mesh_shape[1]
    with tempfile.TemporaryDirectory() as tmp:
        # the cases go by file: every rank reads them at once (through the
        # spawn pipe each rank would wait for the one before it)
        torch.save(cases, Path(tmp) / "cases.pt")
        ctx = mp.start_processes(rank_main, args=(world, mesh_shape[1], tmp),
                                 nprocs=world, start_method="spawn",
                                 join=False)
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while not ctx.join(timeout=1):      # raises if a rank failed
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks of mesh {mesh_shape} still "
                                       f"running after {TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(5)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
