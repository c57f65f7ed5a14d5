"""The port's sharded serving steps against the JAX package's unsharded
ones: reduced llama3-8b (also with one KV head, which a rank's two query
heads share, so each model rank holds that whole head), LLaVA-1.5-7B with
its media, granite-moe-1b-a400m (lossless, and a capacity factor that
drops pairs) and falcon-mamba-7b, run by ranks over gloo on the CPU at
(data, model) meshes (1, 2), (2, 1) and (2, 2); one group of ranks a mesh
shape runs every case (set-up: tests/_torch_shard.py).

Bars: ``forward``'s logits within 2e-5 absolute, the bar of the JAX
package's own sharded test (tests/test_sharding_small.py); its aux loss
within 1e-6; ``prefill`` and 4 teacher-forced ``decode_step``s within
2e-4 of the reference's largest logit, the bar of one step path against
another (tests/test_device_cache.py).  Every model rank of a data rank
returns its rows, and each rank holds a cut of the weights (fewer bytes
than the whole tree when model > 1).
"""
import functools

import numpy as np
import pytest

from _torch_dense import close
from _torch_shard import make_case, run_group

MESHES = [(1, 2), (2, 1), (2, 2)]
CASES = [("llama3-8b", "llama3-8b", {}),
         ("llama3-8b kv1", "llama3-8b", {"num_kv_heads": 1}),
         ("llava-1.5-7b", "llava-1.5-7b", {}),
         ("granite-moe-1b-a400m", "granite-moe-1b-a400m", {}),
         ("granite-moe drops", "granite-moe-1b-a400m",
          {"moe_capacity_factor": 0.5}),
         ("falcon-mamba-7b", "falcon-mamba-7b", {})]
NAMES = [c[0] for c in CASES]


@functools.lru_cache(maxsize=None)
def cases():
    return [make_case(name, arch, **kw) for name, arch, kw in CASES]


@functools.lru_cache(maxsize=None)
def group(mesh):
    return run_group(mesh, cases())


def _case(name):
    return next(c for c in cases() if c.name == name)


def _full_bytes(case):
    return sum(a.nbytes for a in _leaves(case.tree))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_forward_matches_reference(mesh, name):
    case = _case(name)
    for res in group(mesh):
        got = res[name]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["logits"], case.want["logits"][lo:hi],
                                   atol=2e-5, rtol=0)
        if case.cfg.num_experts:
            # the batch's aux loss on every rank (its means over all rows)
            assert abs(got["aux"] - case.want["aux"]) <= 1e-6


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_prefill_and_decode_match_reference(mesh, name):
    case = _case(name)
    for res in group(mesh):
        got = res[name]
        lo, hi = got["rows"]
        assert len(got["steps"]) == len(case.want["steps"])
        for g, w in zip(got["steps"], case.want["steps"]):
            close(g, w[lo:hi])


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_ranks_hold_their_cut_and_their_rows(mesh):
    """Each data rank's model ranks take its rows, each rank one (data,
    model) coordinate; with model > 1 a rank holds fewer weight bytes than
    the whole tree (every cut model at least 40% smaller), and its KV
    caches and Mamba states are its heads' and channels' widths."""
    ranks = group(mesh)
    assert sorted(r["coords"] for r in ranks) == \
        [(d, m) for d in range(mesh[0]) for m in range(mesh[1])]
    for r in ranks:
        d = r["coords"][0]
        for case in cases():
            got = r[case.name]
            assert got["rows"] == (d * 4 // mesh[0], (d + 1) * 4 // mesh[0])
            share = got["bytes"] / _full_bytes(case)
            assert share == 1.0 if mesh[1] == 1 else share < 0.6
            for kind, ent in zip(case.cfg.layer_kinds(),
                                 got["cache_widths"]):
                if "k" in ent:
                    kv = case.cfg.num_kv_heads * case.cfg.head_dim
                    want = kv if mesh[1] == 1 or case.cfg.num_kv_heads == 1 \
                        else kv // mesh[1]
                    assert ent["k"][-1] == ent["v"][-1] == want
                else:
                    assert ent["state"][1] == case.cfg.d_inner // mesh[1]


def test_capacity_case_drops_pairs():
    """The capacity case's factor really drops (token, expert) pairs of
    the reference's batch, so the sharded runs hold the drops, including
    their order across the data ranks."""
    from repro_torch.models import moe
    case = _case("granite-moe drops")
    cfg = case.cfg
    assert moe.capacity(cfg, 4 * 8) * cfg.num_experts < \
        4 * 8 * cfg.experts_per_token
