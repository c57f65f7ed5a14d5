"""Each rank's cut of the weights (``sharding.shard_params`` /
``cut_params``): the ranks' cuts reassemble to the full tree; attention is
cut by whole heads, a KV head that does not split over ``model`` held
whole by every rank that reads it; Mamba-1's packed ``in_proj`` cut by
channels in each of its x and z halves.  Then what a mesh refuses, on a
one-rank gloo group in the test process: families this slice does not
shard, the chunked and paged steps, anything that requires grad; and the
meshes' constructors.  (The sharded runs themselves:
tests/test_torch_shard_run.py.)"""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M
from repro_torch.models import sharding as SH

ROOT = Path(__file__).resolve().parent.parent


def reduced(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _params(cfg):
    return M.init_params(cfg, torch.Generator().manual_seed(3))


CUTS = [("llama3-8b", {}, 2), ("llama3-8b", {}, 4),
        ("llama3-8b", {"num_kv_heads": 1}, 2),
        ("llama3-8b", {"num_kv_heads": 2}, 4),
        ("llava-1.5-7b", {}, 2), ("granite-moe-1b-a400m", {}, 4),
        ("falcon-mamba-7b", {}, 2), ("falcon-mamba-7b", {}, 3)]


@pytest.mark.parametrize("arch,kw,size", CUTS,
                         ids=[f"{a}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              f"-m{m}" for a, kw, m in CUTS])
def test_cuts_reassemble_the_full_tree(arch, kw, size):
    """Every index of every leaf is held by some rank, and every rank that
    holds one holds the full tree's value there (several do for a shared
    KV head); a leaf no rule cuts is whole on every rank."""
    cfg = reduced(arch, **kw)
    full = _params(cfg)
    cuts = [SH.cut_params(full, cfg, r, size).tree() for r in range(size)]
    ftree = full.tree()

    def check(name, kind, whole, parts):
        ix = [SH.cut_index(cfg, kind, name, r, size)
              for r in range(size)]
        if ix[0] is None:
            for p in parts:
                assert torch.equal(p, whole), name
            return
        dim = ix[0][0]
        seen = torch.zeros(whole.shape[dim], dtype=torch.bool)
        for (d, idx), p in zip(ix, parts):
            assert d == dim
            torch.testing.assert_close(p, whole.index_select(dim, idx),
                                       rtol=0, atol=0)
            seen[idx] = True
        assert seen.all(), f"{name}: indices no rank holds"

    for name, whole in ftree.items():
        if name != "layers":
            check(name, None, whole, [c[name] for c in cuts])
    for i, kind in enumerate(cfg.layer_kinds()):
        for name, whole in ftree["layers"][i].items():
            check(name, kind, whole, [c["layers"][i][name] for c in cuts])


def test_a_kv_head_no_rank_can_split_is_held_whole():
    """llama3-8b at model = 16: 1,024 KV columns / 16 is half a head; each
    rank's two query heads read one whole KV head (ranks 2j and 2j + 1
    the same), so its wk / wv columns are that head's 128."""
    cfg = get_config("llama3-8b")
    for r in range(16):
        q, kv = SH.head_cut(cfg, r, 16)
        assert list(q) == [2 * r, 2 * r + 1] and list(kv) == [r // 2]
        _, cols = SH.cut_index(cfg, "attn_mlp", "wk", r, 16)
        assert cols.tolist() == list(range(128 * (r // 2),
                                           128 * (r // 2 + 1)))
        contiguous = list(range(64 * r, 64 * (r + 1)))
        assert cols.tolist() != contiguous


def test_mamba_in_proj_is_cut_in_each_half():
    """falcon-mamba's in_proj [d, x | z]: rank r holds its channels' x
    columns and the same channels' z columns, where a contiguous cut would
    give rank 0 all of x."""
    cfg = reduced("falcon-mamba-7b")
    di = cfg.d_inner
    full = _params(cfg)
    for r in range(2):
        p = SH.cut_params(full, cfg, r, 2).layers[0]
        ch = slice(r * di // 2, (r + 1) * di // 2)
        w = full.layers[0].in_proj
        assert torch.equal(p.in_proj[:, :di // 2], w[:, :di][:, ch])
        assert torch.equal(p.in_proj[:, di // 2:], w[:, di:][:, ch])
        assert not torch.equal(p.in_proj, w[:, r * di:(r + 1) * di])
        assert p.A_log.shape == (di // 2, cfg.ssm_state)


def test_uneven_spans_and_heads_that_do_not_split():
    """The vocabulary (granite-moe's 49,155) cut in spans of ceil(n / M);
    query heads must split evenly, and each rank's must read its KV heads
    in grouped order."""
    assert [SH.span(49155, 2, r) for r in range(2)] == [(0, 24578),
                                                        (24578, 49155)]
    with pytest.raises(NotImplementedError, match="query heads"):
        SH.head_cut(reduced("llama3-8b"), 0, 8)
    with pytest.raises(NotImplementedError, match="grouped-query order"):
        SH.head_cut(reduced("llama3-8b", num_heads=6, num_kv_heads=3), 1, 2)


def test_rank_module_of_the_sharded_tests_imports_no_jax():
    """The spawned ranks run the port alone: tests/_torch_shard_rank.py
    imports neither JAX nor the JAX package."""
    path = ROOT / "tests" / "_torch_shard_rank.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}


def test_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is up in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        LM.make_host_mesh(device="cpu")


# ---------------------------------------------------------------------------
# a one-rank mesh in the test process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield LM.make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


UNSHARDED = ["zamba2-7b", "deepseek-v2-236b", "whisper-small", "gemma3-4b"]


@pytest.mark.parametrize("arch", UNSHARDED)
def test_unported_families_raise_by_name_under_a_mesh(mesh, arch):
    cfg = reduced(arch)
    params = _params(cfg)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with SH.use_mesh(mesh):
        for call in (lambda: SH.shard_params(params, cfg),
                     lambda: M.forward(cfg, params, tokens),
                     lambda: M.init_cache(cfg, 1, 8)):
            with pytest.raises(NotImplementedError,
                               match=f"{cfg.name}: .*not ported under a mesh"):
                call()


def test_chunked_and_paged_steps_raise_under_a_mesh(mesh):
    cfg = reduced("llama3-8b")
    params = _params(cfg)
    with SH.use_mesh(mesh):
        for name, call in (
                ("prefill_chunk", lambda: M.prefill_chunk(
                    cfg, params, torch.zeros((1, 2), dtype=torch.int32),
                    M.empty_prior(cfg, 1), 0)),
                ("decode_step_paged", lambda: M.decode_step_paged(
                    cfg, params, {}, {}, {}, None, None)),
                ("prefill_chunk_paged", lambda: M.prefill_chunk_paged(
                    cfg, params, {}, {}, {}, None, None))):
            with pytest.raises(NotImplementedError, match=name):
                call()


def test_grad_under_a_mesh_raises_by_name(mesh):
    """Trainable weights (or an input that requires grad) under a mesh
    raise before any step runs, and a collective refuses such a tensor;
    the same weights under no_grad run."""
    cfg = reduced("llama3-8b")
    params = M.init_params(cfg, torch.Generator().manual_seed(3),
                           trainable=True)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with SH.use_mesh(mesh):
        with pytest.raises(NotImplementedError, match="requires grad"):
            M.forward(cfg, params, tokens)
        with pytest.raises(NotImplementedError, match="requires grad"):
            M.decode_step(cfg, params, M.init_cache(cfg, 1, 8), 0,
                          tokens[:, :1])
        with pytest.raises(NotImplementedError, match="requires grad"):
            SH._all_reduce(torch.ones(3, requires_grad=True), "model")
        with torch.no_grad():
            M.forward(cfg, params, tokens)


def test_one_rank_mesh_changes_no_number(mesh):
    """On a (1, 1) mesh the cut is the whole tree and forward, prefill and
    a decode step give the unsharded bits."""
    cfg = reduced("granite-moe-1b-a400m")
    params = _params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = M.forward(cfg, params, tokens)[0]
        wl, wc = M.prefill(cfg, params, tokens)
        wd = M.decode_step(cfg, params, M.build_cache_from_prefill(
            cfg, wc, 8), 6, tokens[:, :1])[0]
        with SH.use_mesh(mesh):
            assert SH.axis_size("model") == SH.dp_size() == 1
            local = SH.shard_params(params, cfg)
            got = M.forward(cfg, local, tokens)[0]
            gl, gc = M.prefill(cfg, local, tokens)
            gd = M.decode_step(cfg, local, M.build_cache_from_prefill(
                cfg, gc, 8), 6, tokens[:, :1])[0]
    for g, w in ((got, want), (gl, wl), (gd, wd)):
        assert torch.equal(g, w)


def test_mesh_constructors(mesh):
    """The host mesh is (world // model, model) over ("data", "model");
    the production meshes need 256 or 512 ranks; the card is the
    default device."""
    assert SH.mesh_shape(mesh) == {"data": 1, "model": 1}
    assert SH.mesh_shape(LM.make_host_mesh(model=4, device="cpu")) == \
        {"data": 1, "model": 1}
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="ranks, the world has 1"):
            LM.make_production_mesh(multi_pod=multi_pod, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LM.make_host_mesh()
