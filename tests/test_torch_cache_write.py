"""The port's cache write from separate K/V source planes on CPU (its plain
PyTorch version) against ``repro``'s ``paged_chunk_write`` on the stacked
rows, run both as a Pallas kernel in interpret mode and through its jnp
oracle; the wrapper's source addressing (the pointers and strides the CUDA
kernel reads the planes through); and the model's paged chunk and decode
steps, which now hand K and V to the write unstacked, against ``repro``
with padded lanes.

Tolerances: the write copies exactly (1e-6 absolute); logits within 2e-4 of
the reference's largest logit, pools within 1e-5, as in
tests/test_torch_model.py.  The scratch block is left out of every
comparison: padded positions write there in no defined order, and the CUDA
kernel skips those rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cache_write import ops as jcw
from repro.models import model as JM
from repro_torch import kernels as K
from repro_torch.engine.paged_cache import DevicePagedCache, PagedCacheSpec
from repro_torch.engine.runner import bucket_pow2
from repro_torch.kernels.cache_write import ops as tcw
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy

from conftest import reduced_cfg

T, L, NB, BS, W = 2, 3, 8, 4, 16
SCRATCH = NB                       # the pool's last block


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _planes(rows, form):
    """T source planes [B, C, W] holding ``rows`` [T, B, C, W], laid out
    as the form says: one stacked tensor, separate tensors (K and V as the
    projections leave them), or column slices of one wider buffer (a row
    stride that is not W)."""
    if form == "stacked":
        return _t(rows)
    if form == "planes":
        return tuple(_t(r) for r in rows)
    wide = torch.zeros(rows.shape[1:-1] + (T * W + 3,))
    for t in range(T):
        wide[..., t * W:(t + 1) * W] = _t(rows[t])
    return tuple(wide[..., t * W:(t + 1) * W] for t in range(T))


@pytest.mark.parametrize("use_kernel", [True, False], ids=["interpret", "ref"])
@pytest.mark.parametrize("form", ["stacked", "planes", "strided"])
@pytest.mark.parametrize("C", [1, 5], ids=["token", "chunk"])
def test_write_from_planes_matches_jax(rng, C, form, use_kernel):
    B, layer = 3, 1
    data = rng.standard_normal((T, L, NB + 1, BS, W)).astype(np.float32)
    rows = rng.standard_normal((T, B, C, W)).astype(np.float32)
    slots = np.full((B, C), SCRATCH * BS, np.int32)    # lane 2: padded
    slots[:2] = rng.permutation(NB * BS)[:2 * C].reshape(2, C)
    slots[1, C - 1:] = SCRATCH * BS                    # a padded position
    if C == 1:
        want = jcw.paged_token_write(jnp.asarray(data), layer,
                                     jnp.asarray(rows[:, :, 0]),
                                     jnp.asarray(slots[:, 0]),
                                     interpret=True, use_kernel=use_kernel)
    else:
        want = jcw.paged_chunk_write(jnp.asarray(data), layer,
                                     jnp.asarray(rows), jnp.asarray(slots),
                                     interpret=True, use_kernel=use_kernel)
    got = _t(data)
    src = _planes(rows, form)
    if C == 1:
        src = src[:, :, 0] if form == "stacked" else \
            tuple(p[:, 0] for p in src)
        out = tcw.paged_token_write(got, layer, src, _t(slots[:, 0]),
                                    scratch=SCRATCH * BS)
    else:
        out = tcw.paged_chunk_write(got, layer, src, _t(slots),
                                    scratch=SCRATCH * BS)
    assert out.data_ptr() == got.data_ptr()              # in place
    np.testing.assert_allclose(got.numpy()[:, :, :NB],
                               np.asarray(want)[:, :, :NB], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("scratch", [None, SCRATCH * BS],
                         ids=["no-scratch", "scratch"])
def test_plain_version_writes_every_row(rng, scratch):
    """The CPU path is the plain version: it writes the rows aimed at the
    scratch block too (the kernel's skipping them is a deliberate
    difference that no reader can see), so it stays exact against the
    reference's write on the stacked rows, scratch block included when
    only one row lands there."""
    data = rng.standard_normal((T, L, NB + 1, BS, W)).astype(np.float32)
    k, v = (rng.standard_normal((2, 1, W)).astype(np.float32)
            for _ in range(T))
    slots = np.asarray([[5], [SCRATCH * BS + 2]], np.int32)
    want = jcw.paged_chunk_write(jnp.asarray(data), 2,
                                 jnp.asarray(np.stack([k, v])),
                                 jnp.asarray(slots), use_kernel=False)
    got = _t(data)
    tcw.paged_chunk_write(got, 2, (_t(k), _t(v)), _t(slots), scratch=scratch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["stacked", "planes", "strided"])
def test_source_addressing(rng, form):
    """``_source`` gives the kernel one base, a plane stride and a row
    stride (elements) that reach every row of every plane where it lies:
    K and V are not copied."""
    rows = rng.standard_normal((T, 3, 5, W)).astype(np.float32)
    planes = [p.reshape(15, W) for p in _planes(rows, form)]
    first, plane_stride, row_stride = tcw._source(planes)
    assert first.data_ptr() == planes[0].data_ptr()
    esz = first.element_size()
    for t, p in enumerate(planes):
        for r in (0, 7, 14):
            assert p[r].data_ptr() == first.data_ptr() + \
                (t * plane_stride + r * row_stride) * esz
    assert row_stride == (W if form != "strided" else T * W + 3)


def test_source_addressing_stacks_planes_it_cannot_step_through(rng):
    """Planes that one base, one plane stride and one row stride cannot
    reach (three bases out of step; two planes with different row strides)
    are refused with the layout the kernel needs, never copied."""
    a, b, c = (torch.from_numpy(rng.standard_normal((4, W))
                                .astype(np.float32)) for _ in range(3))
    with pytest.raises(ValueError, match="where they lie"):
        tcw._source([a[:3], c[1:], b[:3]])      # bases out of step
    wide = torch.zeros((3, 2 * W))
    with pytest.raises(ValueError, match="one row stride"):
        tcw._source([a[:3], wide[:, :W]])


def test_cpu_write_counts_no_launch(rng):
    K.reset_launches()
    data = torch.zeros((T, L, NB + 1, BS, W))
    k = torch.ones((2, W))
    tcw.paged_token_write(data, 0, (k, -k), torch.tensor([1, 6],
                                                         dtype=torch.int32),
                          scratch=SCRATCH * BS)
    assert K.launches["cache_write"] == 0
    assert (data[0, 0].view(-1, W)[[1, 6]] == 1).all()
    assert (data[1, 0].view(-1, W)[[1, 6]] == -1).all()


def test_write_rejects_a_plane_count_other_than_the_pools(rng):
    data = torch.zeros((T, L, NB + 1, BS, W))
    with pytest.raises(ValueError, match="source planes"):
        tcw.paged_chunk_write(data, 0, (torch.zeros((1, 2, W)),),
                              torch.zeros((1, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the model's paged steps, K and V unstacked, with padded lanes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def llava():
    cfg = reduced_cfg("llava-1.5-7b")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


def _with_scratch(ctl, kv):
    """The port's ``ctl`` as the runner builds it: the scratch block's
    first slot beside the tables and slots."""
    tctl = jax.tree.map(_t, ctl)
    tctl["kv"]["scratch"] = kv.scratch_block * kv.spec.block_size
    return tctl


def _close(got, want, rows):
    got, want = np.asarray(got)[rows], np.asarray(want)[rows]
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 2e-4


@pytest.mark.parametrize("n_decode", [1, 3])
def test_paged_steps_with_padded_lanes_match_jax(rng, llava, n_decode):
    """Three requests in a batch padded to four lanes and a chunk padded
    to eight positions, then decode steps: the padded lanes' and
    positions' K/V rows go to the scratch block.  Logits of the live
    lanes and the pools outside the scratch block match ``repro``."""
    cfg, jparams, tparams = llava
    B, B_pad, C_pad = 3, 4, 8
    kv = DevicePagedCache(PagedCacheSpec(2, cfg.num_layers, 8,
                                         cfg.num_kv_heads * cfg.head_dim, 16),
                          device="cpu")
    jkv = jnp.asarray(kv.data.numpy())
    state = {"layers": [{} for _ in range(cfg.num_layers)]}
    n_new = [8, 3, 6]
    tokens = np.zeros((B_pad, C_pad), np.int32)
    for b, n in enumerate(n_new):
        tokens[b, :n] = rng.integers(0, cfg.vocab_size, n)
    mask = np.arange(C_pad)[None] < np.asarray(n_new + [0])[:, None]
    last = np.asarray([n - 1 for n in n_new] + [0], np.int32)
    ctx = np.zeros(B_pad, np.int32)
    tables, slots = kv.prepare_prefill(list(range(B)), n_new, B_pad, C_pad,
                                       bucket_pow2(1))
    ctl = {"kv": {"tables": tables, "slots": slots}, "mask": mask,
           "last": last}
    want, jdata, _ = JM.prefill_chunk_paged(
        cfg, jparams, {"kv": jkv}, jax.tree.map(jnp.asarray, ctl), state,
        jnp.asarray(ctx), jnp.asarray(tokens), attn_impl="ref")
    got, _, _ = M.prefill_chunk_paged(cfg, tparams, {"kv": kv.data},
                                      _with_scratch(ctl, kv), state, _t(ctx),
                                      _t(tokens))
    kv.commit_prefill(list(range(B)), n_new)
    jkv = jdata["kv"]
    _close(got.numpy(), want, slice(0, B))
    tok = np.zeros(B_pad, np.int32)
    tok[:B] = np.argmax(np.asarray(want)[:B], -1)
    for _ in range(n_decode):
        lens = np.zeros(B_pad, np.int32)
        lens[:B] = [kv.lengths[b] for b in range(B)]
        tables, slots = kv.prepare_decode(list(range(B)), B_pad,
                                          bucket_pow2(2))
        ctl = {"kv": {"tables": tables, "slots": slots}}
        want, jdata, _ = JM.decode_step_paged(
            cfg, jparams, {"kv": jkv}, jax.tree.map(jnp.asarray, ctl), state,
            jnp.asarray(lens), jnp.asarray(tok[:, None]), attn_impl="ref")
        got, _, _ = M.decode_step_paged(
            cfg, tparams, {"kv": kv.data}, _with_scratch(ctl, kv), state,
            _t(lens), _t(tok[:, None]))
        kv.commit_decode(list(range(B)))
        jkv = jdata["kv"]
        _close(got.numpy(), want, slice(0, B))
        tok[:B] = np.argmax(np.asarray(want)[:B], -1)
    n = kv.spec.num_blocks
    np.testing.assert_allclose(kv.data.numpy()[:, :, :n],
                               np.asarray(jkv)[:, :, :n], atol=1e-5, rtol=0)
