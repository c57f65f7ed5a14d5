"""Sharding over a ``torch.distributed`` DeviceMesh: the mesh context, the
parameter partition rules, each rank's cut of the weights, and the
collectives the sharded serving steps call.

The counterpart of ``repro.models.sharding``.  The JAX package states
where each tensor lives and leaves the collectives to GSPMD; here every
rank holds its own cut of the weights (:func:`shard_params`) and the
model code calls the collectives itself, all of them ``all_reduce`` over
one mesh dimension's process group: a sum of partial products
(:func:`row_parallel`), a vocabulary-parallel lookup
(:func:`vocab_embed`), a gather written as slices into a zero buffer
(:func:`vocab_logits`, :func:`gather_dp`).  With no mesh set every hook is
the identity, as the JAX package's ``constrain`` is, so the same model
code runs on one device and under a mesh.

A mesh is a ``DeviceMesh`` with dimension names ``("data", "model")`` or
``("pod", "data", "model")``.  Weights are cut over ``model`` and kept
whole over the data dimensions; activations are replicated over
``model`` and the batch is split over the data dimensions, each rank
given its own rows by the caller.  The local layout is this package's
own: attention weights are cut by whole query heads, each rank holding
the whole KV heads its query heads read (a KV head that does not split
over ``model`` is held by every rank that reads it); Mamba-1's packed
``in_proj`` [d, x | z] is cut by the rank's channels in each half; the
vocabulary, the FFN width, the experts and ``d_inner`` are cut into
contiguous spans of ceil(n / M), the last one shorter when M does not
divide n.  The spec functions (:func:`param_pspecs`,
:func:`param_shardings`) give the JAX package's decisions leaf by leaf.

The sharded steps run without autograd: a collective handed a tensor
that requires grad raises, and so does a model under a mesh whose
weights require grad (training under a mesh is not ported yet).
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import (ATTN_MLP, ATTN_MOE, MAMBA1,
                                      ModelConfig)

NOT_PORTED = "not ported under a mesh yet (ROADMAP queue 1 item 16)"


class P(tuple):
    """A partition spec: one entry a dim, ``None`` (whole), a mesh axis
    name, or a tuple of axis names; the port's stand-in for jax's
    ``PartitionSpec``, compared as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# mesh context
# ---------------------------------------------------------------------------
_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


@contextmanager
def use_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, in its order (a mapping is
    returned as a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes() -> tuple:
    """Data-parallel axes present in the active mesh ((pod, data) or
    (data,))."""
    if _MESH is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in _MESH.mesh_dim_names)


def divisible(dim: int, axis: str) -> bool:
    if _MESH is None or axis not in _MESH.mesh_dim_names:
        return False
    return dim % mesh_shape(_MESH)[axis] == 0


def axis_size(axis: str) -> int:
    """Ranks along ``axis`` of the active mesh (1 without one)."""
    return mesh_shape(_MESH).get(axis, 1) if _MESH is not None else 1


def axis_rank(axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    if _MESH is None or axis not in _MESH.mesh_dim_names:
        return 0
    return _MESH.get_local_rank(axis)


def dp_size() -> int:
    return int(np.prod([axis_size(a) for a in dp_axes()], dtype=np.int64))


def dp_rank() -> int:
    """This rank's index over the data axes, pod major (the order in which
    jax lays a batch over ``("pod", "data")``)."""
    r = 0
    for a in dp_axes():
        r = r * axis_size(a) + axis_rank(a)
    return r


def span(n: int, parts: int, index: int) -> tuple:
    """[lo, hi) of part ``index`` when n is cut into ``parts`` contiguous
    spans of ceil(n / parts) (the last ones shorter, or empty)."""
    step = -(-n // parts)
    lo = min(n, index * step)
    return lo, min(n, lo + step)


def model_span(n: int) -> tuple:
    """This rank's span of n over ``model`` ((0, n) without a mesh)."""
    return span(n, axis_size("model"), axis_rank("model"))


# ---------------------------------------------------------------------------
# collectives (all_reduce only)
# ---------------------------------------------------------------------------
def _all_reduce(t, axis: str):
    """Sum ``t`` in place over ``axis``'s process group."""
    if t.requires_grad:
        raise NotImplementedError(
            "a collective of the sharded steps was handed a tensor that "
            "requires grad: gradients through the collectives are not "
            "ported yet (ROADMAP queue 1 item 16)")
    dist.all_reduce(t, group=_MESH.get_group(axis))
    return t


def reduce_model(t):
    """The sum of every model rank's ``t``, in f32 (``t`` itself without a
    mesh or with one model rank)."""
    if axis_size("model") == 1:
        return t
    return _all_reduce(t.to(torch.float32, copy=True), "model")


def reduce_dp(t):
    """The sum of every data rank's ``t`` (f32), over each data axis in
    turn."""
    for a in dp_axes():
        if axis_size(a) > 1:
            t = _all_reduce(t.to(torch.float32, copy=True), a)
    return t


def row_parallel(x, w):
    """``x @ w`` where w holds this rank's rows and x the matching columns
    (the rank's heads, channels or FFN width): each rank's partial product
    in f32 (bf16 inputs through cuBLAS with an f32 output), their sum over
    ``model``, rounded once to x's type, as the unsharded product
    accumulates in f32 and rounds once."""
    if axis_size("model") == 1:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        part = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        part = x2.float() @ w.float()
    part = _all_reduce(part, "model")
    return part.to(x.dtype).view(*x.shape[:-1], w.shape[-1])


def vocab_embed(table, tokens, vocab: int):
    """Rows ``tokens`` of the embedding ``table``, which holds this rank's
    span of the vocabulary: each rank looks up the tokens it holds, zeros
    elsewhere, and the sum over ``model`` is exact."""
    if axis_size("model") == 1:
        return table[tokens.long()]
    lo, hi = model_span(vocab)
    t = tokens.long() - lo
    inside = (t >= 0) & (t < hi - lo)
    rows = table[t.clamp(0, max(hi - lo - 1, 0))] * inside[..., None]
    return _all_reduce(rows.float(), "model").to(table.dtype)


def vocab_logits(h, w, vocab: int):
    """``h @ w`` where w holds this rank's span of the vocabulary's
    columns: each rank writes its logits into a zero [..., vocab] buffer,
    summed over ``model`` (a gather, exact)."""
    local = h @ w
    if axis_size("model") == 1:
        return local
    lo, hi = model_span(vocab)
    full = local.new_zeros(local.shape[:-1] + (vocab,), dtype=torch.float32)
    full[..., lo:hi] = local
    return _all_reduce(full, "model").to(local.dtype)


def gather_dp(t):
    """Every data rank's ``t`` (the same shape on each) stacked in data
    order: [dp_size, *t.shape], f32, written into a zero buffer and summed
    over the data axes."""
    n = dp_size()
    if n == 1:
        return t.float()[None]
    buf = t.new_zeros((n,) + tuple(t.shape), dtype=torch.float32)
    buf[dp_rank()] = t
    return reduce_dp(buf)


# ---------------------------------------------------------------------------
# what runs under a mesh
# ---------------------------------------------------------------------------
def check_model(cfg: ModelConfig, params=None, *inputs):
    """Raise unless the active mesh can run ``cfg``: attention + MLP or MoE
    layers and Mamba-1 layers, the vision projector; and nothing that
    requires grad.  A no-op without a mesh."""
    if _MESH is None:
        return
    other = sorted(set(cfg.layer_kinds()) - {ATTN_MLP, ATTN_MOE, MAMBA1})
    what = []
    if other:
        what.append(f"layer kinds {other}")
    if cfg.cross_attention:
        what.append("cross-attention")
    if cfg.sliding_window and cfg.global_every:
        what.append("sliding-window layers")
    if cfg.frontend not in ("none", "vision"):
        what.append(f"the {cfg.frontend!r} frontend")
    if what:
        raise NotImplementedError(f"{cfg.name}: {', '.join(what)} "
                                  f"{NOT_PORTED}")
    if torch.is_grad_enabled():
        grads = [t for t in inputs if torch.is_tensor(t) and t.requires_grad]
        if params is not None:
            grads += [t for t in params.parameters() if t.requires_grad]
        if grads:
            raise NotImplementedError(
                f"{cfg.name}: a parameter or input requires grad under a "
                f"mesh; training under a mesh is not ported yet (ROADMAP "
                f"queue 1 item 16)")


def refuse(what: str):
    """Raise when ``what`` (a step this slice does not shard) is called
    under a mesh."""
    if _MESH is not None:
        raise NotImplementedError(f"{what} {NOT_PORTED}")


# ---------------------------------------------------------------------------
# parameter partition rules (matched on the param's key name)
# ---------------------------------------------------------------------------
_COL = P(None, "model")            # [in, out_sharded]
_ROW = P("model", None)            # [in_sharded, out]
_EXP_COL = P("model", None, None)  # [experts_sharded, in, out]

PARAM_RULES: dict = {
    # embeddings / head
    "embed": P("model", None),          # vocab-sharded
    "lm_head": _COL,
    "media_proj_w1": _COL,
    "media_proj_w2": _ROW,
    # attention
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "bq": P("model"), "bk": P("model"), "bv": P("model"), "bo": P(None),
    # cross attention (whisper)
    "xq": _COL, "xk": _COL, "xv": _COL, "xo": _ROW,
    # MLP
    "w_gate": _COL, "w_up": _COL, "w_down": _ROW,
    # MoE
    "router": P(None, None),
    "moe_w_gate": _EXP_COL, "moe_w_up": _EXP_COL, "moe_w_down": _EXP_COL,
    "sh_w_gate": _COL, "sh_w_up": _COL, "sh_w_down": _ROW,
    # MLA
    "q_a": P(None, None), "q_b": _COL,
    "kv_a": P(None, None), "kv_b": _COL,
    # Mamba
    "in_proj": _COL, "out_proj": _ROW,
    "conv_w": P(None, "model"), "conv_b": P("model"),
    "x_proj": _ROW, "dt_proj": _COL,
    "dt_bias": P("model"), "A_log": P("model"), "D": P("model"),
    "A_log2": P("model"), "D2": P("model"), "dt_bias2": P("model"),
    "ssm_norm": P("model"),
}


def spec_for(name: str, arr) -> P:
    """The rule of leaf ``name`` (``P()`` when there is none, or when the
    rule has more dims than the leaf)."""
    ndim = len(arr.shape)
    spec = PARAM_RULES.get(name)
    if spec is None or len(spec) > ndim:
        return P()
    return spec


def _tree(params):
    return params.tree() if hasattr(params, "tree") else params


def param_pspecs(params) -> dict:
    """Specs matching a params tree (nested dicts and lists of tensors, or
    a ParamTree), by leaf key name."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return spec_for(name, node) if name is not None else P()
    return walk(_tree(params))


def _expert2d_spec(name, spec, data_axes):
    da = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes
                                               else None)
    if name in ("moe_w_gate", "moe_w_up"):
        return P("model", None, da)
    if name == "moe_w_down":
        return P("model", da, None)
    return spec


def param_shardings(mesh, params, *, fsdp: bool = False,
                    expert_2d: bool = False) -> dict:
    """The spec of each leaf of ``params`` on ``mesh`` (a DeviceMesh or an
    {axis: size} mapping), as the JAX package's ``param_shardings`` decides
    it: axes the mesh lacks and dims an axis does not divide dropped;
    ``fsdp`` also shards each large leaf's biggest free dim over the data
    axes; ``expert_2d`` shards the experts' FFN width over them.  Only
    the plain specs run in this slice (see :func:`shard_params`)."""
    shape = mesh_shape(mesh)
    names = set(shape)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    data_sz = int(np.prod([shape[a] for a in data_axes], dtype=np.int64))

    def fix(leaf, spec, name):
        if expert_2d:
            spec = _expert2d_spec(name, spec, data_axes)
        ndim = len(leaf.shape)
        out = []
        for d, s in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
            if s is None or s not in names or leaf.shape[d] % shape[s] != 0:
                out.append(None)
            else:
                out.append(s)
        if fsdp and ndim >= 2 and int(np.prod(leaf.shape)) >= (1 << 16):
            free = [d for d in range(ndim) if out[d] is None]
            free.sort(key=lambda d: -leaf.shape[d])
            for d in free:
                if leaf.shape[d] % data_sz == 0 and data_axes:
                    out[d] = data_axes if len(data_axes) > 1 \
                        else data_axes[0]
                    break
                if "data" in names and leaf.shape[d] % shape["data"] == 0:
                    out[d] = "data"
                    break
        return P(*out)

    def walk(node, spec, name=None):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s) for v, s in zip(node, spec))
        return fix(node, spec, name)

    tree = _tree(params)
    return walk(tree, param_pspecs(tree))


# ---------------------------------------------------------------------------
# each rank's cut of the weights
# ---------------------------------------------------------------------------
def head_cut(cfg: ModelConfig, rank: int, size: int) -> tuple:
    """(query heads, KV heads) ranges of model rank ``rank`` of ``size``:
    H / size whole query heads, and the whole KV heads they read, in an
    order that keeps grouped-query attention's ``h // (H / Kh)`` on the
    local counts."""
    H, Kh = cfg.num_heads, cfg.num_kv_heads
    if H % size:
        raise NotImplementedError(
            f"{cfg.name}: {H} query heads do not split over model = {size}")
    hl, group = H // size, H // Kh
    q0 = rank * hl
    kv0, kv1 = q0 // group, (q0 + hl - 1) // group + 1
    kl = kv1 - kv0
    if hl % kl or any((q0 + i) // group - kv0 != i // (hl // kl)
                      for i in range(hl)):
        raise NotImplementedError(
            f"{cfg.name}: query heads {q0}..{q0 + hl - 1} do not read "
            f"their KV heads in grouped-query order over model = {size}")
    return range(q0, q0 + hl), range(kv0, kv1)


def _cols(heads: range, width: int) -> torch.Tensor:
    return (torch.arange(heads.start, heads.stop)[:, None] * width
            + torch.arange(width)).reshape(-1)


def _spans(n: int, rank: int, size: int) -> torch.Tensor:
    return torch.arange(*span(n, size, rank))


def cut_index(cfg: ModelConfig, kind: Optional[str], name: str, rank: int,
              size: int) -> Optional[tuple]:
    """(dim, indices) of leaf ``name`` (of a layer of ``kind``, or of the
    tree's top for kind None) that model rank ``rank`` of ``size`` holds,
    or None where every rank holds the whole leaf."""
    if name in ("embed", "lm_head"):
        return (0 if name == "embed" else 1), _spans(cfg.vocab_size, rank,
                                                     size)
    if name in ("media_proj_w1", "media_proj_w2"):
        return (1 if name == "media_proj_w1" else 0), \
            _spans(2 * cfg.d_model, rank, size)
    if kind == MAMBA1:
        di = cfg.d_inner
        ch = _spans(di, rank, size)
        if name == "in_proj":                       # [d, x | z]
            return 1, torch.cat([ch, di + ch])
        dim = {"conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj": 1,
               "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}.get(name)
        return None if dim is None else (dim, ch)
    if name in ("wq", "wk", "wv", "wo"):
        q, kv = head_cut(cfg, rank, size)
        cols = _cols(q if name in ("wq", "wo") else kv, cfg.head_dim)
        return (0 if name == "wo" else 1), cols
    if name in ("w_gate", "w_up", "w_down"):
        return (0 if name == "w_down" else 1), _spans(cfg.d_ff, rank, size)
    if name in ("sh_w_gate", "sh_w_up", "sh_w_down"):
        sff = (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
        return (0 if name == "sh_w_down" else 1), _spans(sff, rank, size)
    if name in ("moe_w_gate", "moe_w_up", "moe_w_down"):
        return 0, _spans(cfg.num_experts, rank, size)
    return None


def cut_params(params, cfg: ModelConfig, rank: int, size: int):
    """Model rank ``rank`` of ``size``'s cut of the full ``params`` (a
    ParamTree): a new, frozen ParamTree of contiguous copies on the same
    device."""
    from repro_torch.params import ParamTree

    def cut(t, kind, name):
        ix = cut_index(cfg, kind, name, rank, size)
        t = t.detach()
        return t.clone() if ix is None else \
            t.index_select(ix[0], ix[1].to(t.device))

    tree = params.tree()
    out = {k: cut(v, None, k) for k, v in tree.items()
           if k not in ("layers", "shared", "encoder")}
    out["layers"] = [{k: cut(v, kind, k) for k, v in lp.items()}
                     for kind, lp in zip(cfg.layer_kinds(), tree["layers"])]
    return ParamTree(out)


def shard_params(params, cfg: ModelConfig, mesh=None):
    """This rank's cut of the full ``params`` over ``mesh``'s ``model``
    dimension (the active mesh when None); weights stay whole over the
    data dimensions.  The way full weights cross into a sharded run:
    ``params_from_numpy(...)`` (or ``init_params``), then this."""
    mesh = _MESH if mesh is None else mesh
    with use_mesh(mesh):
        check_model(cfg)
        return cut_params(params, cfg, axis_rank("model"),
                          axis_size("model"))


def local_cfg(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with this rank's KV heads and Mamba channels, for the shapes
    of its caches (``cfg`` itself without a mesh)."""
    size = axis_size("model")
    if size == 1:
        return cfg
    upd = {}
    kinds = set(cfg.layer_kinds())
    if kinds & {ATTN_MLP, ATTN_MOE}:
        q, kv = head_cut(cfg, axis_rank("model"), size)
        upd.update(num_heads=len(q), num_kv_heads=len(kv))
    if MAMBA1 in kinds:
        lo, hi = model_span(cfg.d_inner)
        upd["d_inner"] = hi - lo
    return dataclasses.replace(cfg, **upd)
