"""Flat-npz checkpointing for params / optimizer trees, as
``repro.train.checkpoint``, in its key layout (``params/layers/0/wq``,
``opt/m/layers/0/wq``, ``opt/step``), so a checkpoint written by either
package loads into the other.  bf16 leaves are written as f32 (numpy has no
bf16; widening is exact), and a bf16 leaf the JAX package wrote (two-byte
void records) is read back by its bits."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.params import ParamTree


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, ParamTree):
        tree = tree.tree()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        t = torch.as_tensor(tree).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[prefix.rstrip("/")] = t.cpu().numpy()
    return out


def save(path: str, tree) -> None:
    np.savez(path, **_flatten(tree))


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # JAX bf16
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def load(path: str, like):
    """Restore into the structure, dtype and device of ``like`` (a tree of
    dicts, lists, ParamTrees and tensors; a ParamTree comes back as a new
    one, trainable when ``like`` is)."""
    data = np.load(path)

    def rebuild(node, prefix=""):
        if isinstance(node, ParamTree):
            trainable = any(p.requires_grad for p in node.parameters())
            return ParamTree(rebuild(node.tree(), prefix), trainable)
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        return _tensor(data[prefix.rstrip("/")]).to(node.device, node.dtype)

    return rebuild(like)
