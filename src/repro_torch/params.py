"""Model parameters as an ``nn.Module`` tree.

The attribute names follow the JAX package's param tree (``embed``,
``final_norm``, ``lm_head``, ``media_proj_w1``/``w2``, attention layers'
``layers[i].{norm1, wq, wk, wv, wo, norm2, w_gate, w_up, w_down}`` (with
cross-attention also ``xnorm, xq, xk, xv, xo``), the audio encoder's
``encoder.{layers[i].{norm1, wq, wk, wv, wo, norm2, w_up, w_down}, norm}``,
Mamba-1 layers' ``layers[i].{norm, in_proj, conv_w, conv_b, x_proj,
dt_proj, dt_bias, A_log, D, out_proj}``, Mamba-2 layers' ``{norm,
in_proj, bc_proj, dtp, conv_w, conv_b, dt_bias2, A_log2, D2, ssm_norm,
out_proj}`` (a shared-attention layer holds only its ``norm``; the block
it shares is ``shared``, an attention layer's tree), MoE layers'
``router`` and experts ``moe_w_{gate, up, down}`` [E, in, out] (with
shared experts ``sh_w_{gate, up, down}``) in place of the MLP, MLA
layers' ``{norm1, kv_a, kv_norm, kv_b, wo, q_a, q_norm, q_b, norm2}`` in
place of the attention), and every weight keeps the JAX layout
([in, out], applied as ``x @ w``), so a tree converted from
``repro.models.model.init_params`` computes exactly what the JAX model
computes.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device

# leaves the JAX package keeps in f32 whatever the weights' type
F32_LEAVES = frozenset({"final_norm", "norm", "norm1", "norm2", "xnorm",
                        "dt_bias", "A_log", "D", "dt_bias2", "A_log2", "D2",
                        "ssm_norm", "router", "kv_norm", "q_norm"})


class ParamTree(nn.Module):
    """One node of the parameter tree: tensors become ``nn.Parameter``s
    (frozen unless ``trainable``, as serving keeps them), dicts child
    nodes, lists ``nn.ModuleList``s."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                setattr(self, name, ParamTree(v, trainable))
            elif isinstance(v, (list, tuple)):
                setattr(self, name, nn.ModuleList(ParamTree(x, trainable)
                                                  for x in v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=trainable))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def leaves(self) -> dict:
        """{path: tensor} in the JAX tree's key layout ("embed",
        "layers/0/wq", "encoder/layers/1/norm1"), the layout of the
        checkpoints and of the optimizer's moments."""
        return {name.replace(".", "/"): p
                for name, p in self.named_parameters()}

    def tree(self) -> dict:
        """The nested dicts and lists of tensors this node was built from."""
        out: dict = dict(self.named_parameters(recurse=False))
        for name, child in self.named_children():
            out[name] = child.tree() if isinstance(child, ParamTree) \
                else [c.tree() for c in child]
        return out


def params_from_numpy(tree: dict, device="cuda", dtype=None,
                      trainable: bool = False) -> ParamTree:
    """The JAX param tree, with numpy arrays as leaves (``np.asarray`` of
    each jax array), as the port's module on ``device``.  ``dtype`` casts
    the weights; the leaves in ``F32_LEAVES`` (norm scales, the Mamba
    ``dt_bias``/``A_log``/``D`` and their Mamba-2 counterparts, and the
    MoE router) stay f32, as the JAX package keeps them.  ``trainable``
    makes every leaf require grad (training); serving keeps them frozen.
    A sharded run takes the full tree this returns and keeps its rank's
    cut: ``models.sharding.shard_params(params_from_numpy(...), cfg,
    mesh)``."""
    dev = resolve_device(device)

    def conv(x, name=None):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        t = torch.from_numpy(np.array(x, copy=True))
        if dtype is not None and t.is_floating_point() \
                and name not in F32_LEAVES:
            t = t.to(dtype)
        return t.to(dev)

    return ParamTree(conv(tree), trainable)
