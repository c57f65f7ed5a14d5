"""Training step, as ``repro.train.train``: next-token cross-entropy over
the text segment plus ``AUX_LOSS_WEIGHT`` times the MoE layers' summed
load-balance loss (0 for models without MoE), remat'd blocks, AdamW."""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.train.optim import AdamWConfig, adamw_update

AUX_LOSS_WEIGHT = 0.01


def loss_fn(cfg: ModelConfig, params, batch: dict, *, remat: bool = True):
    """batch: {"tokens" [B, S], "labels" [B, S], "media"?, "frames"?} as
    tensors on the params' device.  Next-token CE over the text segment
    (media prefix positions are excluded), labels shifted inside, -1 =
    padding, the log-sum-exp in f32.  Returns (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    labels = batch.get("labels", tokens)
    logits, _, aux = M.forward(cfg, params, tokens, media=batch.get("media"),
                               frames=batch.get("frames"), remat=remat)
    n_media = logits.shape[1] - tokens.shape[1]
    # predict labels[t + 1] from position t
    lg = logits[:, n_media:][:, :-1].float()
    tgt = labels[:, 1:].long()
    mask = (tgt >= 0).float()
    tgt = tgt.clamp(min=0)
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, tgt[..., None])[..., 0]
    ce = ((lse - picked) * mask).sum() / mask.sum().clamp(min=1.0)
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


def train_step(cfg: ModelConfig, opt: AdamWConfig, params, opt_state,
               batch: dict, *, remat: bool = True):
    """Loss, gradients of every leaf (zeros for a leaf the batch does not
    reach, as ``jax.grad`` gives), and one AdamW step in place.  Returns
    (params, opt_state, {"loss", "ce", "aux", "lr", "grad_norm"})."""
    leaves = params.leaves()
    loss, stats = loss_fn(cfg, params, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    params, opt_state, ostats = adamw_update(
        opt, params, dict(zip(leaves, grads)), opt_state)
    return params, opt_state, {"loss": loss.detach(), **stats, **ostats}


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    remat: bool = True):
    return functools.partial(train_step, cfg, opt, remat=remat)
