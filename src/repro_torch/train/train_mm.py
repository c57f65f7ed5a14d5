"""End-to-end training entry point of the PyTorch port: train a ~47M-param
reduced multimodal model on synthetic packed data with AdamW + cosine LR +
checkpointing, the counterpart of the JAX package's
``examples/train_mm.py`` (same flags, same mini config, f32 weights).

Run:  PYTHONPATH=src python -m repro_torch.train.train_mm [--steps 200]

One flag more: ``--device`` (default ``cuda``, which raises without a
card; ``cpu`` runs the kernels' plain versions).  Weights are drawn on the
device from ``torch.Generator(device).manual_seed(0)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, batches, to_device
from repro_torch.train.optim import AdamWConfig, init_opt_state
from repro_torch.train.train import make_train_step


def mini_config(arch: str) -> ModelConfig:
    """The ~100M-class variant of ``examples/train_mm.py``: reduced depth
    and width, a real vocab."""
    return dataclasses.replace(get_config(arch).reduced(),
                               num_layers=4, d_model=512, num_heads=8,
                               num_kv_heads=8, head_dim=64, d_ff=1536,
                               vocab_size=32000, media_tokens=64)


def train(cfg: ModelConfig, *, steps: int, ckpt_path: str,
          device="cuda") -> list:
    """Train ``cfg`` from seeded random weights for ``steps`` steps, print
    ``examples/train_mm.py``'s progress lines, write the checkpoint;
    returns each step's loss."""
    dev = resolve_device(device)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name}-mini: {n_params/1e6:.1f}M params")

    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    state = init_opt_state(params)
    step = make_train_step(cfg, opt)
    data = batches(cfg, DataConfig(batch_size=4, seq_len=128))

    losses = []
    t0 = time.time()
    for i in range(steps):
        batch = to_device(next(data), dev)
        params, state, stats = step(params, state, batch)
        losses.append(float(stats["loss"]))
        if i % 20 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.3f}  "
                  f"lr {float(stats['lr']):.2e}  "
                  f"gnorm {float(stats['grad_norm']):.2f}  "
                  f"{(i+1)/(time.time()-t0):.2f} it/s")
    ckpt.save(ckpt_path, {"params": params, "opt": state})
    print(f"checkpoint -> {ckpt_path}")
    return losses


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llava-1.5-7b")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_mm.npz"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return train(mini_config(args.arch), steps=args.steps,
                 ckpt_path=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
