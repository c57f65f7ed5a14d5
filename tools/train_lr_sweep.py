#!/usr/bin/env python3
"""Loss over a few AdamW steps of full-width LLaVA-1.5-7B (depth cut, random
bf16 weights, remat) on one fixed batch, for several learning rates and
warmups, each from the same seeded weights: how large a first step the
4096-wide model takes before its loss rises.

    python3 tools/train_lr_sweep.py [--layers 16] [--steps 4]

Run from the repository root on a machine with a CUDA card (about 42.8 GB
of weights, gradients and moments at 16 layers).  Prints one JSON line per
(lr, warmup) and the card's name and power limit.
"""
import argparse
import dataclasses
import gc
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# (lr, warmup steps)
SCHEDULES = [(1e-4, 0), (1e-5, 0), (3e-6, 0), (1e-6, 0), (1e-4, 100)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_lr_sweep.py: needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train.data import DataConfig, batches, to_device
    from repro_torch.train.optim import AdamWConfig, init_opt_state
    from repro_torch.train.train import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(get_config("llava-1.5-7b"),
                              num_layers=args.layers)
    batch = to_device(next(batches(cfg, DataConfig(
        batch_size=2, seq_len=2048, seed=args.seed))), "cuda", torch.bfloat16)
    for lr, warmup in SCHEDULES:
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
            args.seed), dtype=torch.bfloat16, trainable=True)
        state = init_opt_state(params)
        step = make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=warmup,
                                                total_steps=10_000))
        losses, norms = [], []
        for _ in range(args.steps):
            params, state, stats = step(params, state, batch)
            losses.append(float(stats["loss"]))
            norms.append(float(stats["grad_norm"]))
        print(json.dumps({"lr": lr, "warmup_steps": warmup,
                          "losses": losses, "grad_norm": norms}), flush=True)
        del params, state, step, stats
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
