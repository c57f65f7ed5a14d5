#!/usr/bin/env python3
"""The gap between full-width LLaVA-1.5-7B's dense (host-cache) runner and
its paged runner on one card, in the weights' type:

    python3 tools/dense_gap.py [--dtype bfloat16] [--seed S]

runs ``chip_smoke.py``'s ``dense_vs_paged`` (the same encode, image chunk,
32-token chunk and 8 teacher-forced decode steps for 3 requests through
both runners on the same random weights, at the config's 32 layers) and
prints its line: each step's largest relative logit error.  In bf16 the
two paths round in different places (flash over the dense prefix against
the paged-prefill kernels); in f32 (the default; its weights take 28 GB)
both run the CUDA-core f32 bodies, so what is left is summation order,
against the f32 model checks' bar of 2e-4.  Needs a CUDA card; prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dense_gap.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg = get_config("llava-1.5-7b")
    dtype = getattr(torch, args.dtype)
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(args.seed), dtype=dtype)
    S.dense_vs_paged(cfg, params, args.seed, card, dtype=dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
