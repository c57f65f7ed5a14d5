"""HydraInfer on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro`` (``configs``, ``core``, ``engine``, ``models``,
``kernels``) so each module's counterpart is easy to find.  The package
imports ``torch`` and ``numpy`` only.  Every entry point takes an explicit
``device`` that defaults to ``"cuda"`` and raises when no card is present;
callers that want the CPU (the parity tests) ask for it.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  Raises when a CUDA device
    is asked for and no card is present: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:N": name the card so devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
