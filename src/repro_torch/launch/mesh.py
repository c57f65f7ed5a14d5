"""Device meshes over an initialised ``torch.distributed`` process group.

The counterpart of ``repro.launch.mesh``.  Functions, not module-level
constants, so importing this module touches no process group or device:
callers decide when the ranks exist.  The caller initialises the process
group itself (``torch.distributed.init_process_group`` with its address,
world size and rank); the meshes' dimension groups use its backend.
Production target of the JAX package: 256 chips a pod (16 x 16), two pods
for multi-pod.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mesh(shape: tuple, names: tuple, device):
    dev = resolve_device(device)
    if dev.type == "cuda":      # ranks share the host's cards in turn
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (data, model) = (16, 16) mesh, or (pod, data, model) = (2, 16,
    16) with ``multi_pod``; raises unless the world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world()
    if n != 256 * (2 if multi_pod else 1):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{256 * (2 if multi_pod else 1)} ranks, the "
                         f"world has {n}")
    return _mesh(shape, names, device)


def make_host_mesh(model: int = 1, device="cuda"):
    """A (world // model, model) mesh with dims ("data", "model") over
    every rank of the process group (``model`` at most the world); the
    tests pass ``device="cpu"``."""
    n = _world()
    model = min(model, n)
    if n % model:
        raise ValueError(f"model = {model} does not divide the world of {n}")
    return _mesh((n // model, model), ("data", "model"), device)
