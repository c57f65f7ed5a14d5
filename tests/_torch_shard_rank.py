"""The ranks of the sharded serving tests (spawned by
``tests/_torch_shard.py``): each joins a gloo group on the CPU, builds a
(data, model) mesh over it, runs the port's sharded steps on each case's
cut of the weights and its rows of the batch, and writes its results to
a file.  Imports torch and the port only.
"""
import dataclasses
import datetime
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import model as M

B, S, N_STEPS = 4, 8, 4          # batch, prompt tokens, decode steps
TIMEOUT_S = 120                  # a group of ranks, start to end


@dataclasses.dataclass
class Case:
    """One reduced model and its inputs: weights drawn by the port's
    ``init_params`` (numpy, handed to both packages), prompt tokens [B,
    S], media [B, T, d] for a vision model, and the reference's results:
    forward logits and aux loss, prefill's and each teacher-forced decode
    step's logits, the greedy tokens that fed the steps."""
    name: str
    cfg: object
    tree: dict
    tokens: np.ndarray
    media: np.ndarray = None
    want: dict = None


def run_case(case: Case) -> dict:
    """The port's sharded forward, prefill and decode steps of ``case`` on
    this rank's cut and its rows of the batch (under the active mesh)."""
    from repro_torch.models import sharding as SH
    from repro_torch.params import params_from_numpy
    full = params_from_numpy(case.tree, "cpu")
    params = SH.shard_params(full, case.cfg)
    n, r = SH.dp_size(), SH.dp_rank()
    rows = slice(r * B // n, (r + 1) * B // n)
    tokens = torch.from_numpy(case.tokens[rows])
    media = None if case.media is None else torch.from_numpy(
        case.media[rows])
    logits, _, aux = M.forward(case.cfg, params, tokens, media=media)
    last, cache = M.prefill(case.cfg, params, tokens, media=media)
    n_in = tokens.shape[1] + (0 if media is None else media.shape[1])
    cache = M.build_cache_from_prefill(case.cfg, cache, n_in + N_STEPS + 1)
    steps = [last.numpy()]
    for i, tok in enumerate(case.want["fed"]):
        out, cache = M.decode_step(case.cfg, params, cache,
                                   torch.tensor(n_in + i),
                                   torch.from_numpy(tok[rows]))
        steps.append(out.numpy())
    nbytes = sum(t.numel() * t.element_size() for t in params.parameters())
    return {"rows": (rows.start, rows.stop), "logits": logits.numpy(),
            "aux": float(aux), "steps": steps, "bytes": nbytes,
            "cache_widths": [{k: tuple(v.shape) for k, v in ent.items()}
                             for ent in cache["layers"]]}


def rank_main(rank: int, world: int, model: int, tmp: str):
    torch.set_num_threads(1)
    cases = torch.load(Path(tmp) / "cases.pt", weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import sharding as SH
        mesh = make_host_mesh(model=model, device="cpu")
        with SH.use_mesh(mesh), torch.no_grad():
            out = {c.name: run_case(c) for c in cases}
            out["coords"] = (SH.dp_rank(), SH.axis_rank("model"))
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
