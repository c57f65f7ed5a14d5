"""Hand-written Hopper kernels for the serving hot path, one subpackage per
TPU kernel of the JAX package:

  cache_write      - the fused KV/image-cache row write (paper §4.5)
  paged_attention  - decode and chunked-prefill attention over paged KV,
                     decode with split-KV whose last block per tile merges
                     the splits (csrc/attn_merge.cuh, shared with flash);
                     bf16 MLA latent rows (D = 576) on the wgmma tiles of
                     csrc/attn_latent.cuh
  selective_scan   - the Mamba-1 recurrence (falcon-mamba prefill and decode)
                     and its per-head mode, the Mamba-2 recurrence (zamba2)
  flash_attention  - full-sequence attention over contiguous K/V (whisper's
                     audio encoder and cross-attention), with split-KV for
                     short query tiles, merged the same way

Each subpackage: ``ref.py`` (plain PyTorch version, also the CPU path) and
``ops.py`` (the wrapper).  The CUDA sources live in ``repro_torch/csrc``
and are built at first use by ``_build.py``.  A wrapper sends CPU tensors
to the plain version and CUDA tensors to the kernel; there is no switch and
no fallback.  ``launches`` counts kernel launches (only real launches, never
plain-version calls), so a run can show which kernels its path went
through: ``*_split`` counts the split calls among them, each of which
merges its splits in its own last blocks, ``*_merge`` the merge kernel
launched alone (to check it), and ``*_latent`` the latent-row kernels.
"""
from __future__ import annotations

import ctypes as ct
import functools
import threading

import torch

launches = {"cache_write": 0, "paged_attention": 0,
            "paged_attention_split": 0, "paged_attention_merge": 0,
            "paged_prefill_attention": 0, "paged_attention_latent": 0,
            "paged_prefill_attention_latent": 0, "selective_scan": 0,
            "selective_scan_heads": 0, "flash_attention": 0,
            "flash_attention_split": 0, "flash_attention_merge": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (take the plain version),
    False when every tensor lies on one CUDA device (launch the kernel).
    Raises for a CUDA request without a card and for mixed devices."""
    devs = {t.device for t in tensors}
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len(devs) == 1:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA tensor given but CUDA is not available")
        return False
    raise ValueError(f"kernel inputs on unsupported or mixed devices: "
                     f"{sorted(str(d) for d in devs)}")


def check_launch(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


@functools.lru_cache(maxsize=None)
def n_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the split
    planners' card width), looked up once per process."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_counters: dict = {}    # (device, stream) -> (capture id or None, buffer)
_counters_lock = threading.Lock()


def tile_counters(t: torch.Tensor, stream: int, tiles: int,
                  library: str) -> int:
    """Address of ``tiles`` zero int32 counters on ``t``'s device for one
    split call of ``library``'s kernel on ``stream`` (its current stream,
    as :func:`stream_ptr` gives it).  The kernel's last blocks leave them
    zero, so a buffer serves every later call on that stream; it is made
    (``torch.zeros``) on first use and grown on demand.  Calls that may run
    at once never share one: each (device, stream) has its own, and a CUDA
    graph capture its own per stream it captures on, made inside the
    capture, so the graph's replays fill it, use it and never meet another
    graph's or an eager call's counters (graphs captured on the same
    stream, torch's default capture stream among them, included).  A
    capture's buffer is dropped when its stream is next used outside it;
    the graph's memory pool keeps it, as it keeps any tensor the capture
    freed."""
    from repro_torch.kernels import _build
    cid = ct.c_ulonglong()
    query = _build.function(library, "stream_capture",
                            [ct.c_void_p, ct.c_void_p])
    capturing = query(stream, ct.byref(cid))
    if capturing < 0:
        raise RuntimeError(f"{library}: cudaStreamGetCaptureInfo failed")
    key, cid = (t.device.index, stream), cid.value if capturing else None
    with _counters_lock:
        have = _counters.get(key)
        if have is None or have[0] != cid or have[1].numel() < tiles:
            n = max(tiles, 4096 if have is None or have[0] != cid
                    else 2 * have[1].numel())
            have = (cid, torch.zeros(n, dtype=torch.int32, device=t.device))
            _counters[key] = have
    return have[1].data_ptr()


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)
