"""Hand-written Hopper kernels for the serving hot path, one subpackage per
TPU kernel of the JAX package:

  cache_write      - the fused KV/image-cache row write (paper §4.5)
  paged_attention  - decode and chunked-prefill attention over paged KV,
                     decode with split-KV and the kernel that merges the
                     splits (csrc/attn_merge.cuh, shared with flash)
  selective_scan   - the Mamba-1 recurrence (falcon-mamba prefill and decode)
  flash_attention  - full-sequence attention over contiguous K/V (whisper's
                     audio encoder and cross-attention), with split-KV for
                     short query tiles and the kernel that merges the splits

Each subpackage: ``ref.py`` (plain PyTorch version, also the CPU path) and
``ops.py`` (the wrapper).  The CUDA sources live in ``repro_torch/csrc``
and are built at first use by ``_build.py``.  A wrapper sends CPU tensors
to the plain version and CUDA tensors to the kernel; there is no switch and
no fallback.  ``launches`` counts kernel launches (only real launches, never
plain-version calls), so a run can show which kernels its path went
through.
"""
from __future__ import annotations

import functools

import torch

launches = {"cache_write": 0, "paged_attention": 0,
            "paged_attention_merge": 0, "paged_prefill_attention": 0,
            "selective_scan": 0,
            "flash_attention": 0, "flash_attention_merge": 0}


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


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)
