"""Architecture registry: the 10 assigned configs + the paper's own model."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ATTN_MLP, ATTN_MOE, MLA_MLP, MLA_MOE, MAMBA1, MAMBA2, SHARED_ATTN,
    INPUT_SHAPES, InputShape, ModelConfig, shape_applicable,
)

_ARCH_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-small": "whisper_small",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama3-8b": "llama3_8b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-7b": "zamba2_7b",
    "stablelm-12b": "stablelm_12b",
    "pixtral-12b": "pixtral_12b",
    "gemma-7b": "gemma_7b",
    # the paper's own evaluation models
    "llava-1.5-7b": "llava15_7b",
    "llava-next-7b": "llava_next_7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

PAPER_MODELS = ["llava-1.5-7b", "llava-next-7b", "qwen2-vl-7b"]
ASSIGNED_ARCHS = [a for a in _ARCH_MODULES if a not in PAPER_MODELS]
ALL_ARCHS = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ALL_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ALL_ARCHS)
