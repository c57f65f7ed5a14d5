"""zamba2-7b — Mamba-2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    mamba2_head_dim=64,
    attn_every=6,           # every 6th layer is the shared attention block
    source="arXiv:2411.15242",
)
