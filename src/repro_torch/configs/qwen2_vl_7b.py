"""qwen2-vl-7b — paper eval model; resolution-adaptive visual tokens
[arXiv:2409.12191]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    frontend="vision",
    media_tokens=1236,      # ~typical for dataset images
    vision_layers=32,
    vision_d_model=1280,
    source="arXiv:2409.12191 (paper's own eval model)",
)
