"""llava-next-7b — paper eval model; high-res tiling -> ~2880 image tokens
[arXiv:2407.07895]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32064,
    frontend="vision",
    media_tokens=2880,      # AnyRes tiling: base + 4 tiles x 576
    vision_layers=24,
    vision_d_model=1024,
    source="arXiv:2407.07895 (paper's own eval model)",
)
