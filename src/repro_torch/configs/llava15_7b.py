"""llava-1.5-7b — the paper's evaluation model: CLIP-ViT-L/336 (stub, 576
image tokens) + Vicuna-7B (llama-architecture) backbone [arXiv:2304.08485]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-1.5-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    frontend="vision",
    media_tokens=576,       # 336x336 / 14x14 patches (paper: 576 tokens/image)
    vision_layers=24,
    vision_d_model=1024,
    source="arXiv:2304.08485 (paper's own eval model)",
)
