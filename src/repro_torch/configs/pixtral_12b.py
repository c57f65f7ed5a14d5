"""pixtral-12b — pixtral-ViT (stub) + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    frontend="vision",
    media_tokens=1024,      # patch embeddings per image (stubbed ViT)
    vision_layers=24,
    vision_d_model=1024,
    source="hf:mistralai/Pixtral-12B-2409",
)
