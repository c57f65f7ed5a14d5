"""gemma3-4b — 5:1 local:global sliding-window attention [hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,         # 5 local : 1 global
    act="gelu",             # GeGLU
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
