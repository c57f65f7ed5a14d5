"""whisper-small — enc-dec audio; conv/mel frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,          # decoder depth
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,        # GQA kv=12 (i.e. MHA)
    d_ff=3072,
    vocab_size=51865,
    act="gelu_mlp",         # plain (non-gated) GELU MLP, as in whisper
    frontend="audio",
    media_tokens=1500,      # precomputed mel+conv frame embeddings
    cross_attention=True,
    rope_theta=0.0,         # whisper uses learned absolute positions
    source="arXiv:2212.04356",
)
