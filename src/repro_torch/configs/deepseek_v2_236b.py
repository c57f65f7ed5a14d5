"""deepseek-v2-236b — MLA (kv_lora=512) + MoE 160e top-6 + 2 shared [arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,       # nominal; MLA compresses the cache to kv_lora+rope
    head_dim=128,
    d_ff=12288,             # dense FFN of the first layer
    vocab_size=102400,
    num_experts=160,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    first_dense_layers=1,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    source="arXiv:2405.04434",
)
