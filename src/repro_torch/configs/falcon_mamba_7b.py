"""falcon-mamba-7b — attention-free Mamba-1 SSM [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,           # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                # Mamba block subsumes the FFN
    vocab_size=65024,
    ssm_state=16,
    conv_kernel=4,
    source="arXiv:2410.05355",
)
