"""Mamba2-1.3B: attention-free SSD (state-space duality) [arXiv:2405.21060].
48L d_model=2048, ssm_state=128, vocab=50280."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
)
