"""Zamba2-2.7B: Mamba2 backbone + one shared attention block applied
periodically [arXiv:2411.15242]. 54L d_model=2560, attn 32H, ssm_state=64."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,   # shared block applied every 6 mamba layers (9 times)
)
