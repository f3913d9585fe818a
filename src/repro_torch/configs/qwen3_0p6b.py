"""Qwen3-0.6B: dense, GQA kv=8, qk_norm [hf:Qwen/Qwen3-8B family].
28L d_model=1024 16H d_ff=3072 vocab=151936."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
