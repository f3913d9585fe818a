"""Qwen3-8B: dense, GQA kv=8, qk_norm [hf:Qwen/Qwen3-8B].
36L d_model=4096 32H d_ff=12288 vocab=151936."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
