"""Llama-3.2-Vision-90B: decoder with cross-attention image layers every 5th
layer; vision frontend stubbed [hf:meta-llama/Llama-3.2-11B-Vision].
100L d_model=8192 64H kv=8 d_ff=28672 vocab=128256."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    frontend="vision",
    n_frontend_tokens=1600,   # precomputed patch embeddings (stub)
    rope_theta=500_000.0,
)
