"""Kimi K2: trillion-param MoE, 384 experts top-8 + 1 shared
[arXiv:2501.kimi2, paper-table]. 61L d_model=7168 64H kv=8, expert d_ff=2048.
Layer 0 dense (DeepSeek-V3 style)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,            # per-expert
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    n_dense_layers=1,
    dense_d_ff=16384,
    rope_theta=50_000.0,
)
