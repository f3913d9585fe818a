"""Llama-4 Maverick: 400B MoE, 128 experts top-1 + shared, alternating
dense/MoE layers [hf:meta-llama/Llama-4]. 48L d_model=5120 40H kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,            # per-expert
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    moe_every=2,          # interleaved: every other layer is MoE
    dense_d_ff=16384,
    rope_theta=500_000.0,
)
