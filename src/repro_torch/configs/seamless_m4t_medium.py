"""SeamlessM4T-medium: encoder-decoder, audio frontend stubbed
[arXiv:2308.11596]. 12L enc + 12L dec, d_model=1024, 16H, d_ff=4096."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,          # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    mlp_kind="gelu",
    frontend="audio",
    n_frontend_tokens=1024,   # precomputed speech frames per sample (stub)
    rope_theta=10_000.0,
)
