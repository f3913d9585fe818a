"""NVIDIA Nemotron-3-Nano-30B-A3B (``nemotron_h``): 52 pre-norm residual
blocks laid out by ``hybrid_override_pattern``, 23 Mamba-2 (M), 23 MoE (E)
and 6 attention (*) blocks, d_model 2,688
[huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16, config.json].

Mamba-2: 64 heads of 64 (d_inner 4,096), state 128, 8 B / C groups, conv 4
with bias, chunk 128, a gated RMSNorm per group of 512. MoE: 128 routed
experts, top 6, selected on sigmoid(x W_r) + e_score_correction_bias and
weighted by the renormalised scores times 2.5, each expert down(relu(up
x)^2) of width 1,856, plus one shared expert of width 3,712; no token is
dropped. Attention: GQA 32 / 2 heads of 128 with no position encoding
(the published modelling code applies no rotary embedding). Untied head
over 131,072 ids."""
from repro_torch.configs.base import ModelConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ModelConfig(
    name="nemotron3-nano-30b-a3b",
    family="hybrid",
    block_pattern=PATTERN,
    n_layers=len(PATTERN),
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=1856,            # per routed expert
    vocab_size=131072,
    norm_eps=1e-5,
    mlp_kind="relu2",
    use_rope=False,
    n_experts=128,
    top_k=6,
    n_shared_experts=1,
    shared_d_ff=3712,
    router="sigmoid",
    routed_scale=2.5,
    dropless=True,
    ssm_state=128,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_heads=64,
    ssm_groups=8,
    ssm_chunk=128,
)
