"""Config system: model architectures x input shapes.

Every assigned architecture is a `ModelConfig` in its own module
(`repro_torch.configs.<arch_id>`); `get_config(arch_id)` resolves them and
`reduced(cfg)` shrinks any config to a CPU-smoke-testable size of the same
family. Input shapes are the four assigned global shapes; `cells()`
enumerates the (arch x shape) dry-run grid with the documented skips.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

VOCAB_PAD = 2048  # pad vocab to a multiple (sharding divisibility; standard)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    mlp_kind: str = "swiglu"    # swiglu | gelu | relu2 (down(relu(up x)^2))
    use_rope: bool = True       # False: attention without position encoding
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1          # every k-th layer is MoE (1 = all)
    n_dense_layers: int = 0     # leading dense layers (DeepSeek/Kimi style)
    dense_d_ff: int = 0         # d_ff of the dense (non-expert) layers
    capacity_factor: float = 1.25
    router: str = "softmax"     # softmax | sigmoid (selected on score + bias)
    routed_scale: float = 1.0   # the routed experts' weights times this
    dropless: bool = False      # every routed slot computed, no capacity
    shared_d_ff: int = 0        # shared experts' width (0: d_ff * n_shared)
    # SSM (Mamba2/SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1         # B / C groups (each over n_ssm_heads / groups)
    ssm_heads: int = 0          # heads of ssm_head_dim (0: d_inner / head)
    # hybrid (zamba-style shared attention block)
    attn_every: int = 0         # apply the shared attn block every k ssm layers
    # pattern-driven hybrid (Nemotron-H): one character a block, "M" Mamba-2,
    # "E" MoE, "*" attention; n_layers == len(block_pattern)
    block_pattern: str = ""
    # enc-dec
    n_enc_layers: int = 0
    frontend: str = ""          # 'audio' | 'vision': modality stub (input_specs)
    n_frontend_tokens: int = 0  # frames / image patches per sample
    frontend_dim: int = 0       # stub embedding dim (0 -> d_model)
    # vlm
    cross_attn_every: int = 0   # every k-th decoder layer cross-attends

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return (self.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD

    @property
    def d_inner(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_shared_d_ff(self) -> int:
        """Width of the MoE's shared experts, taken as one MLP."""
        return self.shared_d_ff or self.d_ff * self.n_shared_experts

    # ---- parameter counting (for 6*N*D model flops) -----------------------
    def param_count(self, active_only: bool = False) -> int:
        D, H, KV, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim_
        embed = self.padded_vocab * D * 2  # in + out (untied)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D

        def mlp_params(ff, kind=self.mlp_kind):
            return (3 if kind == "swiglu" else 2) * D * ff

        def moe_layer(active):
            n_e = self.top_k if active else self.n_experts
            shared = mlp_params(self.expert_shared_d_ff) \
                if self.n_shared_experts else 0
            return n_e * mlp_params(self.d_ff) + shared + D * self.n_experts

        total = embed
        if self.block_pattern:
            per = {"M": self.ssm_layer_params(), "E": moe_layer(active_only),
                   "*": attn}
            total += sum(per[c] for c in self.block_pattern)
        elif self.family in ("dense",):
            total += self.n_layers * (attn + mlp_params(self.d_ff))
        elif self.family == "moe":
            n_moe, n_dense = self.moe_layer_counts()
            total += self.n_layers * attn
            total += n_moe * moe_layer(active_only)
            total += n_dense * mlp_params(self.dense_d_ff or self.d_ff)
        elif self.family == "ssm":
            total += self.n_layers * self.ssm_layer_params()
        elif self.family == "hybrid":
            total += self.n_layers * self.ssm_layer_params()
            total += attn + mlp_params(self.d_ff)  # ONE shared block
        elif self.family == "encdec":
            total += (self.n_enc_layers + self.n_layers) * \
                (attn + mlp_params(self.d_ff))
            total += self.n_layers * attn  # decoder cross-attention
        elif self.family == "vlm":
            n_cross = self.n_layers // max(self.cross_attn_every, 1)
            n_self = self.n_layers - n_cross
            total += n_self * (attn + mlp_params(self.d_ff))
            total += n_cross * (2 * attn + mlp_params(self.d_ff))
        return total

    def ssm_layer_params(self) -> int:
        D, Din, N = self.d_model, self.d_inner, self.ssm_state * self.ssm_groups
        H = self.n_ssm_heads
        in_proj = D * (2 * Din + 2 * N + H)  # z, x, B, C, dt
        conv = self.ssm_conv * (Din + 2 * N)
        out = Din * D
        return in_proj + conv + out + 2 * H  # + A, D per head

    def moe_layer_counts(self) -> Tuple[int, int]:
        """(n_moe_layers, n_dense_layers)."""
        n_moe = 0
        for i in range(self.n_layers):
            if i >= self.n_dense_layers and \
                    (i - self.n_dense_layers) % self.moe_every == 0:
                n_moe += 1
        return n_moe, self.n_layers - n_moe

    def is_moe_layer(self, i: int) -> bool:
        return (self.family == "moe" and i >= self.n_dense_layers
                and (i - self.n_dense_layers) % self.moe_every == 0)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "zamba2_2p7b",
    "seamless_m4t_medium",
    "qwen3_8b",
    "deepseek_67b",
    "qwen1p5_110b",
    "qwen3_0p6b",
    "kimi_k2_1t_a32b",
    "llama4_maverick_400b_a17b",
    "llama_3p2_vision_90b",
    "mamba2_1p3b",
]

# long_500k needs sub-quadratic context handling; run only for SSM/hybrid
# (see DESIGN.md §Arch-applicability).
LONG_CONTEXT_ARCHS = {"zamba2_2p7b", "mamba2_1p3b"}


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink to a same-family smoke-test config (CPU, one step)."""
    changes = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.family == "moe":
        changes.update(n_experts=8, top_k=min(cfg.top_k, 2),
                       n_dense_layers=min(cfg.n_dense_layers, 1),
                       dense_d_ff=256 if cfg.dense_d_ff else 0)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.attn_every:
        changes.update(attn_every=2)
    if cfg.block_pattern:
        changes.update(block_pattern="MEM*E", n_layers=5, ssm_heads=8,
                       ssm_groups=min(cfg.ssm_groups, 2),
                       shared_d_ff=256 if cfg.shared_d_ff else 0)
    if cfg.n_enc_layers:
        changes.update(n_enc_layers=2)
    if cfg.cross_attn_every:
        changes.update(cross_attn_every=2)
    if cfg.n_frontend_tokens:
        changes.update(n_frontend_tokens=16)
    return dataclasses.replace(cfg, **changes)


def cells(include_skips: bool = False) -> List[Tuple[str, str]]:
    """The dry-run grid: (arch_id, shape_name)."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                if include_skips:
                    out.append((arch, shape + ":SKIP"))
                continue
            out.append((arch, shape))
    return out
