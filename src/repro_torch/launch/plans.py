"""Per-(arch x shape) execution plans: optimizer, microbatching, remat.

The counterpart of `repro.launch.plans`, field for field: `plan_for`
gives each cell of `configs.base.cells` the reference's plan, so that
``dataclasses.asdict`` of the two agree. ``grad_accum`` splits a training
step's global batch into microbatches, which bounds the activations one
microbatch keeps; the largest models take Adafactor (factored second
moments), whose state is a fraction of Adam's. The fields that choose
sharding (``rules``, ``moe_constrain``, ``compressed_dp``) and the
reference's attention knobs (``attn_remat``, ``attn_kernel``) are carried
as the reference sets them; the port reads them once the mesh lands
(ROADMAP A8b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class CellPlan:
    arch: str
    shape: str
    optimizer: str = "adamw"      # adamw | adafactor | signum
    grad_accum: int = 1
    remat: str = "block"          # block | dots | full
    rules: str = "default"        # default | sp (sequence-parallel) | dp
    attn_remat: bool = True       # q-row checkpoint (reference layers)
    attn_kernel: str = "chunked"  # chunked | flash (reference backends)
    compressed_dp: bool = False   # 1-bit majority-vote gradient exchange
    moe_constrain: bool = False   # force expert sharding constraints
    notes: str = ""


_OPT: Dict[str, str] = {
    "kimi_k2_1t_a32b": "adafactor",
    "llama4_maverick_400b_a17b": "adafactor",
}

_ACCUM: Dict[str, int] = {
    # train_4k (1.05M global tokens/step): keep microbatch activations and
    # MoE dispatch buffers per chip in the low-GB range.
    "zamba2_2p7b": 2,
    "seamless_m4t_medium": 1,
    "qwen3_8b": 4,
    "deepseek_67b": 8,
    "qwen1p5_110b": 8,
    "qwen3_0p6b": 1,
    "kimi_k2_1t_a32b": 16,
    "llama4_maverick_400b_a17b": 8,
    "llama_3p2_vision_90b": 8,
    "mamba2_1p3b": 2,
}


def plan_for(cfg: ModelConfig, shape: ShapeConfig,
             overrides: Optional[dict] = None) -> CellPlan:
    arch = cfg.name.replace("-", "_").replace(".", "p")
    kw = dict(
        arch=arch, shape=shape.name,
        optimizer=_OPT.get(arch, "adamw"),
        grad_accum=_ACCUM.get(arch, 1) if shape.kind == "train" else 1,
        remat="block",
        rules="default",
        attn_remat=shape.kind == "train",
    )
    kw.update(overrides or {})
    return CellPlan(**kw)
