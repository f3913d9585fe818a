"""Roofline analysis of one (arch x shape x mesh) cell from its counted cost.

The counterpart of `repro.launch.roofline`. Three terms per cell, all in
seconds, against the card's peaks (`repro_torch.hw`):

    compute    = FLOPs / (chips x dense bf16 FLOP/s)
    memory     = bytes / (chips x device-memory bytes/s)
    collective = collective_bytes / (chips x NVLink bytes/s each way)

FLOPs and bytes come from `launch.hlocost.count` of the cell's step on
``meta`` (the reference parses them from a compiled step's HLO; its
``collective_stats`` parses collectives out of HLO text and has no
counterpart here). MODEL_FLOPS is the analytic useful-work number (6·N·D
train, 2·N·D forward, N_active for MoE); its ratio against the counted
FLOPs exposes remat recompute and routing / dispatch waste.
`useful_flops` is the same less what no product computes (the token
table's lookup; in a prefill the head at all but the last position): the
yardstick for a measured share of the card's peak, which ``model_flops``
overstates past 1 for a prefill of a shallow cut.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch import hw
from repro_torch.configs.base import ModelConfig, ShapeConfig


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (train) / 2·N·D (fwd) with N = active params, D = tokens.
    For enc-dec the encoder weights see only the frame tokens, so N·D splits
    into N_dec·T_text + N_enc·T_frames (otherwise seamless would report a
    'useful ratio' > 1)."""
    n = cfg.param_count(active_only=(cfg.family == "moe"))
    mult = 6.0 if shape.kind == "train" else 2.0
    if shape.kind == "decode":
        return mult * n * shape.global_batch
    t_text = shape.global_batch * shape.seq_len
    if cfg.family == "encdec":
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        mlp = (3 if cfg.mlp_kind == "swiglu" else 2) * D * cfg.d_ff
        n_enc = cfg.n_enc_layers * (attn + mlp)
        t_frames = shape.global_batch * cfg.n_frontend_tokens
        return mult * ((n - n_enc) * t_text + n_enc * t_frames)
    return mult * n * t_text


def useful_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """`model_flops` less the FLOPs it charges that no product computes:
    the token table (``padded_vocab x d_model`` of N) is a lookup at every
    position, and in a prefill the head runs at each sequence's last
    position only (every family's prefill returns the last position's
    logits), not at all of them. At most `model_flops`; equal to it less
    the table's share for train and decode."""
    table = cfg.padded_vocab * cfg.d_model
    mult = 6.0 if shape.kind == "train" else 2.0
    rows = shape.global_batch
    if shape.kind != "decode":
        rows *= shape.seq_len
    out = model_flops(cfg, shape) - mult * table * rows
    if shape.kind == "prefill":
        out -= mult * table * (rows - shape.global_batch)
    return out


@dataclasses.dataclass
class Roofline:
    """The reference's fields, properties and ``to_dict`` keys (``hlo_*``
    name the counted FLOPs and bytes), priced against ``card``."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_by_kind: Dict[str, Dict[str, float]]
    model_flops_: float
    bytes_per_device: Optional[float] = None
    dot_bytes: float = 0.0
    card: hw.Card = hw.H100_SXM

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.card.bf16_flops_per_s)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.card.hbm_bytes_per_s)

    @property
    def t_memory_floor(self) -> float:
        """Product-attributed traffic only: the memory term if everything
        but the products were fused away."""
        return self.dot_bytes / (self.chips * self.card.hbm_bytes_per_s)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips
                                        * self.card.nvlink_bytes_per_s)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_ / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term bound that is useful model compute:
        (MODEL_FLOPS / chips / peak) / max(term). 1.0 = the step takes
        exactly as long as the useful flops at peak — the roofline."""
        t_use = self.model_flops_ / (self.chips * self.card.bf16_flops_per_s)
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_use / t_step if t_step else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": self.collective_by_kind,
            "model_flops": self.model_flops_,
            "bytes_per_device": self.bytes_per_device,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_memory_floor_s": self.t_memory_floor,
            "dot_bytes": self.dot_bytes,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(cost, cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
            chips: int, arch: str, bytes_per_device: Optional[float] = None,
            card: Optional[hw.Card] = None) -> Roofline:
    """The `Roofline` of a step whose `launch.hlocost.Cost` is ``cost``
    (the whole step over ``chips`` devices: on a mesh, the count of the
    cell's DTensor step, each term then divided by ``chips``).
    ``bytes_per_device`` is what one device holds: the parameters,
    optimizer state and inputs of the count (`hlocost.tensor_bytes`; the
    reference reads the compiled step's memory analysis).
    ``card`` defaults to the card in use (`hw.current`); price a count on
    the host against a named row (`hw.lookup`)."""
    coll = {k: {"count": v} for k, v in cost.collective_ops.items()}
    return Roofline(arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
                    hlo_flops=cost.flops, hlo_bytes=cost.bytes,
                    collective_bytes=cost.collective_bytes,
                    collective_by_kind=coll,
                    model_flops_=model_flops(cfg, shape),
                    bytes_per_device=bytes_per_device,
                    dot_bytes=cost.dot_bytes,
                    card=card if card is not None else hw.current())
