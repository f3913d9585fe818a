"""The benchmark's own counts of work: bytes a query must read, FLOPs a
model step must do.

They are worked out from the configuration and the traffic alone, never
from the program, so they count the same work whatever implements it:

* A query's bytes: for each queried column, the bit planes on which its
  constant-folded range predicate depends (found by brute force over the
  column's 2^b codes), times the bytes of one plane; a selection adds its
  result bitmap once.
* A dense decoder's FLOPs (PaLM, appendix B): 6 N per trained token, N
  every matrix that multiplies (the token table's lookup left out, the
  untied head in), plus the causal half of the attention products, 6 L H
  d_head S per token. A prefill: 2 N per prompt token without the head,
  the head once per sequence (only the last position's logits are
  produced), and 2 L H d_head S per token.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np


def plane_bytes(rows: int) -> int:
    """Bytes of one bit plane of ``rows`` values: 32-bit words."""
    return -(-rows // 32) * 4


def planes_needed(bits: int, lo: int, hi: int) -> int:
    """Bit planes on which ``lo <= v <= hi`` over ``bits``-bit codes
    depends: plane j counts where flipping bit j of some code changes the
    predicate."""
    v = np.arange(1 << bits)
    f = (v >= lo) & (v <= hi)
    return sum(1 for j in range(bits) if np.any(f != f[v ^ (1 << j)]))


def query_bytes(rows: int, bits: Mapping[str, int],
                ranges: Mapping[str, Tuple[int, int]], select: bool) -> int:
    """Bytes one conjunction of column ranges must move: the planes its
    predicate depends on, read once, plus the result bitmap written once
    when it is selected (materialized)."""
    planes = sum(planes_needed(bits[c], lo, hi)
                 for c, (lo, hi) in ranges.items())
    return (planes + (1 if select else 0)) * plane_bytes(rows)


def matrix_params(cfg: Mapping) -> Dict[str, int]:
    """Parameters of the matrices that multiply in a dense decoder
    (``configs/<model>.json`` keys): per layer and the head."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    layer = d * h * hd * 2 + d * kv * hd * 2 + 3 * d * f
    return {"layers": cfg["num_hidden_layers"] * layer,
            "head": d * cfg["vocab_size"]}


def attention_flops_per_token(cfg: Mapping, seq: int) -> int:
    """The causal attention products' forward FLOPs per token: 2 L H
    d_head S (QK^T and PV over half the S x S square)."""
    return (2 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * cfg["head_dim"] * seq)


def train_flops(cfg: Mapping, batch: int, seq: int) -> Dict[str, int]:
    """FLOPs of one optimizer step over ``batch`` sequences of ``seq``:
    the model's and the attention products' share of it."""
    p = matrix_params(cfg)
    tokens = batch * seq
    attention = 3 * attention_flops_per_token(cfg, seq) * tokens
    return {"model": 6 * (p["layers"] + p["head"]) * tokens + attention,
            "attention": attention}


def prefill_flops(cfg: Mapping, prompts: Sequence[int]) -> Dict[str, int]:
    """FLOPs of one prefill of prompts of the given lengths."""
    p = matrix_params(cfg)
    model = attention = 0
    for s in prompts:
        a = attention_flops_per_token(cfg, s) * s
        attention += a
        model += 2 * p["layers"] * s + 2 * p["head"] + a
    return {"model": model, "attention": attention}
