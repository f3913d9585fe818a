"""Logical-axis sharding rules resolved against a mesh of named axes.

Tensors are annotated with *logical* dimension names ("chip", "bank",
"batch", "heads", ...). A rules table maps each logical name to an ordered
tuple of candidate *physical* mesh axes; `resolve_spec` turns (shape,
names, mesh, rules) into one physical axis (or tuple of axes, or None) per
dimension, with two safety properties:

  * divisibility fallback — a dimension that a candidate axis does not
    divide evenly is replicated rather than unevenly sharded (so batch=1
    decode or kv_heads < model-parallelism never produce invalid specs);
  * no axis reuse — one physical axis shards at most one dimension of a
    given tensor (first logical name wins, later ones replicate).

A mesh here is a mapping from axis name to size (``{"chip": 4}``); the
result is a plain tuple, the counterpart of a JAX ``PartitionSpec``. The
chip cluster (`core.cluster`) resolves its ``(chip, bank, ...)`` layout
through `CLUSTER_RULES`.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

Rules = Dict[str, Tuple[str, ...]]
#: one dimension's physical placement: an axis, a tuple of axes, or None
AxisSpec = Union[None, str, Tuple[str, ...]]

# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------

# bulk-bitwise cluster execution (core/cluster.py): the word-shard "chip"
# axis maps onto the physical chip axis; the per-chip "bank" axis stays a
# local batch dimension (banks never leave their chip — a Buddy op is
# contained in one subarray). DEFAULT_RULES folds it in.
CLUSTER_RULES: Rules = {"chip": ("chip",), "bank": ()}

DEFAULT_RULES: Rules = {
    **CLUSTER_RULES,
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": (),
    "embed_act": (),
    # params
    "fsdp": ("data",),
    "embed": (),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "kv_flat": ("model",),
    "head_dim": (),
    "vocab": ("model",),
    "experts": ("model",),
    "state": (),
    "conv": (),
    "conv_w": (),
    "conv_b": (),
    "groups": (),
    "patches": (),
}

# data-parallel-only: params replicated across the dp axes.
DP_RULES: Rules = {**DEFAULT_RULES, "fsdp": ()}

# sequence parallelism: long-context activations shard their seq dim.
SP_RULES: Rules = {**DEFAULT_RULES, "seq": ("model",)}

# decode-time sequence parallelism: the KV cache shards over model.
DECODE_SP_RULES: Rules = {**DEFAULT_RULES, "kv_seq": ("model",),
                          "kv_flat": ("model",)}


def resolve_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                 mesh: Mapping[str, int], rules: Optional[Rules] = None
                 ) -> Tuple[AxisSpec, ...]:
    """Resolve logical dim names to one physical placement per dimension.

    Per dimension: walk the rule's candidate axes in order, taking each
    axis that (a) exists in the mesh, (b) is not already used by an
    earlier dimension of this tensor, and (c) keeps the dimension evenly
    divisible by the product of taken axis sizes. No taken axes (or name
    None / unknown) -> None (replicated).
    """
    if rules is None:
        rules = DEFAULT_RULES
    used: set = set()
    out: List[AxisSpec] = []
    for dim, name in zip(shape, names):
        if name is None:
            out.append(None)
            continue
        axes = rules.get(name, ())
        if isinstance(axes, str):
            axes = (axes,)
        taken: List[str] = []
        prod = 1
        for a in axes:
            if a not in mesh or a in used:
                continue
            if dim % (prod * mesh[a]) != 0:
                continue  # this axis doesn't divide; later ones may
            taken.append(a)
            prod *= mesh[a]
        used.update(taken)
        if not taken:
            out.append(None)
        elif len(taken) == 1:
            out.append(taken[0])
        else:
            out.append(tuple(taken))
    return tuple(out)
