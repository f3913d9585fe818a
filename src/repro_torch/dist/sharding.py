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

`axis_rules` installs a (mesh, rules) context on a per-thread stack, as
the reference's does; `resolve_spec` reads its rules when given none, and
`constrain` is the identity (the same object) outside a context with a
mesh. Inside one it raises: applying a placement to a tensor needs the
`torch.distributed` mesh of ROADMAP A8b.
"""
from __future__ import annotations

import contextlib
import threading
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple, Union)

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


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

_CTX = threading.local()


def _stack() -> List[Tuple[Any, Optional[Rules]]]:
    if not hasattr(_CTX, "stack"):
        _CTX.stack = []
    return _CTX.stack


@contextlib.contextmanager
def axis_rules(mesh: Optional[Mapping[str, int]] = None,
               rules: Optional[Rules] = None) -> Iterator[None]:
    """Install (mesh, rules) for `constrain` / `current_mesh` /
    `current_rules` in this thread; a mesh without rules takes
    `DEFAULT_RULES`.

    `axis_rules(None)` pushes a *disabled* context: constraints inside are
    the identity even if an outer context is active.
    """
    if mesh is not None and rules is None:
        rules = DEFAULT_RULES
    _stack().append((mesh, rules))
    try:
        yield
    finally:
        _stack().pop()


def current_mesh() -> Optional[Mapping[str, int]]:
    """Mesh of the innermost `axis_rules` context (None if disabled or
    absent)."""
    s = _stack()
    return s[-1][0] if s else None


def current_rules() -> Optional[Rules]:
    """Rules of the innermost `axis_rules` context (None if disabled or
    absent)."""
    s = _stack()
    return s[-1][1] if s else None


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------


def resolve_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                 mesh: Mapping[str, int], rules: Optional[Rules] = None
                 ) -> Tuple[AxisSpec, ...]:
    """Resolve logical dim names to one physical placement per dimension.

    Per dimension: walk the rule's candidate axes in order, taking each
    axis that (a) exists in the mesh, (b) is not already used by an
    earlier dimension of this tensor, and (c) keeps the dimension evenly
    divisible by the product of taken axis sizes. No taken axes (or name
    None / unknown) -> None (replicated). ``rules=None`` takes the
    innermost `axis_rules` context's, else `DEFAULT_RULES`.
    """
    if rules is None:
        rules = current_rules() or DEFAULT_RULES
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


def constrain(x, *names: Optional[str]):
    """``x`` itself outside an `axis_rules` context with a mesh (the
    reference's identity there). With a mesh the reference applies
    ``resolve_spec(x.shape, names)`` as a sharding constraint; the port
    raises until the mesh of ROADMAP A8b places tensors."""
    mesh, rules = _stack()[-1] if _stack() else (None, None)
    if mesh is None or rules is None:
        return x
    raise NotImplementedError(
        f"constrain{tuple(names)} under the mesh {dict(mesh)}: placing "
        "tensors on a mesh waits for the DeviceMesh of ROADMAP A8b")


def strip_axes(rules: Rules, axes: Sequence[str]) -> Rules:
    """Rules with the given physical axes removed from every entry."""
    drop = set(axes)
    return {k: tuple(a for a in v if a not in drop) for k, v in rules.items()}
