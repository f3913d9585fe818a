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

A mesh here is a `torch.distributed` `DeviceMesh` with named axes
(`launch.mesh`), or a mapping from axis name to size (``{"chip": 4}``)
where only the resolution is wanted; the result of `resolve_spec` is a
plain tuple, the counterpart of a JAX ``PartitionSpec``. The chip cluster
(`core.cluster`) resolves its ``(chip, bank, ...)`` layout through
`CLUSTER_RULES`.

The reference's ``NamedSharding(mesh, spec)`` is here ``(mesh,
placements)``: one DTensor `Placement` per mesh axis, ``Shard(d)`` where
the spec puts that axis on dimension ``d`` and ``Replicate()`` elsewhere
(`placements_of`; `spec_of` reads them back). `tree_shardings` gives the
placements of a tree of parameters or inputs, and `distribute` lays a
tree out on a `DeviceMesh` as DTensors.

`axis_rules` installs a (mesh, rules) context on a stack, as the
reference's does (one for the process here: the autograd engine's own
threads must see it); `resolve_spec` reads its rules when given none.
Under a `DeviceMesh` the context also enters DTensor's
``implicit_replication``: a plain tensor that meets a DTensor inside (a
position index, a mask, a zero) is taken as replicated over the mesh, as
a constant is under the reference's ``jit``. `constrain` is the identity
(the same object) outside a context with a mesh; under a `DeviceMesh` it
redistributes a DTensor to the placements ``resolve_spec`` gives (the
reference's ``with_sharding_constraint``).
"""
from __future__ import annotations

import contextlib
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

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

#: the contexts, innermost last: one stack for the process, not one a
#: thread as the reference's, since the autograd engine runs a CUDA
#: backward (and in it a checkpointed block's recomputed forward) on a
#: thread of its own, which must see the mesh the forward saw
_STACK: List[Tuple[Any, Optional[Rules]]] = []


def _stack() -> List[Tuple[Any, Optional[Rules]]]:
    return _STACK


Mesh = Union[DeviceMesh, Mapping[str, int]]


@contextlib.contextmanager
def axis_rules(mesh: Optional[Mesh] = None,
               rules: Optional[Rules] = None) -> Iterator[None]:
    """Install (mesh, rules) for `constrain` / `current_mesh` /
    `current_rules`; a mesh without rules takes `DEFAULT_RULES`. Under a
    `DeviceMesh`, plain tensors that meet DTensors inside are taken as
    replicated (`implicit_replication`).

    `axis_rules(None)` pushes a *disabled* context: constraints inside are
    the identity even if an outer context is active.
    """
    if mesh is not None and rules is None:
        rules = DEFAULT_RULES
    _stack().append((mesh, rules))
    try:
        if isinstance(mesh, DeviceMesh):
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _stack().pop()


@contextlib.contextmanager
def implicit_replication() -> Iterator[None]:
    """DTensor's ``implicit_replication`` (a plain tensor that meets a
    DTensor is taken as replicated), safe to nest: DTensor's own context
    turns the switch off on exit even inside an outer one."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def current_mesh() -> Optional[Mesh]:
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


def mesh_sizes(mesh: Mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def resolve_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                 mesh: Mesh, rules: Optional[Rules] = None
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
    mesh = mesh_sizes(mesh)
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


def _axes(entry: AxisSpec) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_of(spec: Sequence[AxisSpec], mesh: Mesh
                  ) -> Tuple[Placement, ...]:
    """One `Placement` per mesh axis for a resolved ``spec``: ``Shard(d)``
    for the axes the spec puts on dimension ``d``, ``Replicate()`` for the
    rest. A dimension on several axes (``("pod", "data")``) is split over
    them in mesh order, as DTensor splits it."""
    names = list(mesh_sizes(mesh))
    out: List[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def spec_of(placements: Sequence[Placement], mesh: Mesh,
            ndim: int) -> Tuple[AxisSpec, ...]:
    """The spec tuple ``placements`` (one per mesh axis) stand for: the
    inverse of `placements_of`. Raises on a ``Partial`` placement, which
    no spec names."""
    per_dim: List[List[str]] = [[] for _ in range(ndim)]
    for name, p in zip(mesh_sizes(mesh), placements):
        if isinstance(p, Shard):
            per_dim[p.dim % max(ndim, 1)].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"{p} on axis {name!r} is not a sharding")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per_dim)


def constrain(x, *names: Optional[str]):
    """``x`` itself outside an `axis_rules` context with a mesh (the
    reference's identity there). Under a `DeviceMesh`, ``x`` redistributed
    to the placements of ``resolve_spec(x.shape, names)`` (the reference's
    ``with_sharding_constraint``): a plain tensor is taken as replicated
    first. A mesh of axis sizes alone places nothing and raises."""
    mesh, rules = _stack()[-1] if _stack() else (None, None)
    if mesh is None or rules is None:
        return x
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"constrain{tuple(names)} places tensors on a "
                         f"DeviceMesh; {dict(mesh)} only names axis sizes")
    want = placements_of(resolve_spec(x.shape, names, mesh, rules), mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def strip_axes(rules: Rules, axes: Sequence[str]) -> Rules:
    """Rules with the given physical axes removed from every entry."""
    drop = set(axes)
    return {k: tuple(a for a in v if a not in drop) for k, v in rules.items()}


def _flat(tree: Any) -> Dict[str, Any]:
    """Name -> leaf of a module's parameters or of a nested dict (nested
    keys joined by ``.``)."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": x for n, x in _flat(v).items()})
        else:
            out[k] = v
    return out


def tree_shardings(shapes: Any, specs: Any, mesh: Mesh,
                   rules: Optional[Rules] = None) -> Dict[str, Any]:
    """The placements (`placements_of`) of every leaf of ``shapes``: a
    module's parameters, or a nested dict of tensors (nested names joined
    with ``.``), given the logical names ``specs`` of each (a dict by the
    same names, nested alike; a None spec replicates). Returns name ->
    placements; ``rules=None`` takes the context's, else `DEFAULT_RULES`
    (the reference's `tree_shardings`, with ``(mesh, placements)`` for
    its ``NamedSharding``)."""
    if rules is None:
        rules = current_rules() or DEFAULT_RULES
    leaves, names = _flat(shapes), _flat(specs)
    if set(leaves) != set(names):
        raise ValueError(f"the specs do not name the leaves: "
                         f"{sorted(set(leaves) ^ set(names))[:8]}")
    out = {}
    for n, leaf in leaves.items():
        shape = tuple(leaf.shape)
        spec = names[n] if names[n] is not None else (None,) * len(shape)
        out[n] = placements_of(resolve_spec(shape, spec, mesh, rules), mesh)
    return out


def distribute(x: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Placement]) -> DTensor:
    """``x`` (the same whole tensor on every rank) as a DTensor with
    ``placements``: each rank keeps its own slice, nothing is sent."""
    return distribute_tensor(x, mesh, list(placements), src_data_rank=None)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (its pending sums reduced, its shards
    gathered); a plain tensor itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def match_vma(x: Any, ref: Any) -> Any:
    """``x`` itself. The reference marks loop carries inside a
    ``shard_map`` as varying over the manual axes ``ref`` varies over (JAX's
    vma typing); a DTensor carries its placements with it and has no such
    typing, so nothing is needed here."""
    return x
