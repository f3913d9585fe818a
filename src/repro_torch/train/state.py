"""A training run's ``(parameters, optimizer state)`` as the reference's
tree, for checkpoints.

The reference checkpoints ``(params, opt_state)``: pytrees whose leaves
stack the layers on leading axes. The port keeps one module per layer
and its optimizer state keyed by leaf name (`optim.optimizers.leaves`).
`reference_tree` lays both out as the reference's tree (nested dicts
with its keys, each leaf stacked on the host, member by member), so that
`checkpoint.Checkpointer` writes the reference's files and the
reference's ``Checkpointer`` restores them; `load_reference_tree` copies
such a tree back into a live model and state in place.
`TrainCheckpointer` does both around `Checkpointer`, so that
`dist.fault_tolerance.ResilientRunner` checkpoints and restores a live
``(model, opt_state)`` pair.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                 _flatten_with_paths)
from repro_torch.optim.optimizers import Leaf, leaves, named


def _nest(flat: Dict[str, Any]) -> dict:
    """``{"a.b.c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    out: dict = {}
    for name, value in flat.items():
        *head, last = name.split(".")
        node = out
        for key in head:
            node = node.setdefault(key, {})
        node[last] = value
    return out


def _flat(tree: dict, prefix: str = "") -> Dict[str, Any]:
    """The inverse of `_nest`."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def _host_leaf(leaf: Leaf, tensors: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """The leaf's tensor on the host: its members stacked there one at a
    time, so no stacked copy arises on the device."""
    first = tensors[leaf.members[0]]
    out = torch.empty(leaf.shape(tensors), dtype=first.dtype)
    for view, name in zip(leaf.views(out), leaf.members):
        view.copy_(tensors[name].detach())
    return out


def _state_value(value, fn):
    """``fn`` over a state entry: a tensor, or Adafactor's ``{"r", "c"}``
    / ``{"v"}`` dict of tensors."""
    if isinstance(value, dict):
        return {k: fn(v) for k, v in value.items()}
    return fn(value)


def reference_tree(params, opt_state: dict) -> Tuple[dict, dict]:
    """``(params, opt_state)`` in the reference's tree, on the host:
    parameters by leaf (``layers.attn.wq`` -> ``{"layers": {"attn":
    {"wq": (L, ...)}}}``), the state's entries by the same leaves under
    their keys (``{"m": {...}, "v": {...}}``, ``{"f": {leaf: {"r",
    "c"}}}``). Every tensor is a host copy the caller owns."""
    tensors = named(params)
    p = {leaf.name: _host_leaf(leaf, tensors) for leaf in leaves(tensors)}
    s = {key: _nest({name: _state_value(
        v, lambda t: t.detach().to("cpu", copy=True))
        for name, v in entries.items()})
        for key, entries in opt_state.items()}
    return _nest(p), s


def load_reference_tree(params, opt_state: dict, tree: Tuple[dict, dict]
                        ) -> None:
    """Copy a `reference_tree`-shaped ``tree`` (any device) into the
    parameters and the optimizer state in place."""
    tensors = named(params)
    p_tree, s_tree = tree
    flat = _flat(p_tree)
    with torch.no_grad():
        for leaf in leaves(tensors):
            leaf.scatter(tensors, flat[leaf.name])
        for key, entries in opt_state.items():
            for name, value in _flat(s_tree[key]).items():
                *head, last = name.split(".")
                if isinstance(entries.get(".".join(head)), dict):
                    entries[".".join(head)][last].copy_(value)
                else:
                    entries[name].copy_(value)


class TrainCheckpointer(Checkpointer):
    """A `Checkpointer` of a live ``(model, opt_state)`` pair: `save`
    writes its `reference_tree` (the reference's files, leaf for leaf);
    `restore` reads such a checkpoint back into the pair it is given, in
    place, and returns that pair. `ResilientRunner` drives it as the
    reference's runner drives its ``Checkpointer``; the pair is live, so
    a failure before the first checkpoint replays from the state as it
    then stands, not from the initial one."""

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        params, opt_state = tree
        self._submit(step, _flatten_with_paths(
            reference_tree(params, opt_state)), extra)

    def restore(self, like: Any, step: Optional[int] = None,
                devices: Optional[Any] = None):
        params, opt_state = like
        tensors = named(params)
        skeleton = (_nest({leaf.name: leaf.name
                           for leaf in leaves(tensors)}),
                    {key: _nest({name: _state_value(v, lambda t: name)
                                 for name, v in entries.items()})
                     for key, entries in opt_state.items()})
        step, tree, extra = super().restore(skeleton, step)
        load_reference_tree(params, opt_state, tree)
        return step, like, extra
