"""Majority-vote 1-bit signSGD ("signum"): the paper's triple-row
activation lifted to the data-parallel collective.

The counterpart of `repro.optim.signum`. Per worker: ``u = grad +
error feedback``, a scale ``mean |u|`` per leaf (averaged over the
workers), and the signs of ``u``. With a process group the signs travel
packed 32 to a word (`kernels.ops.pack_signs`), and `majority_allreduce`
reduces them with the bitwise majority kernel (`kernels.ops.majority`)
between an all-to-all and an all-gather, so about N / 8 + N / 8 bytes
cross the wire per worker against 4 N for a float32 ring all-reduce.
Without one (the reference's ``axis_name=None``) the step is the local
sign step. The two use different sign rules, as the reference's do: the
local step takes ``u >= 0`` as +1 (-0.0 -> +1, NaN -> -1), the packed
path the IEEE sign bit (-0.0 -> -1).

The update: ``err = u - scale * s``, ``mu = momentum * mu + scale * s``,
``p -= lr * (mu + wd * p)``. ``mean |u|`` is taken over each of the
reference's leaves, so over all layers of a stacked one
(`optim.optimizers.leaves`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops
from repro_torch.optim.optimizers import (Optimizer, _each_leaf, _f32,
                                          _zeros)


def _flatten(tree, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) of a nested dict of tensors, keys sorted at every
    level (the reference's pytree order)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _flatten(tree[k], prefix + (k,))
    return out


def _unflatten(paths: List[Tuple[str, ...]], values: List[torch.Tensor]):
    if paths == [()]:
        return values[0]
    tree: Dict[str, Any] = {}
    for path, v in zip(paths, values):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def pack_tree(tree) -> Tuple[torch.Tensor, tuple]:
    """A tensor or nested dict of float tensors -> (packed (1, W) int32
    sign words, meta for `unpack_tree`): the leaves flattened in sorted
    key order, cast to float32, concatenated and zero-padded to a
    multiple of 32 lanes (+0.0: sign bit 0)."""
    items = _flatten(tree)
    flat = [x.reshape(-1).float() for _, x in items]
    cat = torch.cat(flat) if len(flat) > 1 else flat[0]
    n = cat.shape[0]
    pad = -n % 32
    if pad:
        cat = torch.nn.functional.pad(cat, (0, pad))
    packed = kops.pack_signs(cat.reshape(1, n + pad))
    meta = ([p for p, _ in items], [f.shape[0] for f in flat],
            [x.shape for _, x in items], [x.dtype for _, x in items], n)
    return packed, meta


def unpack_tree(packed: torch.Tensor, meta: tuple):
    """(1, W) packed signs -> a tree of {+1, -1} tensors shaped and typed
    like the one `pack_tree` packed."""
    paths, sizes, shapes, dtypes, n = meta
    flat = kops.unpack_signs(packed).reshape(-1)[:n]
    out, off = [], 0
    for size, shape, dtype in zip(sizes, shapes, dtypes):
        out.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    return _unflatten(paths, out)


def majority_allreduce(packed: torch.Tensor,
                       group: Optional[dist.ProcessGroup] = None
                       ) -> torch.Tensor:
    """Bitwise-majority all-reduce of (1, W) int32 packed sign words over
    ``group`` (None: the default group). The words are padded to a
    multiple of the world size D; an all-to-all gives each worker its
    1 / D of every worker's words, the majority kernel votes over the D
    copies (`kernels.ops.majority`, threshold D // 2 + 1), and an
    all-gather returns the (1, W) result to every worker."""
    D = dist.get_world_size(group)
    W = packed.shape[-1]
    Wp = -(-W // D) * D
    if Wp != W:
        packed = torch.nn.functional.pad(packed, (0, Wp - W))
    shards = packed.reshape(D, Wp // D).contiguous()
    recv = torch.empty_like(shards)          # row d: worker d's shard
    dist.all_to_all_single(recv, shards, group=group)
    mine = kops.majority(recv[:, None, :])[0]
    full = torch.empty(Wp, dtype=packed.dtype, device=packed.device)
    dist.all_gather_into_tensor(full, mine.contiguous(), group=group)
    return full[None, :W]


def signum(lr_fn, momentum: float = 0.9, weight_decay: float = 0.0,
           group: Optional[dist.ProcessGroup] = None,
           error_feedback: bool = True) -> Optimizer:
    """Majority-vote signSGD over the process ``group`` (for the whole
    world, ``torch.distributed.group.WORLD``); ``group=None`` is the local
    sign step of one worker (the reference's ``axis_name=None``)."""

    def init(params):
        st = {"mu": _zeros(params, torch.float32)}
        if error_feedback:
            st["err"] = _zeros(params, torch.float32)
        return st

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _f32(lr_fn(step))
        items = list(_each_leaf(grads, params))
        u = {}
        for leaf, g, _, _ in items:
            u[leaf.name] = g.float()
            if error_feedback:
                u[leaf.name] = u[leaf.name] + state["err"][leaf.name]
        names = list(u)
        scales = torch.stack([u[k].abs().mean() for k in names])
        if group is not None:
            dist.all_reduce(scales, group=group)
            scales = scales / dist.get_world_size(group)
            packed, meta = pack_tree(u)
            signs = unpack_tree(majority_allreduce(packed, group), meta)
        else:
            signs = {k: torch.where(x >= 0, 1.0, -1.0) for k, x in u.items()}
        scale = dict(zip(names, scales))
        new = dict(state)
        if error_feedback:
            new["err"] = {k: u[k] - scale[k] * signs[k] for k in names}
        new["mu"] = {k: momentum * state["mu"][k] + scale[k] * signs[k]
                     for k in names}
        for leaf, _, p, tensors in items:
            p32 = p.float()
            leaf.scatter(tensors, (p32 - lr * (new["mu"][leaf.name]
                                               + weight_decay * p32))
                         .to(p.dtype))
        return params, new

    return Optimizer(init, update, "signum")
