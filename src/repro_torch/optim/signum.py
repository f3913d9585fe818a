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

On a mesh (`launch.cells` with ``compressed_dp``) the parameters are
DTensors sharded over the model axis and replicated over the data axes,
whose process group is ``group``: ``mean |u|`` is a DTensor reduction
over the model shards, and each rank packs and votes on its own shards,
which line up with the same shards of the other data ranks (the
reference's ``shard_map`` over the data axes with the model axis left to
GSPMD).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import implicit_replication, local, whole
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
    # into D views of one buffer: the list form is there in 2.11 and 2.13
    # alike (2.13 deprecates all_gather_into_tensor)
    dist.all_gather(list(full.chunk(D)), mine.contiguous(), group=group)
    return full[None, :W]


def _as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s layout where both are DTensors."""
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(
            like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def _as_shard(shard: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``shard`` (this rank's) in DTensor ``like``'s layout."""
    if not isinstance(like, DTensor):
        return shard
    return DTensor.from_local(shard, like.device_mesh, like.placements,
                              run_check=False)


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
        # a leaf's scale (a plain scalar) meets its DTensor signs on a mesh
        with implicit_replication():
            return _update(grads, state, params, step)

    def _update(grads, state, params, step):
        lr = _f32(lr_fn(step))
        items = list(_each_leaf(grads, params))
        u = {}
        for leaf, g, _, _ in items:
            u[leaf.name] = _as(g.float(), state["mu"][leaf.name])
            if error_feedback:
                u[leaf.name] = u[leaf.name] + state["err"][leaf.name]
        names = list(u)
        scales = torch.stack([whole(u[k].abs().mean()) for k in names])
        if group is not None:
            dist.all_reduce(scales, group=group)
            scales = scales / dist.get_world_size(group)
            packed, meta = pack_tree({k: local(x) for k, x in u.items()})
            voted = unpack_tree(majority_allreduce(packed, group), meta)
            signs = {k: _as_shard(voted[k], u[k]) for k in names}
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
