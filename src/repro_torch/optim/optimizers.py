"""Optimizers in the reference's functional form, updating in place.

The counterpart of `repro.optim.optimizers`. An `Optimizer` is ``(init,
update)``: ``state = init(params)`` and ``params, state = update(grads,
state, params, step)``, where ``params`` is an `nn.Module` (or a dict of
tensors), ``grads`` a dict keyed by its parameter names, and ``step`` the
step index that the schedules read. The update writes the new values
into the parameters and the state in place under `torch.no_grad` (the
reference returns new arrays) and returns both: a step holds one copy of
the state, not the old and the new.

Per-leaf statistics follow the reference's parameter tree, whose blocks
are stacked on leading layer axes: the port keeps one module per layer,
so `leaves` groups ``layers.<i>.<name>`` into one leaf ``layers.<name>``
of shape ``(L, ...)``, and a name with two layer indices (Zamba2's
``groups.<g>.<j>.<name>``, the VLM's ``groups.<g>.self.<j>.<name>``) into
one leaf of shape ``(G, A, ...)`` (``groups.<name>``,
``groups.self.<name>``). The state is keyed by leaf and shaped like the
reference's (`convert.opt_state_from_reference` carries it across).
Adafactor's update-RMS clip (and signum's ``mean |u|``) are taken over
all the layers of a leaf at once, and adafactor factors the stacked ``(L,
D)`` norm scales, exactly as the reference does. The elementwise updates
(SGD, AdamW, and adafactor's within one layer) run one layer at a time
on views of the stacked state, so that no stacked copy of a leaf (5.8 GB
in float32 for Zamba2-2.7B's ``groups.ssm.in_proj``) arises beside it.
Within a layer, a parameter of more than `CHUNK_ELEMS` elements is
updated in slices along its leading axis (the MoE experts' ``wi``, 21.5
GB in float32 for Maverick's 64 experts, would otherwise take several
float32 copies at once), and `clip_by_global_norm` scales the gradients
in place the same way; only the order of the float32 norm and RMS sums
changes with the slicing.

On a mesh (`launch.cells`) the parameters and gradients are DTensors.
The state then is DTensors too, laid out as the parameters (a stacked
leaf's on its shifted dims, adafactor's row and column statistics on the
dims they keep, as the reference's `launch.cells._opt_shardings` lays
them out). SGD and AdamW update each rank's local shards, where slicing
reads no other rank; the clip, adafactor and signum run DTensor
operations whole, which reduce over the shards where they must.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

Tree = Dict[str, torch.Tensor]

@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable        # params -> state
    update: Callable      # (grads, state, params, step) -> (params, state)
    name: str = "opt"


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's parameter tree: a parameter, or the
    per-layer parameters (``members``, in layer order, the last layer
    index fastest) of a leaf the reference stacks on leading layer axes
    of sizes ``grid`` (``()`` for an unstacked parameter)."""

    name: str
    members: Tuple[str, ...]
    grid: Tuple[int, ...]

    @property
    def stacked(self) -> bool:
        return bool(self.grid)

    def shape(self, tensors: Mapping[str, torch.Tensor]) -> torch.Size:
        """The leaf's shape: ``grid`` then a member's."""
        return torch.Size(self.grid + tuple(tensors[self.members[0]].shape))

    def views(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``x`` (the leaf's shape, contiguous) as one view per member, in
        member order: writing a view writes ``x``."""
        if not self.grid:
            return (x,)
        return x.view(-1, *x.shape[len(self.grid):]).unbind(0)

    def gather(self, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The leaf's tensor: the members stacked to ``grid + shape`` (a
        copy) or the one member itself."""
        xs = [tensors[m] for m in self.members]
        if not self.grid:
            return xs[0]
        return torch.stack(xs).reshape(*self.grid, *xs[0].shape)

    def scatter(self, tensors: Mapping[str, torch.Tensor],
                value: torch.Tensor) -> None:
        """Copy ``value`` (the leaf's shape) into its members in place."""
        parts = (value.reshape(-1, *value.shape[len(self.grid):]).unbind(0)
                 if self.grid else (value,))
        for m, x in zip(self.members, parts):
            tensors[m].copy_(x)


def named(params) -> Tree:
    """Parameter name -> tensor of an `nn.Module` or a dict of tensors."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def leaves(names) -> List[Leaf]:
    """The reference's leaves over parameter ``names``, in its tree order
    (dict keys sorted at every level): the names that differ only in
    their layer indices (the all-digit parts) form one leaf, named
    without them and stacked on one axis per index: ``layers.<i>.<rest>``
    forms ``layers.<rest>``, ``groups.<g>.<j>.<rest>`` ``groups.<rest>``,
    and the MoE family's ``lead.<i>.<rest>``, ``groups.<g>.dense.<j>.
    <rest>`` and ``groups.<g>.moe.<rest>`` its ``lead.<rest>`` (``(n_lead,
    ...)``), ``groups.dense.<rest>`` (``(G, moe_every - 1, ...)``) and
    ``groups.moe.<rest>`` (``(G, ...)``). Raises unless each leaf's
    indices fill its grid."""
    groups: Dict[str, List[Tuple[Tuple[int, ...], str]]] = {}
    for n in names:
        parts = n.split(".")
        index = tuple(int(p) for p in parts if p.isdigit())
        key = ".".join(p for p in parts if not p.isdigit())
        groups.setdefault(key, []).append((index, n))
    out = []
    for key in sorted(groups, key=lambda k: tuple(k.split("."))):
        members = sorted(groups[key])
        grid = tuple(max(i[a] for i, _ in members) + 1
                     for a in range(len(members[0][0])))
        if [i for i, _ in members] != list(
                itertools.product(*(range(g) for g in grid))):
            raise ValueError(f"the layers of {key!r} do not fill a "
                             f"{grid} grid: no reference leaf stacks them")
        out.append(Leaf(key, tuple(n for _, n in members), grid))
    return out


def _f32(x) -> float:
    """A Python float holding a float32 value (the reference's schedules
    and bias corrections run in float32)."""
    return float(np.float32(x))


#: the most elements of a parameter that the optimizers and the clip
#: take at once: a larger one is taken in slices along its leading axis,
#: so that its float32 temporaries stay near 256 MB each
CHUNK_ELEMS = 1 << 26


def _row_slices(x: torch.Tensor) -> list:
    """Indices of ``x`` along its leading axis, each of at most
    `CHUNK_ELEMS` elements and at least one row: ``[...]`` (the whole)
    when it fits, and for a DTensor (a slice of a sharded axis would
    gather it)."""
    if x.dim() == 0 or x.numel() <= CHUNK_ELEMS or isinstance(x, DTensor):
        return [...]
    rows = max(1, CHUNK_ELEMS // x[0].numel())
    return [slice(i, i + rows) for i in range(0, x.shape[0], rows)]


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient in place by ``min(1, max_norm / ||grads||)``
    (float32 norm over all of them, scale applied in float32, cast back to
    each gradient's dtype), slice by slice (`_row_slices`), so that no
    float32 copy of a large gradient and no second set of gradients
    arises; returns (``grads`` itself, the norm before clipping)."""
    total = 0
    for g in grads.values():
        for s in _row_slices(g):
            c = g[s].float()
            total = total + (c * c).sum()
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        for s in _row_slices(g):
            c = g[s]
            c.copy_((c.float() * scale).to(c.dtype))
    return grads, gn


def _leaf_zeros(leaf: Leaf, tensors: Tree, dtype=None, drop=None
                ) -> torch.Tensor:
    """Zeros of ``leaf``'s shape less its axis ``drop`` (if given), in
    ``dtype`` (default the parameter's), beside the parameter: for a
    DTensor parameter a DTensor sharded on the same axes (shifted past
    the stacking axes; an axis sharded on ``drop`` is replicated)."""
    p = tensors[leaf.members[0]]
    shape = list(leaf.shape(tensors))
    if drop is not None:
        drop %= len(shape)
        del shape[drop]
    dtype = dtype or p.dtype
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    from torch.distributed.tensor import zeros

    from repro_torch.dist.sharding import distribute
    placements = []
    for q in p.placements:
        d = q.dim + len(leaf.grid) if isinstance(q, Shard) else None
        if d is None or d == drop:
            placements.append(Replicate())
        else:
            placements.append(Shard(d - (drop is not None and d > drop)))
    if p.to_local().is_meta:        # an abstract cell: nothing allocated
        return distribute(torch.zeros(shape, dtype=dtype, device="meta"),
                          p.device_mesh, placements)
    return zeros(shape, dtype=dtype, device_mesh=p.device_mesh,
                 placements=placements)


def _zeros(params, dtype=None) -> Tree:
    tensors = named(params)
    return {leaf.name: _leaf_zeros(leaf, tensors, dtype)
            for leaf in leaves(tensors)}


def _on_shards(fn: Callable, p: torch.Tensor, *xs: torch.Tensor) -> None:
    """``fn(p, *xs)``; for a DTensor ``p``, on this rank's shards (`_local`)
    and, under a count, charged once for each shard that splits ``p``."""
    if not isinstance(p, DTensor):
        return fn(p, *xs)
    from repro_torch.launch.hlocost import per_shard
    n = 1
    for q, size in zip(p.placements, p.device_mesh.shape):
        n *= size if isinstance(q, Shard) else 1
    return per_shard(fn, n)(*_local(p, *xs))


def _local(p: torch.Tensor, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``(p, *xs)`` as this rank's shards of DTensor ``p``'s layout (each
    of ``xs`` redistributed to it first where it differs, as a gradient
    may), or as they are when ``p`` is a plain tensor."""
    if not isinstance(p, DTensor):
        return (p, *xs)
    out = [p.to_local()]
    for x in xs:
        if tuple(x.placements) != tuple(p.placements):
            x = x.redistribute(p.device_mesh, p.placements)
        out.append(x.to_local())
    return tuple(out)


def _each_leaf(grads: Tree, params):
    """(leaf, its gradient, its parameter) over the reference's leaves;
    the gradient and parameter are stacked copies for stacked leaves."""
    tensors = named(params)
    for leaf in leaves(tensors):
        yield leaf, leaf.gather(grads), leaf.gather(tensors), tensors


def _each_member(grads: Tree, params, *trees: Tree):
    """(gradient, parameter, its view of each state tree) per parameter,
    leaf by leaf: the elementwise updates run one layer at a time, so no
    stacked copy of a leaf arises, and write the state in place."""
    tensors = named(params)
    for leaf in leaves(tensors):
        views = [leaf.views(t[leaf.name]) for t in trees]
        for j, name in enumerate(leaf.members):
            yield (grads[name], tensors[name], *(v[j] for v in views))


def sgd(lr_fn, momentum: float = 0.9, weight_decay: float = 0.0
        ) -> Optimizer:
    def init(params):
        return {"mu": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _f32(lr_fn(step))
        def one(p, g, mu):
            m = momentum * mu + g.to(mu.dtype)
            mu.copy_(m)
            d = (m + weight_decay * p.to(m.dtype)).to(p.dtype)
            p.copy_((p.float() - lr * d.float()).to(p.dtype))

        for g, p, mu in _each_member(grads, params, state["mu"]):
            _on_shards(one, p, g, mu)
        return params, state

    return Optimizer(init, update, "sgd")


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": _zeros(params, torch.float32),
                "v": _zeros(params, torch.float32)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _f32(lr_fn(step))
        t = np.float32(int(step)) + np.float32(1.0)
        c1 = _f32(np.float32(1.0) - np.float32(b1) ** t)
        c2 = _f32(np.float32(1.0) - np.float32(b2) ** t)
        def one(p_, g_, m_, v_):
            for s in _row_slices(p_):
                g, p, m, v = g_[s].float(), p_[s], m_[s], v_[s]
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g * g)
                u = (m / c1) / (torch.sqrt(v / c2) + eps)
                p32 = p.float()
                p.copy_((p32 - lr * (u + weight_decay * p32)).to(p.dtype))

        for g, p, m, v in _each_member(grads, params, state["m"],
                                       state["v"]):
            _on_shards(one, p, g, m, v)
        return params, state

    return Optimizer(init, update, "adamw")


def adafactor(lr_fn, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0
              ) -> Optimizer:
    """Factored second moments: row / column statistics for every leaf
    of two or more dimensions (the stacked ``(L, D)`` norm scales
    included), a full one for vectors; no first moment. The update of a
    leaf is clipped by its RMS over the whole (stacked) leaf. Where each
    layer's parameter has two or more dimensions, its statistics are its
    own, so the leaf is updated one layer at a time in two passes (the
    statistics and the sum of u^2, then the clipped update, u computed
    again), and no stacked copy of it arises; the stacked vectors (whose
    column statistics span the layers) are updated whole. A layer's
    parameter of more than `CHUNK_ELEMS` elements is taken in slices
    along its leading axis: with three or more dimensions that axis is
    one the statistics keep (an expert, a model row), so each slice's
    are its own; a matrix sums its column statistics over the slices
    first (`_matrix_stats`)."""

    def init(params):
        tensors = named(params)
        out = {}
        f32 = torch.float32
        for leaf in leaves(tensors):
            if len(leaf.shape(tensors)) >= 2:
                out[leaf.name] = {
                    "r": _leaf_zeros(leaf, tensors, f32, drop=-1),
                    "c": _leaf_zeros(leaf, tensors, f32, drop=-2)}
            else:
                out[leaf.name] = {"v": _leaf_zeros(leaf, tensors, f32)}
        return {"f": out}

    def factored_u(g, r, c, r_mean=None):
        """g over the root of its factored second moment, in one
        temporary of g's shape (the same operations, in place);
        ``r_mean``: the mean of the whole ``r`` over its last axis, where
        ``r`` is a slice of a matrix's row statistics."""
        u = r[..., None] * c[..., None, :]
        if r_mean is None:
            r_mean = r.mean(-1)
        u.div_(torch.clamp(r_mean[..., None, None], min=eps))
        return u.add_(eps).rsqrt_().mul_(g)

    def member_stats(g, r, c, beta):
        """Update a layer's statistics ``r``, ``c`` in place from its
        gradient ``g``; returns the sum of u^2 over the layer."""
        slices = _row_slices(g)
        if g.dim() == 2 and len(slices) > 1:
            return _matrix_stats(g, r, c, beta, slices)
        sumsq = 0.0
        for i in slices:
            gi = g[i].float()
            g2 = gi * gi + eps
            r[i].copy_(beta * r[i] + (1 - beta) * g2.mean(-1))
            c[i].copy_(beta * c[i] + (1 - beta) * g2.mean(-2))
            del g2
            u = factored_u(gi, r[i], c[i])
            sumsq = sumsq + torch.sum(u * u)
            del u
        return sumsq

    def _matrix_stats(g, r, c, beta, slices):
        """`member_stats` of a matrix taken in row slices: its column
        statistics are means over every row, summed slice by slice."""
        col = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
        for i in slices:
            gi = g[i].float()
            g2 = gi * gi + eps
            r[i].copy_(beta * r[i] + (1 - beta) * g2.mean(-1))
            col += g2.sum(-2)
            del g2
        c.copy_(beta * c + (1 - beta) * (col / g.shape[-2]))
        r_mean, sumsq = r.mean(-1), 0.0
        for i in slices:
            u = factored_u(g[i].float(), r[i], c, r_mean)
            sumsq = sumsq + torch.sum(u * u)
            del u
        return sumsq

    def member_step(p, g, r, c, rms, lr):
        """Write a layer's clipped update into ``p``, slice by slice."""
        slices = _row_slices(g)
        matrix = g.dim() == 2
        r_mean = r.mean(-1) if matrix and len(slices) > 1 else None
        for i in slices:
            u = factored_u(g[i].float(), r[i], c if matrix else c[i],
                           r_mean)
            p[i].copy_(stepped(p[i], u, rms, lr))

    def stepped(p, u, rms, lr):
        """``p`` after its update ``u`` (a temporary, overwritten),
        clipped by the leaf's RMS."""
        u.div_(torch.clamp(rms / clip_threshold, min=1.0))
        p32 = p.float()
        return (p32 - u.add_(weight_decay * p32).mul_(lr)).to(p.dtype)

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _f32(lr_fn(step))
        t = np.float32(int(step)) + np.float32(1.0)
        beta = _f32(np.float32(1.0) - t ** np.float32(-decay))
        tensors = named(params)
        for leaf in leaves(tensors):
            s = state["f"][leaf.name]
            if tensors[leaf.members[0]].dim() >= 2:
                members = list(zip(leaf.members, leaf.views(s["r"]),
                                   leaf.views(s["c"])))
                sumsq = 0.0
                for name, r, c in members:
                    sumsq = sumsq + member_stats(grads[name], r, c, beta)
                n = leaf.shape(tensors).numel()
                rms = torch.sqrt(sumsq / n)
                for name, r, c in members:
                    member_step(tensors[name], grads[name], r, c, rms, lr)
                continue
            g, p = leaf.gather(grads).float(), leaf.gather(tensors)
            g2 = g * g + eps
            if p.dim() >= 2:
                s["r"].copy_(beta * s["r"] + (1 - beta) * g2.mean(-1))
                s["c"].copy_(beta * s["c"] + (1 - beta) * g2.mean(-2))
                u = factored_u(g, s["r"], s["c"])
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g * torch.rsqrt(s["v"] + eps)
            leaf.scatter(tensors, stepped(p, u, torch.sqrt(torch.mean(u * u)),
                                          lr))
        return params, state

    return Optimizer(init, update, "adafactor")


def get_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    if name == "sgd":
        return sgd(lr_fn, **kw)
    if name == "signum":
        from repro_torch.optim.signum import signum
        return signum(lr_fn, **kw)
    raise ValueError(name)
