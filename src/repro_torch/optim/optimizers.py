"""Optimizers in the reference's functional form, updating in place.

The counterpart of `repro.optim.optimizers`. An `Optimizer` is ``(init,
update)``: ``state = init(params)`` and ``params, state = update(grads,
state, params, step)``, where ``params`` is an `nn.Module` (or a dict of
tensors), ``grads`` a dict keyed by its parameter names, and ``step`` the
step index that the schedules read. The update writes the new values
into the parameters in place under `torch.no_grad` (the reference returns
new arrays) and returns them with the new state.

Per-leaf statistics follow the reference's parameter tree, whose blocks
are stacked on a leading layer axis: the port keeps one module per layer,
so `leaves` groups ``layers.<i>.<name>`` into one leaf ``layers.<name>``
of shape ``(L, ...)``, and every update runs on those stacked leaves.
Adafactor's update-RMS clip (and signum's ``mean |u|``) are then taken
over all the layers at once, and adafactor factors the stacked ``(L, D)``
norm scales, exactly as the reference does. The state is keyed by leaf
and shaped like the reference's (`convert.opt_state_from_reference`
carries it across). Elementwise updates (SGD, AdamW) would not need the
stacking; they use it too, so every optimizer reads one layout.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Tree = Dict[str, torch.Tensor]

_LAYER = re.compile(r"^(.*?)\.(\d+)\.(.*)$")


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable        # params -> state
    update: Callable      # (grads, state, params, step) -> (params, state)
    name: str = "opt"


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's parameter tree: a parameter, or the
    per-layer parameters (``members``, in layer order) of a leaf the
    reference stacks on a leading layer axis."""

    name: str
    members: Tuple[str, ...]
    stacked: bool

    def gather(self, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The leaf's tensor: the members stacked (a copy) or the one
        member itself."""
        xs = [tensors[m] for m in self.members]
        return torch.stack(xs) if self.stacked else xs[0]

    def scatter(self, tensors: Mapping[str, torch.Tensor],
                value: torch.Tensor) -> None:
        """Copy ``value`` (the leaf's shape) into its members in place."""
        parts = value.unbind(0) if self.stacked else (value,)
        for m, x in zip(self.members, parts):
            tensors[m].copy_(x)


def named(params) -> Tree:
    """Parameter name -> tensor of an `nn.Module` or a dict of tensors."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def leaves(names) -> List[Leaf]:
    """The reference's leaves over parameter ``names``, in its tree order
    (dict keys sorted at every level): ``layers.<i>.<rest>`` of every
    layer ``i`` form the stacked leaf ``layers.<rest>``."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    stacked = set()
    for n in names:
        m = _LAYER.match(n)
        key = f"{m[1]}.{m[3]}" if m else n
        if m:
            stacked.add(key)
        groups.setdefault(key, []).append((int(m[2]) if m else 0, n))
    return [Leaf(k, tuple(n for _, n in sorted(v)), k in stacked)
            for k, v in sorted(groups.items(),
                               key=lambda kv: tuple(kv[0].split(".")))]


def _f32(x) -> float:
    """A Python float holding a float32 value (the reference's schedules
    and bias corrections run in float32)."""
    return float(np.float32(x))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / ||grads||)`` (float32
    norm over all of them, scale applied in float32, cast back to each
    gradient's dtype); returns (grads, the norm before clipping)."""
    gs = list(grads.values())
    gn = torch.sqrt(sum((g.float() * g.float()).sum() for g in gs))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, gn


def _zeros(params, dtype=None) -> Tree:
    tensors = named(params)
    out = {}
    for leaf in leaves(tensors):
        p = leaf.gather(tensors)
        out[leaf.name] = torch.zeros(p.shape, dtype=dtype or p.dtype,
                                     device=p.device)
    return out


def _each_leaf(grads: Tree, params):
    """(leaf, its gradient, its parameter) over the reference's leaves;
    the gradient and parameter are stacked copies for stacked leaves."""
    tensors = named(params)
    for leaf in leaves(tensors):
        yield leaf, leaf.gather(grads), leaf.gather(tensors), tensors


def sgd(lr_fn, momentum: float = 0.9, weight_decay: float = 0.0
        ) -> Optimizer:
    def init(params):
        return {"mu": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _f32(lr_fn(step))
        mu = {}
        for leaf, g, p, tensors in _each_leaf(grads, params):
            m = state["mu"][leaf.name]
            m = momentum * m + g.to(m.dtype)
            mu[leaf.name] = m
            d = (m + weight_decay * p.to(m.dtype)).to(p.dtype)
            leaf.scatter(tensors, (p.float() - lr * d.float()).to(p.dtype))
        return params, {"mu": mu}

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
        new = {"m": {}, "v": {}}
        for leaf, g, p, tensors in _each_leaf(grads, params):
            g = g.float()
            m = b1 * state["m"][leaf.name] + (1 - b1) * g
            v = b2 * state["v"][leaf.name] + (1 - b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            p32 = p.float()
            leaf.scatter(tensors,
                         (p32 - lr * (u + weight_decay * p32)).to(p.dtype))
            new["m"][leaf.name], new["v"][leaf.name] = m, v
        return params, new

    return Optimizer(init, update, "adamw")


def adafactor(lr_fn, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0
              ) -> Optimizer:
    """Factored second moments: row / column statistics for every leaf
    of two or more dimensions (the stacked ``(L, D)`` norm scales
    included), a full one for vectors; no first moment."""

    def init(params):
        tensors = named(params)
        out = {}
        for leaf in leaves(tensors):
            p = leaf.gather(tensors)
            z = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                out[leaf.name] = {
                    "r": torch.zeros(p.shape[:-1], **z),
                    "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            else:
                out[leaf.name] = {"v": torch.zeros(p.shape, **z)}
        return {"f": out}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _f32(lr_fn(step))
        t = np.float32(int(step)) + np.float32(1.0)
        beta = _f32(np.float32(1.0) - t ** np.float32(-decay))
        f = {}
        for leaf, g, p, tensors in _each_leaf(grads, params):
            s = state["f"][leaf.name]
            g = g.float()
            g2 = g * g + eps
            if p.dim() >= 2:
                r = beta * s["r"] + (1 - beta) * g2.mean(-1)
                c = beta * s["c"] + (1 - beta) * g2.mean(-2)
                denom = (r[..., None] * c[..., None, :]
                         / torch.clamp(r.mean(-1)[..., None, None], min=eps))
                u = g * torch.rsqrt(denom + eps)
                f[leaf.name] = {"r": r, "c": c}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                f[leaf.name] = {"v": v}
            # update clipping over the whole (stacked) leaf
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p32 = p.float()
            leaf.scatter(tensors,
                         (p32 - lr * (u + weight_decay * p32)).to(p.dtype))
        return params, {"f": f}

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
