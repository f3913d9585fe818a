"""Mixture-of-Experts FFN with top-k routing and capacity-based or
dropless dispatch.

The counterpart of `repro.models.moe`, step for step. Dispatch is the
sort-based (MegaBlocks/MaxText-style "dropping") formulation: tokens are
ranked within their expert group via a stable sort of the routed expert
ids; tokens beyond `capacity_factor * T * k / E` per expert are dropped
(their combine weight contribution is zero). An auxiliary load-balancing
loss (Switch-style) is returned alongside the output.

The router runs in float32; the top-k is a stable descending sort, so
ties keep the lower expert first, as ``jax.lax.top_k`` does. The expert
products are plain batched products over the expert axis (the reference
computes them outside any Pallas kernel).

On a mesh (DTensor activations, on their own `DeviceMesh`) DTensor has
no sharding rule for the dispatch's sort,
``scatter_add_`` and indexed writes, so `moe_ffn` runs them in two
`local_map` regions, as the reference's rules place the work: the
routing (router product, top-k, the counts and the aux loss) on the
whole token set on every rank, which is small beside the experts; then
the dispatch, the expert products and the combine with the experts split
over the model axis and each expert's capacity rows over the data axes,
so that every expert row is computed on one rank. Each rank's combine
is its share of y, summed over the ranks (``Partial``). The reference's
``moe_constraints`` (`_c` at its three sites) is the identity there: the
regions run under a disabled `axis_rules` context, as the reference's
``shard_map`` bodies do, and their buffers are sharded on the experts
whatever the flag says.

Three settings, each on its own, serve Nemotron-H's MoE. The router
(``cfg.router == "sigmoid"``): the scores are ``sigmoid(x W_r)`` in
float32, the ``top_k`` experts are *selected* on the score plus
``e_bias`` (``e_score_correction_bias``) and *weighted* by the score
alone, renormalised and times ``routed_scale``; there is no
load-balancing loss (aux 0). Dropless dispatch (``cfg.dropless``) sorts
the T * k slots by expert and computes exactly those rows, with no
capacity and no padded ``(E, C, D)`` buffer: the expert products are
`torch._grouped_mm` over the sorted rows on a Hopper card, one product
per expert elsewhere; the combine sums each token's k weighted rows in
float32. The experts (``cfg.mlp_kind``) are SwiGLU, or ``down(relu(up
x)^2)`` (``"relu2"``, `layers.relu2`). A mesh runs the softmax router,
capacity dispatch and SwiGLU experts only.

Spans ``moe.route`` (router, top-k) and ``moe.experts`` (dispatch,
products, combine) wrap every MoE layer outside a mesh, and
``moe.shared`` the shared experts on any; while `obs.device` records,
the counters ``moe_slots_total`` (T * k a call), ``moe_calls_total`` and
``moe_busiest_over_mean_total`` (the busiest expert's slots over the
mean, summed over calls on the device) run too. Outside a mesh the
selected experts go to the ``moe.route`` tap (`obs.taps`).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (axis_rules, constrain, mesh_sizes,
                                       placements_of, resolve_spec)
from repro_torch.models import layers as L
from repro_torch.obs import device as obs_device
from repro_torch.obs import taps
from repro_torch.obs.telemetry import get_telemetry

# The reference's switch for its explicit dispatch-buffer constraints
# (off by default; `launch.cells` sets it from the plan's
# ``moe_constrain``).
_MOE_CONSTRAIN = {"on": False}


@contextlib.contextmanager
def moe_constraints(enabled: bool = True):
    """Constrain the dispatch buffer, the experts' hidden activations and
    their outputs to the experts' sharding (`_c`) while active."""
    prev = _MOE_CONSTRAIN["on"]
    _MOE_CONSTRAIN["on"] = enabled
    try:
        yield
    finally:
        _MOE_CONSTRAIN["on"] = prev


def _c(x, *names):
    return constrain(x, *names) if _MOE_CONSTRAIN["on"] else x


class MoE(nn.Module):
    """``router (D, E)`` float32, ``wi (E, D, 2, F)`` (gate and up fused;
    relu^2 experts: ``(E, D, F)``), ``wo (E, F, D)``, with the sigmoid
    router ``e_bias (E,)`` float32, and with shared experts ``shared``,
    an `layers.MLP` of ``cfg.expert_shared_d_ff``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = L.torch_dtype(cfg)
        self.router = L._param((D, E), torch.float32, device)
        if cfg.router == "sigmoid":
            self.e_bias = L._param((E,), torch.float32, device)
        wi = (E, D, F) if cfg.mlp_kind == "relu2" else (E, D, 2, F)
        self.wi = L._param(wi, dt, device)
        self.wo = L._param((E, F, D), dt, device)
        if cfg.n_shared_experts:
            self.shared = L.MLP(cfg, device, d_ff=cfg.expert_shared_d_ff)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        """N(0, 0.02^2) router and ``wi``, ``wo`` scaled by 1/sqrt(2
        n_layers); the experts are drawn one at a time, so the float32
        draw never holds more than one expert's weights."""
        out_std = L.INIT_STD / np.sqrt(2 * max(cfg.n_layers, 1))
        L.dense_init_(self.router, generator)
        if hasattr(self, "e_bias"):
            self.e_bias.zero_()
        for e in range(cfg.n_experts):
            L.dense_init_(self.wi[e], generator)
        for e in range(cfg.n_experts):
            L.dense_init_(self.wo[e], generator, out_std)
        if cfg.n_shared_experts:
            self.shared.init_(generator, cfg)


def moe_init(generator: torch.Generator, cfg: ModelConfig, device) -> MoE:
    """A `MoE` on ``device`` with weights drawn from ``generator``."""
    p = MoE(cfg, device)
    p.init_(generator, cfg)
    return p


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, (cap + 7) // 8 * 8)


class Dispatch(NamedTuple):
    """Where each of the T * k routed slots goes, in expert-sorted order."""

    sort_i: torch.Tensor     # (T*k,) slot ids, stably sorted by expert
    sorted_e: torch.Tensor   # (T*k,) each sorted slot's expert
    dest_c: torch.Tensor     # (T*k,) its row in the expert's buffer (C: drop)
    keep: torch.Tensor       # (T*k,) bool, within capacity
    inv: torch.Tensor        # (T*k,) inverse permutation of sort_i
    counts: torch.Tensor     # (E,) slots routed to each expert


def dispatch(idx: torch.Tensor, n_experts: int, capacity: int) -> Dispatch:
    """Capacity-based dispatch of the routed expert ids ``idx`` (T, k):
    slots are ranked within their expert by a stable sort; ranks at or past
    ``capacity`` go to the drop row ``capacity``."""
    flat_e = idx.reshape(-1)
    n = flat_e.shape[0]
    sort_i = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_i]
    # a static-size count (bincount's output size depends on the data,
    # which a meta tensor does not hold; `launch.hlocost` counts on meta)
    counts = torch.zeros(n_experts, dtype=torch.long,
                         device=idx.device).scatter_add_(
        0, flat_e.long(), torch.ones_like(flat_e, dtype=torch.long))
    starts = counts.cumsum(0) - counts
    pos = torch.arange(n, device=idx.device) - starts[sorted_e]
    keep = pos < capacity
    dest_c = torch.where(keep, pos, capacity)
    inv = torch.empty_like(sort_i)
    inv[sort_i] = torch.arange(n, device=idx.device)
    return Dispatch(sort_i, sorted_e, dest_c, keep, inv, counts)


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities (T, E) in float32 and each token's ``top_k``
    gates (renormalised to sum 1) and expert ids, largest first."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[:, :top_k], order[:, :top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, idx


def route_sigmoid(router: torch.Tensor, bias: torch.Tensor,
                  xt: torch.Tensor, top_k: int, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nemotron-H's router: scores ``sigmoid(xt router)`` (T, E) in
    float32; each token's ``top_k`` experts selected on ``scores + bias``,
    largest first, and weighted by their scores renormalised to sum 1,
    times ``scale``. Returns (scores, gates (T, k), ids (T, k))."""
    scores = torch.sigmoid(xt.float() @ router)
    idx = torch.topk(scores + bias, top_k, dim=-1).indices
    gate = scores.gather(-1, idx)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-20) * scale
    return scores, gate, idx


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y: (B, S, D), aux_loss scalar)."""
    from torch.distributed.tensor import DTensor

    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    if isinstance(x, DTensor):
        if cfg.dropless or cfg.router != "softmax" or cfg.mlp_kind == "relu2":
            raise NotImplementedError(f"{cfg.name}: the MoE on a mesh "
                                      "routes by softmax with capacity")
        y, aux = _moe_on_mesh(p, xt, cfg, x.device_mesh)
        y = constrain(y, "batch", "embed_act").reshape(B, S, D)
    else:
        E, k = cfg.n_experts, cfg.top_k
        tel = get_telemetry()
        with tel.span("moe.route"):
            if cfg.router == "sigmoid":
                probs, gate, idx = route_sigmoid(p.router, p.e_bias, xt, k,
                                                 cfg.routed_scale)
            else:
                probs, gate, idx = route(p.router, xt, k)
        taps.emit("moe.route", idx=idx)
        with tel.span("moe.experts"):
            if cfg.dropless:
                y, counts = _experts_dropless(xt, gate, idx, p.wi, p.wo, cfg)
            else:
                d = dispatch(idx, E, expert_capacity(cfg, T))
                counts = d.counts
                y = _experts(xt, gate, d, p.wi, p.wo, cfg)
            y = y.reshape(B, S, D)
        aux = _aux(probs, counts, cfg) if cfg.router == "softmax" else \
            torch.zeros((), dtype=torch.float32, device=x.device)
        if obs_device.recording():
            obs_device.count("moe_slots_total", T * k)
            obs_device.count("moe_calls_total", 1)
            obs_device.count("moe_busiest_over_mean_total",
                             counts.max() * E / (T * k))
    if cfg.n_shared_experts:
        with get_telemetry().span("moe.shared"):
            y = y + L.mlp(p.shared, x, cfg)
    return y, aux


def _aux(probs: torch.Tensor, counts: torch.Tensor,
         cfg: ModelConfig) -> torch.Tensor:
    """The Switch-style aux loss ``E * sum_e f_e p_e`` of router
    probabilities (T, E) and each expert's routed slots."""
    me = probs.mean(dim=0)                                    # mean prob
    ce = counts.float() / (probs.shape[0] * cfg.top_k)        # routed share
    return cfg.n_experts * (me * ce).sum()


def _experts(xt: torch.Tensor, gate: torch.Tensor, d: Dispatch,
             wi: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    """The capacity-based dispatch ``d``, the experts (`_ffn`) and the
    combine of tokens ``xt`` (T, D) with weights ``gate`` (T, k): y (T,
    D)."""
    T, D = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, T)

    # ---- capacity-based dispatch -------------------------------------
    buf = xt.new_zeros((E, C + 1, D))
    buf[d.sorted_e, d.dest_c] = xt[d.sort_i // k]
    buf = _c(buf[:, :C], "experts", None, None)

    # ---- expert FFN ----------------------------------------------------
    yb = _c(_ffn(buf, wi, wo, cfg.mlp_kind), "experts", None, None)
    yb = torch.cat([yb, yb.new_zeros((E, 1, D))], dim=1)

    # ---- combine -------------------------------------------------------
    y_sorted = yb[d.sorted_e, d.dest_c] * d.keep[:, None].to(yb.dtype)
    y_flat = y_sorted[d.inv].reshape(T, k, D)
    return (y_flat * gate[..., None].to(yb.dtype)).sum(dim=1)


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    """The experts' activation of their first product: relu^2 of ``h``
    (..., F) (``kind`` "relu2"), else SwiGLU of ``h`` (..., 2, F) (gate,
    up) -> (..., F)."""
    if kind == "relu2":
        return L.relu2(h)
    return torch.nn.functional.silu(h[..., 0, :].float()).to(h.dtype) \
        * h[..., 1, :]


def _ffn(buf: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
         kind: str) -> torch.Tensor:
    """The experts (``kind``, `_act`) on their buffers (E, C, D) -> (E,
    C, D)."""
    spec = "ecd,edf->ecf" if kind == "relu2" else "ecd,edgf->ecgf"
    h = _c(torch.einsum(spec, buf, wi),
           "experts", *[None] * (wi.dim() - 2), "mlp")
    return torch.einsum("ecf,efd->ecd", _act(h, kind), wo)


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """Rows ``x`` (R, K) sorted by group, ``counts`` (G,) rows a group,
    times each group's ``w[g]`` (G, K, N): (R, N). `torch._grouped_mm`
    over the offsets on a Hopper card for bf16 operands whose rows are
    whole 16-byte words (it reads the counts on the device); one product
    per group otherwise, which reads the counts on the host."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16 \
            and x.shape[1] % 8 == 0 and w.shape[2] % 8 == 0 \
            and torch.cuda.get_device_capability(x.device) >= (9, 0):
        offs = counts.cumsum(0).to(torch.int32)
        return torch._grouped_mm(x, w, offs=offs)
    parts = x.split(counts.tolist())
    return torch.cat([a @ w[g] for g, a in enumerate(parts)])


def _experts_dropless(xt: torch.Tensor, gate: torch.Tensor,
                      idx: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every routed slot of tokens ``xt`` (T, D), with weights ``gate``
    and expert ids ``idx`` (T, k): the slots sorted by expert (stably),
    the experts' rows (`_act`) through `grouped_mm`, and each token's k
    rows weighted and summed in float32. Returns (y (T, D) in xt's dtype,
    the slots of each expert (E,))."""
    T, D = xt.shape
    E, k = cfg.n_experts, idx.shape[1]
    flat_e = idx.reshape(-1)
    sort_i = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=xt.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    xs = xt[sort_i // k]
    h = grouped_mm(xs, wi.flatten(2), counts)
    del xs
    a = _act(h.unflatten(1, wi.shape[2:]), cfg.mlp_kind)
    del h
    ys = grouped_mm(a, wo, counts)
    del a
    inv = torch.empty_like(sort_i)
    inv[sort_i] = torch.arange(sort_i.shape[0], device=xt.device)
    inv = inv.reshape(T, k)
    y = torch.zeros((T, D), dtype=torch.float32, device=xt.device)
    for j in range(k):
        y = y.addcmul(ys[inv[:, j]].float(), gate[:, j, None])
    return y.to(xt.dtype), counts


def _experts_share(xt: torch.Tensor, gate: torch.Tensor, idx: torch.Tensor,
                   wi: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig,
                   e0: int, c0: int, Cl: int) -> torch.Tensor:
    """`_experts` for one rank of a mesh: ``wi`` / ``wo`` hold experts
    ``e0 ..`` and this rank fills capacity rows ``c0 .. c0 + Cl`` of
    them. An expert's slots lie together in the expert-sorted order and
    its kept ones are its first C, so the rank gathers just its rows'
    tokens (El x Cl of them; the rows past an expert's count are zeros)
    and adds their gated outputs back into its share of y (T, D)."""
    T, D = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    El = wi.shape[0]
    flat_e = idx.reshape(-1)
    sort_i = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=idx.device).scatter_add_(
        0, flat_e.long(), torch.ones_like(flat_e, dtype=torch.long))
    starts = counts.cumsum(0) - counts
    e = torch.arange(e0, e0 + El, device=idx.device)
    c = torch.arange(c0, c0 + Cl, device=idx.device)
    valid = c[None, :] < counts[e][:, None]                  # (El, Cl)
    pos = (starts[e][:, None] + c[None, :]).clamp(max=T * k - 1)
    slot = sort_i[pos]
    src = slot // k
    buf = xt[src] * valid[..., None].to(xt.dtype)
    yb = _ffn(buf, wi, wo, cfg.mlp_kind)
    w = gate.reshape(-1)[slot] * valid
    return xt.new_zeros((T, D)).index_add_(
        0, src.reshape(-1), (yb * w[..., None].to(yb.dtype)).reshape(-1, D))


def _moe_on_mesh(p: MoE, xt, cfg: ModelConfig, mesh):
    """`moe_ffn`'s routed part on DTensor tokens ``xt`` (T, D): (y (T, D)
    summed over the ranks' shares, aux) (the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.hlocost import per_shard

    T, D = xt.shape
    E = cfg.n_experts
    C = expert_capacity(cfg, T)
    sizes = mesh_sizes(mesh)
    rep = (Replicate(),) * len(sizes)
    e_spec = resolve_spec((E, C, D), ("experts", "batch", None), mesh)
    e_pl = placements_of(e_spec, mesh)
    coords = {a: mesh.get_local_rank(a) for a in sizes}

    def share(entry, n):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx, m = 0, 1
        for a in axes:
            idx, m = idx * sizes[a] + coords[a], m * sizes[a]
        return idx * (n // m), n // m

    e0, El = share(e_spec[0], E)
    c0, Cl = share(e_spec[1], C)
    wi_pl = placements_of((e_spec[0], None, None, None), mesh)
    wo_pl = placements_of((e_spec[0], None, None), mesh)
    # a rank's y (and its gradients of the tokens and gates) is its
    # experts' and rows' share: summed over the axes that split them; its
    # gradients of its experts' weights, over the axes that split the rows
    part = tuple(Partial() if isinstance(q, Shard) else Replicate()
                 for q in e_pl)
    rows = tuple(Partial() if q == Shard(1) else None for q in e_pl)
    wi_grad = tuple(r or q for r, q in zip(rows, wi_pl))
    wo_grad = tuple(r or q for r, q in zip(rows, wo_pl))

    def routing(a, r):
        with axis_rules(None):
            probs, gate, idx = route(r, a, cfg.top_k)
            flat = idx.reshape(-1)
            counts = torch.zeros(E, dtype=torch.long,
                                 device=idx.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            return gate, idx, _aux(probs, counts, cfg)

    def experts(a, g, i, wi, wo):
        with axis_rules(None):
            return _experts_share(a, g, i, wi, wo, cfg, e0, c0, Cl)

    shards = math.prod(sizes[a] for a, q in zip(sizes, part)
                       if isinstance(q, Partial))
    gate, idx, aux = local_map(
        routing, out_placements=(rep, rep, rep), in_placements=(rep, rep),
        in_grad_placements=(rep, rep), device_mesh=mesh,
        redistribute_inputs=True)(xt, p.router)
    y = local_map(
        per_shard(experts, shards), out_placements=(part,),
        in_placements=(rep, rep, rep, wi_pl, wo_pl),
        in_grad_placements=(part, part, rep, wi_grad, wo_grad),
        device_mesh=mesh, redistribute_inputs=True)(xt, gate, idx, p.wi,
                                                    p.wo)
    return y, aux
