"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

The counterpart of `repro.models.moe`, step for step. Dispatch is the
sort-based (MegaBlocks/MaxText-style "dropping") formulation: tokens are
ranked within their expert group via a stable sort of the routed expert
ids; tokens beyond `capacity_factor * T * k / E` per expert are dropped
(their combine weight contribution is zero). An auxiliary load-balancing
loss (Switch-style) is returned alongside the output.

The router runs in float32; the top-k is a stable descending sort, so
ties keep the lower expert first, as ``jax.lax.top_k`` does. The expert
products are plain batched products over the expert axis (the reference
computes them outside any Pallas kernel). The reference's
``moe_constraints`` is a sharding hint for a mesh and comes with the
mesh of ROADMAP A8b.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class MoE(nn.Module):
    """``router (D, E)`` float32, ``wi (E, D, 2, F)`` (gate and up fused),
    ``wo (E, F, D)``, and with shared experts ``shared``, an `layers.MLP`
    of ``d_ff * n_shared_experts``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = L.torch_dtype(cfg)
        self.router = L._param((D, E), torch.float32, device)
        self.wi = L._param((E, D, 2, F), dt, device)
        self.wo = L._param((E, F, D), dt, device)
        if cfg.n_shared_experts:
            self.shared = L.MLP(cfg, device,
                                d_ff=cfg.d_ff * cfg.n_shared_experts)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        """N(0, 0.02^2) router and ``wi``, ``wo`` scaled by 1/sqrt(2
        n_layers); the experts are drawn one at a time, so the float32
        draw never holds more than one expert's weights."""
        out_std = L.INIT_STD / np.sqrt(2 * max(cfg.n_layers, 1))
        L.dense_init_(self.router, generator)
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


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y: (B, S, D), aux_loss scalar)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = expert_capacity(cfg, T)
    xt = x.reshape(T, D)

    probs, gate, idx = route(p.router, xt, k)
    d = dispatch(idx, E, C)
    # Switch-style aux loss: E * sum_e f_e * p_e
    me = probs.mean(dim=0)                                    # mean prob
    ce = d.counts.float() / (T * k)                           # routed share
    aux = E * (me * ce).sum()

    # ---- capacity-based dispatch -------------------------------------
    buf = x.new_zeros((E, C + 1, D))
    buf[d.sorted_e, d.dest_c] = xt[d.sort_i // k]
    buf = buf[:, :C]

    # ---- expert FFN (SwiGLU) -----------------------------------------
    h = torch.einsum("ecd,edgf->ecgf", buf, p.wi)
    act = torch.nn.functional.silu(h[:, :, 0].float()).to(x.dtype) \
        * h[:, :, 1]
    yb = torch.einsum("ecf,efd->ecd", act, p.wo)
    yb = torch.cat([yb, yb.new_zeros((E, 1, D))], dim=1)

    # ---- combine -------------------------------------------------------
    y_sorted = yb[d.sorted_e, d.dest_c] * d.keep[:, None].to(yb.dtype)
    y_flat = y_sorted[d.inv].reshape(T, k, D)
    y = (y_flat * gate[..., None].to(yb.dtype)).sum(dim=1)
    y = y.reshape(B, S, D)

    if cfg.n_shared_experts:
        y = y + L.mlp(p.shared, x, cfg)
    return y, aux
