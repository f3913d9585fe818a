"""A plain PyTorch Nemotron-H (``nemotron_h``: NVIDIA Nemotron-3-Nano-30B-
A3B) in float32: the reference of the ``nemotron3_nano`` cells.

Written from the published modelling code (``NemotronHForCausalLM``):
blocks laid out by ``hybrid_override_pattern``, each ``x + mixer(
rmsnorm(x))``; then a final RMSNorm and an untied head.

* ``M``, Mamba-2 (``NemotronHMamba2Mixer``): ``in_proj`` to z, xBC, dt; a
  depthwise causal conv with bias and SiLU over xBC; dt = softplus(dt +
  dt_bias) (the published limit (0, inf) clamps nothing); A = -exp(A_log);
  the SSD recurrence with B and C in ``n_groups`` groups, head h reading
  group h // (heads / groups), computed as the Mamba-2 paper's
  ``ssd_minimal_discrete`` over chunks of ``chunk_size`` (exact for any
  chunk); y + D x; then ``rmsnorm_g(y silu(z))`` over each group of
  d_inner / n_groups, times the norm weight; ``out_proj``.
* ``E``, MoE (``NemotronHMOE``): scores sigmoid(x W_r); the
  ``num_experts_per_tok`` experts selected on scores +
  ``e_score_correction_bias`` (``n_group`` = ``topk_group`` = 1: no group
  limit), weighted by their scores renormalised (``norm_topk_prob``) and
  times ``routed_scaling_factor``; each expert down(relu(up x)^2); plus
  the shared expert of the same form. No token is dropped.
* ``*``, attention (``NemotronHAttention``): GQA, causal, softmax scale
  1 / sqrt(head_dim), no bias and no position encoding (the published
  code applies no rotary embedding; ``rope_theta`` is unused).

Departures: everything runs in float32 with TF32 off (the model is
bf16); the MoE's combine is summed in float32, as the published code
does. Weights come from the caller's ``draw(name)``, one block at a time
(port layout: ``blocks.<i>.ssm.in_proj`` (D, 2 Din + 2 G N + H),
``conv_w`` (K, C), ``moe.router`` (D, E), ``moe.e_bias``, ``moe.wi`` (E,
D, F), ``moe.wo`` (E, F, D), ``moe.shared.wi`` (D, Fs), ``attn.wq`` (D,
H, hd), ...), so the model is never held whole. ``quant="fp8"`` rounds
both operands of every product to float8 e4m3 at their own scale: the
control, a precision below the configuration's. A check can run the MoE
on another's experts (``sel``) and read by `route_gap` how far that
choice falls short of the reference's own.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .qwen3 import _q, full_float32  # noqa: F401  (re-exported)

#: query rows a step of the reference's attention
Q_CHUNK = 1024


def _mm(eq: str, a, b, quant):
    return torch.einsum(eq, _q(a, quant), _q(b, quant))


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): entry (i, j) the sum of x over (j, i],
    -inf above the diagonal (the paper's stable form)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    out = torch.cumsum(x.masked_fill(~below, 0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, -torch.inf)


def ssd(X, A, B, C, chunk: int, quant=None) -> torch.Tensor:
    """The Mamba-2 paper's ``ssd_minimal_discrete`` for one sequence: X
    (S, H, P) (inputs times dt), A (S, H) (A times dt), B, C (S, H, N) ->
    Y (S, H, P), from a zero state."""
    S, H, P = X.shape
    pad = (-S) % chunk
    if pad:     # dt = 0 past the end: no decay, no input
        X, A, B, C = (F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad))
                      for t in (X, A, B, C))
    n = X.shape[0] // chunk
    X, B, C = (t.reshape(n, chunk, *t.shape[1:]) for t in (X, B, C))
    A = A.reshape(n, chunk, H).permute(2, 0, 1)              # (H, n, c)
    A_cum = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))                                 # (H, n, c, c)
    CB = _mm("zlhn,zshn->hzls", C, B, quant)
    Y_diag = _mm("hzls,zshp->zlhp", CB * L, X, quant)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # (H, n, c)
    states = _mm("zlhn,zlhp->zhpn", B * decay_states.permute(1, 2, 0)[..., None],
                 X, quant)
    states = torch.cat([torch.zeros_like(states[:1]), states])
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = _mm("hzc,chpn->zhpn", decay_chunk, states, quant)[:-1]
    Y_off = _mm("zlhn,zhpn->zlhp", C, states, quant) \
        * torch.exp(A_cum).permute(1, 2, 0)[..., None]
    return (Y_diag + Y_off).reshape(-1, H, P)[:S]


def mamba2(x, w: Mapping[str, torch.Tensor], cfg: Mapping, quant=None):
    """One sequence x (S, D) through the Mamba-2 mixer."""
    H, P = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    G, N = cfg["n_groups"], cfg["ssm_state_size"]
    Din, K = H * P, cfg["conv_kernel"]
    S = x.shape[0]
    zxbcdt = _mm("sd,de->se", x, w["in_proj"], quant)
    z, xBC, dt = zxbcdt.split([Din, Din + 2 * G * N, H], dim=-1)
    C_all = xBC.shape[-1]
    conv = F.conv1d(xBC.T[None], w["conv_w"].T[:, None, :], w["conv_b"],
                    padding=K - 1, groups=C_all)[0, :, :S].T
    xs, Bm, Cm = F.silu(conv).split([Din, G * N, G * N], dim=-1)
    dt = F.softplus(dt + w["dt_bias"])                       # (S, H)
    A = -torch.exp(w["a_log"])
    xh = xs.reshape(S, H, P)
    Bh = Bm.reshape(S, G, N).repeat_interleave(H // G, dim=1)
    Ch = Cm.reshape(S, G, N).repeat_interleave(H // G, dim=1)
    y = ssd(xh * dt[..., None], A * dt, Bh, Ch, cfg["chunk_size"], quant)
    y = (y + xh * w["d_skip"][:, None]).reshape(S, Din) * F.silu(z)
    y = rmsnorm(y.reshape(S, G, Din // G), 1.0, cfg["layer_norm_epsilon"])
    y = y.reshape(S, Din) * w["norm"]
    return _mm("se,ed->sd", y, w["out_proj"], quant)


def _relu2(x):
    return torch.relu(x) ** 2


def moe(x, w: Mapping[str, torch.Tensor], cfg: Mapping, quant=None,
        sel: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tokens x (T, D) through the MoE: (y (T, D), each token's selected
    experts (T, k)). Given ``sel`` (T, k), those experts take the place
    of the selection, each weighted as published by its score."""
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    scores = torch.sigmoid(_mm("td,de->te", x, w["router"], quant))
    if sel is None:
        sel = torch.topk(scores + w["e_bias"], k, dim=-1).indices
    sel = sel.long()
    wts = scores.gather(1, sel)
    wts = wts / (wts.sum(-1, keepdim=True) + 1e-20) \
        * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(E):
        tok, slot = (sel == e).nonzero(as_tuple=True)
        if tok.numel():
            h = _relu2(_mm("td,df->tf", x[tok], w["wi"][e], quant))
            out = _mm("tf,fd->td", h, w["wo"][e], quant)
            y.index_add_(0, tok, out * wts[tok, slot, None])
    h = _relu2(_mm("td,df->tf", x, w["shared.wi"], quant))
    return y + _mm("tf,fd->td", h, w["shared.wo"], quant), sel


def route_gap(x, w: Mapping[str, torch.Tensor], cfg: Mapping,
              sel: torch.Tensor) -> float:
    """How far experts ``sel`` (T, k), chosen for the normed tokens x (T,
    D), fall short of the reference's own choice: the widest, over the
    tokens, of the k-th best selection score (sigmoid score plus
    ``e_bias``) minus the lowest of ``sel``'s. 0 where ``sel`` is the
    reference's choice; where rounding swapped experts at a near-tie, the
    tie's width."""
    pick = torch.sigmoid(x @ w["router"]) + w["e_bias"]
    kth = pick.topk(cfg["num_experts_per_tok"], dim=-1).values[:, -1]
    return float((kth - pick.gather(1, sel.long()).min(-1).values).max())


def attention(x, w: Mapping[str, torch.Tensor], cfg: Mapping, quant=None):
    """One sequence x (S, D) through causal GQA attention without position
    encoding, ``Q_CHUNK`` query rows at a time."""
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    S = x.shape[0]
    q = _mm("sd,dhk->shk", x, w["wq"], quant)
    k = _mm("sd,dhk->shk", x, w["wk"], quant).repeat_interleave(H // KV, 1)
    v = _mm("sd,dhk->shk", x, w["wv"], quant).repeat_interleave(H // KV, 1)
    o = torch.empty_like(q)
    for s0 in range(0, S, Q_CHUNK):
        s1 = min(S, s0 + Q_CHUNK)
        sc = _mm("qhd,khd->hqk", q[s0:s1], k[:s1], quant) / math.sqrt(hd)
        rows = torch.arange(s0, s1, device=x.device)[:, None]
        cols = torch.arange(s1, device=x.device)[None, :]
        p = torch.softmax(sc.masked_fill(cols > rows, -torch.inf), dim=-1)
        o[s0:s1] = _mm("hqk,khd->qhd", p, v[:s1], quant)
    return _mm("shk,hkd->sd", o, w["wo"], quant)


#: each block kind's mixer and its weights under ``blocks.<i>.``
MIXER_KEYS = {
    "M": ("ssm", ("in_proj", "conv_w", "conv_b", "a_log", "d_skip",
                  "dt_bias", "norm", "out_proj")),
    "E": ("moe", ("router", "e_bias", "wi", "wo", "shared.wi", "shared.wo")),
    "*": ("attn", ("wq", "wk", "wv", "wo")),
}


def block_weights(draw: Callable[[str], torch.Tensor], i: int, kind: str
                  ) -> Dict[str, torch.Tensor]:
    """Block ``i``'s weights from ``draw`` (float32): ``ln`` and its
    mixer's, by their names under the mixer."""
    owner, keys = MIXER_KEYS[kind]
    w = {key: draw(f"blocks.{i}.{owner}.{key}") for key in keys}
    w["ln"] = draw(f"blocks.{i}.ln")
    return w


@torch.no_grad()
def mixer(xs: Sequence[torch.Tensor], w: Mapping[str, torch.Tensor],
          kind: str, cfg: Mapping, quant: Optional[str] = None,
          sel: Optional[torch.Tensor] = None
          ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """The mixer of a block of kind ``kind`` over sequences ``xs`` (each
    (S, D), the block's input): (each ``mixer(rmsnorm(x))``, the output
    before the residual add; the MoE's experts (T, k) or None). The MoE
    runs over all their tokens at once, on experts ``sel`` where given
    (`moe`)."""
    eps = cfg["layer_norm_epsilon"]
    if kind == "E":
        y, sel = moe(rmsnorm(torch.cat(xs), w["ln"], eps), w, cfg, quant, sel)
        return list(y.split([x.shape[0] for x in xs])), sel
    f = mamba2 if kind == "M" else attention
    return [f(rmsnorm(x, w["ln"], eps), w, cfg, quant) for x in xs], None


@torch.no_grad()
def last_logits(draw: Callable[[str], torch.Tensor],
                prompts: Sequence[torch.Tensor], cfg: Mapping,
                quant: Optional[str] = None, every: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Prompts (each (S,) ids) -> (the last position's logits (n, V), or
    with ``every`` each prompt's logits at every position (n, S, V) (of
    prompts of one length), and each MoE block's selected experts (n S,
    k), in block order). The blocks run one at a time over all prompts:
    a block's weights are drawn, applied and freed before the next."""
    tok = draw("embed.tok")
    xs = [tok[p] for p in prompts]
    del tok
    routes: List[torch.Tensor] = []
    for i, kind in enumerate(cfg["hybrid_override_pattern"]):
        w = block_weights(draw, i, kind)
        ys, sel = mixer(xs, w, kind, cfg, quant)
        if sel is not None:
            routes.append(sel)
        xs = [x + y for x, y in zip(xs, ys)]
        del w, ys
    last = torch.stack(xs) if every else torch.stack([x[-1] for x in xs])
    return head(last, draw, cfg, quant), routes


def head(x: torch.Tensor, draw: Callable[[str], torch.Tensor], cfg: Mapping,
         quant: Optional[str] = None) -> torch.Tensor:
    """Hidden states (..., D) -> logits (..., V): the final RMSNorm and
    the untied head."""
    x = rmsnorm(x, draw("final_norm"), cfg["layer_norm_epsilon"])
    return _mm("...d,dv->...v", x, draw("embed.head"), quant)
