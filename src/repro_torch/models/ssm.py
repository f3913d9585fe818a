"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060].

The counterpart of `repro.models.ssm`, function for function. Prefill
runs the chunked SSD algorithm: within a chunk the recurrence is a
masked, decayed attention-like quadratic form; the chunk-final states are
carried across chunks by a Python loop where the reference runs
``lax.scan``. Decode is the O(1)-per-token recurrence over the cached
state ``(B, H, head_dim, N)`` plus a rolling window of the raw pre-conv
inputs. The reference computes all of it in plain ``jnp`` (no Pallas
kernel), so the port is plain PyTorch on either device.

The casts are the reference's, since in bf16 they decide the result: the
decays and the in-chunk weights are cast to the activations' dtype, the
inter-chunk state is carried in that dtype and only the final state is
float32; the depthwise conv sums in float32 before its SiLU; the decode
step runs in float32 against the float32 state.

With ``cfg.ssm_groups`` G > 1 (Nemotron-H: 8), B and C come in G groups,
group g serving heads ``g H / G .. (g + 1) H / G``, and the gated RMSNorm
normalises each of G slices of ``d_inner`` on its own. The scan is then
`ssd_grouped`, the Mamba-2 paper's chunked form with the chunk states
and their recurrence (one product over a segment sum of the chunks'
decays, no Python loop) in float32 and the products' inputs in the
activations' dtype. G = 1 keeps `ssd_chunked` and every cast above.

Every mixer call is a span ``ssm.mixer``; while `obs.device` records,
``ssd_chunks_total`` counts the chunks scanned (batch x chunks).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.obs import device as obs_device
from repro_torch.obs.telemetry import get_telemetry


class SSM(nn.Module):
    """``in_proj (D, 2 Din + 2 G N + H)`` (emitting z, x, B, C, dt),
    ``conv_w (K, Din + 2 G N)``, ``conv_b``, ``norm (Din,)`` and
    ``out_proj (Din, D)`` in ``cfg.dtype``; ``a_log``, ``d_skip``,
    ``dt_bias (H,)`` in float32."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, Din, N, H = cfg.d_model, cfg.d_inner, _bc_width(cfg), \
            cfg.n_ssm_heads
        C = Din + 2 * N
        dt = L.torch_dtype(cfg)
        f32 = torch.float32
        self.in_proj = L._param((D, 2 * Din + 2 * N + H), dt, device)
        self.conv_w = L._param((cfg.ssm_conv, C), dt, device)
        self.conv_b = L._param((C,), dt, device)
        self.a_log = L._param((H,), f32, device)
        self.d_skip = L._param((H,), f32, device)
        self.dt_bias = L._param((H,), f32, device)
        self.norm = L._param((Din,), dt, device)
        self.out_proj = L._param((Din, D), dt, device)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        """The reference's init: N(0, 0.02^2) ``in_proj``, N(0, 0.1^2)
        ``conv_w``, ``a_log = log(linspace(1, 16, H))``, unit ``d_skip``
        and norm, zero biases, ``out_proj`` scaled by 1/sqrt(2
        n_layers)."""
        H = cfg.n_ssm_heads
        L.dense_init_(self.in_proj, generator)
        L.dense_init_(self.conv_w, generator, 0.1)
        self.conv_b.zero_()
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.d_skip.fill_(1)
        self.dt_bias.zero_()
        self.norm.fill_(1)
        L.dense_init_(self.out_proj, generator,
                      L.INIT_STD / np.sqrt(2 * max(cfg.n_layers, 1)))


def _bc_width(cfg: ModelConfig) -> int:
    """Width of each of B and C: ``ssm_groups * ssm_state``."""
    return cfg.ssm_groups * cfg.ssm_state


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    Din, N = cfg.d_inner, _bc_width(cfg)
    z = zxbcdt[..., :Din]
    xBC = zxbcdt[..., Din:2 * Din + 2 * N]
    dt = zxbcdt[..., 2 * Din + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as K shifted adds in float32, then SiLU.
    xBC: (B, S, C); w: (K, C)."""
    K = w.shape[0]
    S = xBC.shape[1]
    x = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(K):
        out = out + x[:, i:i + S].float() * w[i].float()
    return F.silu(out + b.float()).to(xBC.dtype)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., c) log-decays -> (..., c, c) lower-triangular sums over
    (j, i], -inf above the diagonal."""
    c = dA.shape[-1]
    cum = torch.cumsum(dA, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dA.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) float32 after softplus; a_log: (H,)
    with A = -exp(a_log); Bm, Cm: (B, S, N), one group broadcast over the
    heads. Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N)
    float32). A ragged tail is padded with dt = 0 (decay 1, no input), so
    the final state ignores it."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    S_orig = S
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S += pad
    nc = S // chunk
    A = -torch.exp(a_log)                                   # (H,)
    dA = dt * A                                             # (B, S, H)
    xr = x.reshape(Bsz, nc, chunk, H, P)
    dtr = dt.reshape(Bsz, nc, chunk, H)
    dAr = dA.reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)  # (B,nc,H,c)
    Br = Bm.reshape(Bsz, nc, chunk, N)
    Cr = Cm.reshape(Bsz, nc, chunk, N)

    cum = torch.cumsum(dAr, dim=-1)                         # (B,nc,H,c)
    # intra-chunk: the quadratic form within each chunk
    Lm = torch.exp(_segsum(dAr))                            # (B,nc,H,c,c)
    scores = torch.einsum("bzin,bzjn->bzij", Cr, Br)        # (B,nc,c,c)
    att = scores[:, :, None] * Lm * dtr.permute(0, 1, 3, 2)[:, :, :, None, :]
    del Lm
    y = torch.einsum("bzhij,bzjhp->bzihp", att.to(x.dtype), xr)
    del att

    # chunk-final states
    decay_to_end = torch.exp(cum[..., -1:] - cum)           # (B,nc,H,c)
    states = torch.einsum("bzjn,bzhj,bzjh,bzjhp->bzhpn", Br,
                          decay_to_end.to(x.dtype), dtr.to(x.dtype), xr)

    # the recurrence over chunk states, each chunk seeing the state before
    chunk_decay = torch.exp(cum[..., -1])                   # (B,nc,H)
    s = (torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
         if init_state is None else init_state.to(x.dtype))
    prev = []
    for z in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, z, :, None, None].to(s.dtype) + states[:, z]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    # inter-chunk contribution
    in_decay = torch.exp(cum).permute(0, 1, 3, 2)           # (B,nc,c,H)
    y = y + torch.einsum("bzin,bzih,bzhpn->bzihp", Cr, in_decay.to(x.dtype),
                         prev_states)
    y = y.reshape(Bsz, S, H, P)[:, :S_orig]
    return y, s.float()


def ssd_grouped(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan with G groups of B and C.

    x: (B, S, H, P); dt: (B, S, H) float32 after softplus; a_log: (H,);
    Bm, Cm: (B, S, G, N), group g serving heads g H / G .. (g + 1) H / G.
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N)
    float32). The in-chunk weights, the chunk states and the recurrence
    over them run in float32; the products read their inputs in x's
    dtype, the chunk states in float32. A ragged tail is padded with dt =
    0, as in `ssd_chunked`."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[-2:]
    hg = H // G
    chunk = min(chunk, S)
    S_orig = S
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S += pad
    nc, c = S // chunk, chunk
    dt_ = x.dtype
    dAr = (dt * -torch.exp(a_log)).reshape(Bsz, nc, c, H).permute(0, 1, 3, 2)
    cum = torch.cumsum(dAr, dim=-1)                         # (B,nc,H,c)
    xr = x.reshape(Bsz, nc, c, G, hg, P)
    dtr = dt.reshape(Bsz, nc, c, H).permute(0, 1, 3, 2)     # (B,nc,H,c)
    Br = Bm.reshape(Bsz, nc, c, G, N)
    Cr = Cm.reshape(Bsz, nc, c, G, N)

    # within each chunk: C_i B_j decay(j -> i) dt_j x_j
    scores = torch.einsum("bzign,bzjgn->bzgij", Cr, Br).float()
    att = torch.exp(_segsum(dAr)) * dtr[..., None, :]       # (B,nc,H,c,c)
    att = att.view(Bsz, nc, G, hg, c, c) * scores[:, :, :, None]
    y = torch.einsum("bzghij,bzjghp->bzighp", att.to(dt_), xr)
    del att, scores

    # each chunk's state at its end, then the recurrence over chunks
    w = (torch.exp(cum[..., -1:] - cum) * dtr).permute(0, 1, 3, 2)
    xw = xr.float() * w.reshape(Bsz, nc, c, G, hg, 1)
    states = torch.einsum("bzjgn,bzjghp->bzghpn", Br.float(), xw)
    del xw
    s0 = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    states = torch.cat([s0.view(Bsz, 1, G, hg, P, N), states], dim=1)
    totals = F.pad(cum[..., -1], (0, 0, 1, 0)).permute(0, 2, 1)
    decay = torch.exp(_segsum(totals)).view(Bsz, G, hg, nc + 1, nc + 1)
    states = torch.einsum("bghzy,byghpn->bzghpn", decay, states)

    # the state entering each chunk, read out by C with its decay
    y_in = torch.einsum("bzign,bzghpn->bzighp", Cr,
                        states[:, :-1].to(dt_)).float()
    in_decay = torch.exp(cum).permute(0, 1, 3, 2).reshape(Bsz, nc, c, G, hg)
    y = (y.float() + y_in * in_decay[..., None]).to(dt_)
    final = states[:, -1].reshape(Bsz, H, P, N)
    return y.reshape(Bsz, S, H, P)[:, :S_orig], final


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """``rmsnorm(y silu(z))`` over each of ``ssm_groups`` slices of the
    last axis (one slice: the whole of ``d_inner``)."""
    g = y * F.silu(z.float()).to(y.dtype)
    G = cfg.ssm_groups
    if G == 1:
        return L.rmsnorm(g, scale, cfg.norm_eps)
    g = g.unflatten(-1, (G, -1))
    return L.rmsnorm(g, scale.view(G, -1), cfg.norm_eps).flatten(-2)


def ssm_forward(p: SSM, x: torch.Tensor, cfg: ModelConfig,
                init_state: Optional[torch.Tensor] = None,
                return_cache: bool = False):
    """Full-sequence Mamba2 mixer. x: (B, S, D) -> (y, final_state) or,
    with ``return_cache``, (y, (final_state, conv_tail)) where
    ``conv_tail`` is the raw pre-conv window tail (B, K - 1, C) that
    decode continues from."""
    with get_telemetry().span("ssm.mixer"):
        return _ssm_forward(p, x, cfg, init_state, return_cache)


def _ssm_forward(p: SSM, x: torch.Tensor, cfg: ModelConfig,
                 init_state: Optional[torch.Tensor], return_cache: bool):
    Din, N, H = cfg.d_inner, _bc_width(cfg), cfg.n_ssm_heads
    P, G = cfg.ssm_head_dim, cfg.ssm_groups
    K = cfg.ssm_conv
    z, xBC, dt_raw = _split_proj(cfg, torch.einsum("bsd,de->bse", x,
                                                   p.in_proj))
    Bsz, S = x.shape[:2]
    conv_tail = xBC[:, S - (K - 1):, :]
    xBC = _causal_conv(xBC, p.conv_w, p.conv_b)
    xs = xBC[..., :Din]
    Bm = xBC[..., Din:Din + N]
    Cm = xBC[..., Din + N:]
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    xh = xs.reshape(*xs.shape[:-1], H, P)
    if G == 1:
        y, state = ssd_chunked(xh, dt, p.a_log, Bm, Cm, cfg.ssm_chunk,
                               init_state)
    else:
        y, state = ssd_grouped(xh, dt, p.a_log, Bm.unflatten(-1, (G, -1)),
                               Cm.unflatten(-1, (G, -1)), cfg.ssm_chunk,
                               init_state)
    if obs_device.recording():
        obs_device.count("ssd_chunks_total",
                         Bsz * -(-S // min(cfg.ssm_chunk, S)))
    y = y + xh * p.d_skip[:, None].to(x.dtype)
    y = y.reshape(*xs.shape[:-1], Din)
    y = gated_norm(y, z, p.norm, cfg)
    out = torch.einsum("bse,ed->bsd", y, p.out_proj)
    if return_cache:
        return out, (state, conv_tail)
    return out, state


# --------------------------------------------------------------------------
# decode path (O(1) per token)
# --------------------------------------------------------------------------

def ssm_cache_init(cfg: ModelConfig, n_layers: int, batch: int,
                   device) -> Dict[str, torch.Tensor]:
    """Zeroed ``state (n_layers, B, H, P, N)`` float32 and ``conv
    (n_layers, B, K - 1, Din + 2 G N)`` in ``cfg.dtype``."""
    Din, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    C = Din + 2 * _bc_width(cfg)
    return {
        "state": torch.zeros((n_layers, batch, H, cfg.ssm_head_dim, N),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, C),
                            dtype=L.torch_dtype(cfg), device=device)}


def ssm_decode_step(p: SSM, x: torch.Tensor, state: torch.Tensor,
                    conv_cache: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, 1, D); state: (B, H, P, N) float32; conv_cache: (B, K - 1,
    C). Returns (y (B, 1, D), new state, new conv cache)."""
    with get_telemetry().span("ssm.mixer"):
        return _ssm_decode_step(p, x, state, conv_cache, cfg)


def _ssm_decode_step(p, x, state, conv_cache, cfg):
    Din, N, H = cfg.d_inner, _bc_width(cfg), cfg.n_ssm_heads
    P, G = cfg.ssm_head_dim, cfg.ssm_groups
    z, xBC, dt_raw = _split_proj(cfg, torch.einsum("bsd,de->bse", x,
                                                   p.in_proj))
    window = torch.cat([conv_cache, xBC[:, 0, None]], dim=1)  # (B, K, C)
    conv = (window.float() * p.conv_w.float()).sum(1) + p.conv_b.float()
    xBC = F.silu(conv).to(x.dtype)
    xs, Bm, Cm = xBC[..., :Din], xBC[..., Din:Din + N], xBC[..., Din + N:]
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)        # (B, H)
    A = -torch.exp(p.a_log)
    dA = torch.exp(dt * A)                                   # (B, H)
    xh = xs.reshape(-1, H, P).float()
    if G == 1:
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xh)
        state = state * dA[..., None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    else:   # each group's B and C over its H / G heads
        Bh = Bm.float().unflatten(-1, (G, -1)).repeat_interleave(H // G, 1)
        Ch = Cm.float().unflatten(-1, (G, -1)).repeat_interleave(H // G, 1)
        dBx = torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, xh)
        state = state * dA[..., None, None] + dBx
        y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    y = y + xh * p.d_skip[:, None]
    y = y.reshape(-1, 1, Din).to(x.dtype)
    y = gated_norm(y, z, p.norm, cfg)
    return (torch.einsum("bse,ed->bsd", y, p.out_proj), state,
            window[:, 1:].to(conv_cache.dtype))
