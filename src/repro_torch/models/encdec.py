"""Encoder-decoder family (SeamlessM4T-medium backbone): training and
serving.

The counterpart of `repro.models.encdec`. The audio frontend is a stub, as
in the reference: the batch carries precomputed frame embeddings ``frames
(B, n_frontend_tokens, frontend_dim)`` and the model owns only a linear
adapter into d_model. Encoder blocks are bidirectional self-attention
(with RoPE over the frame positions) and an MLP; decoder blocks are
causal self-attention, cross-attention to the encoder's output and an
MLP. Prefill runs every attention through the flash kernel (the encoder's
non-causal, the decoder's causal, the cross-attention non-causal over
``Sq`` queries and ``Sf`` frames); a decode step scores the cached cross
keys with a plain float32 softmax, as the reference's ``_cross_decode``
does.

`encdec_apply` is the training stack (`transformer.lm_loss`'s
``apply_fn``): `encode` with grad, then the `dec_block`s over the
encoder's output. With grad on, each
encoder and decoder layer is checkpointed under ``remat``
(`transformer.remat_call`), as the reference's scans are.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.transformer import (DenseBlock, _ffn,
                                            attention_prefill, check_remat,
                                            remat_call)


def _frontend_dim(cfg: ModelConfig) -> int:
    return cfg.frontend_dim or cfg.d_model


class DecBlock(DenseBlock):
    """A `DenseBlock` (``ln1``, ``attn``, ``ln2``, ``mlp``) plus ``ln_x``
    and the cross-attention ``cross`` (the parameters of an
    `layers.Attention`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.ln_x = L._param((cfg.d_model,), L.torch_dtype(cfg), device)
        self.cross = L.Attention(cfg, device)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        super().init_(generator, cfg)
        self.ln_x.fill_(1)
        self.cross.init_(generator, cfg)


class EncDec(nn.Module):
    """``embed``, ``frontend_proj (Df, D)``, ``final_norm``, ``enc_norm``,
    ``enc`` (``n_enc_layers`` `DenseBlock`s) and ``dec`` (``n_layers``
    `DecBlock`s)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = L.torch_dtype(cfg)
        self.embed = L.Embed(cfg, device)
        self.frontend_proj = L._param((_frontend_dim(cfg), cfg.d_model), dt,
                                      device)
        self.final_norm = L._param((cfg.d_model,), dt, device)
        self.enc_norm = L._param((cfg.d_model,), dt, device)
        self.enc = nn.ModuleList(DenseBlock(cfg, device)
                                 for _ in range(cfg.n_enc_layers))
        self.dec = nn.ModuleList(DecBlock(cfg, device)
                                 for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def encdec_init(generator: torch.Generator, cfg: ModelConfig,
                device) -> EncDec:
    """An `EncDec` on ``device`` with weights drawn from ``generator`` (on
    that device), one matrix at a time."""
    model = EncDec(cfg, device)
    L.check_generator(generator, model.device)
    with torch.no_grad():
        model.embed.init_(generator, cfg)
        L.dense_init_(model.frontend_proj, generator)
        model.final_norm.fill_(1)
        model.enc_norm.fill_(1)
        for block in (*model.enc, *model.dec):
            block.init_(generator, cfg)
    return model


def frontend_proj(w: torch.Tensor, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Frontend embeddings (B, Sf, Df), cast to ``cfg.dtype``, through the
    adapter ``w (Df, D)``."""
    return torch.einsum("bsf,fd->bsd", x.to(L.torch_dtype(cfg)), w)


def enc_block(p: DenseBlock, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """A bidirectional encoder layer: self-attention without the causal
    mask (RoPE over the frame positions), then the MLP."""
    x = x + L.attention_train(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps),
                              cfg, causal=False)
    return x + L.mlp(p.mlp, L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg)


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig,
           remat: str = "block") -> torch.Tensor:
    """frames: (B, Sf, Df) stub embeddings -> (B, Sf, D) encoder output:
    bidirectional blocks (each checkpointed under ``remat`` while grad is
    on), then ``enc_norm``."""
    x = constrain(frontend_proj(params.frontend_proj, frames, cfg), "batch",
                  "seq", "embed_act")
    for p in params.enc:
        x = remat_call(enc_block, p, x, cfg, remat=remat)
    return L.rmsnorm(x, params.enc_norm, cfg.norm_eps)


def dec_block(p: DecBlock, x: torch.Tensor, memory: torch.Tensor,
              cfg: ModelConfig, qc: int = 512) -> torch.Tensor:
    """A decoder layer over the whole sequence: causal self-attention,
    cross-attention to ``memory`` (B, Sm, D), the MLP."""
    x = constrain(x, "batch", "seq", "embed_act")
    h = x + L.attention_train(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps),
                              cfg, q_chunk=qc, kv_chunk=qc)
    h = h + L.cross_attention(p.cross, L.rmsnorm(h, p.ln_x, cfg.norm_eps),
                              memory, cfg)
    return h + L.mlp(p.mlp, L.rmsnorm(h, p.ln2, cfg.norm_eps), cfg)


def encdec_apply(params: EncDec, tokens: torch.Tensor, cfg: ModelConfig,
                 frames: torch.Tensor, remat: str = "block"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S), frames: (B, Sf, Df) -> (hidden (B, S, D), aux =
    0): `encode`, then the decoder layers (flash chunks ``min(512, S)``)
    and the final norm."""
    check_remat(remat)
    memory = encode(params, frames, cfg, remat)
    x = L.embed(params.embed, tokens)
    qc = min(512, tokens.shape[1])
    for p in params.dec:
        x = remat_call(dec_block, p, x, memory, cfg, qc, remat=remat)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def encdec_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Dict:
    """``{"self": {"k", "v"}}`` of ``(n_layers, B, max_len, KV * hd)`` and
    ``cross_k`` / ``cross_v`` of ``(n_layers, B, Sf, KV * hd)``."""
    shape = (cfg.n_layers, batch, cfg.n_frontend_tokens,
             cfg.n_kv_heads * cfg.head_dim_)
    dt = L.torch_dtype(cfg)
    return {"self": L.kv_cache_init(cfg, cfg.n_layers, batch, max_len,
                                    device),
            "cross_k": torch.zeros(shape, dtype=dt, device=device),
            "cross_v": torch.zeros(shape, dtype=dt, device=device)}


def cross_prefill(p: DecBlock, h: torch.Tensor, memory: torch.Tensor,
                  cfg: ModelConfig):
    """A `DecBlock`'s cross-attention and MLP over the prompt: (h, the
    memory's keys, its values), the keys and values projected once for
    the attention and the cache."""
    xk = L.project(memory, p.cross.wk)
    xv = L.project(memory, p.cross.wv)
    h = h + L.cross_attention(p.cross, L.rmsnorm(h, p.ln_x, cfg.norm_eps),
                              memory, cfg, kv=(xk, xv))
    return h + _ffn(p, h, cfg), xk, xv


@torch.no_grad()
def encdec_prefill(params: EncDec, tokens: torch.Tensor, cfg: ModelConfig,
                   frames: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Prefill: encode ``frames``, run the decoder over ``tokens``:
    (last-position logits (B, V), the cache of `encdec_cache_init` with
    the self sheets filled up to S and the cross keys / values of every
    layer)."""
    memory = encode(params, frames, cfg)
    B, Sq = tokens.shape
    x = L.embed(params.embed, tokens)
    positions = torch.arange(Sq, device=x.device)[None, :]
    cache = encdec_cache_init(cfg, B, Sq, x.device)
    for i, p in enumerate(params.dec):
        x, k, v = attention_prefill(p, x, cfg, positions)
        x, xk, xv = cross_prefill(p, x, memory, cfg)
        cache["self"]["k"][i] = k.reshape(B, Sq, -1)
        cache["self"]["v"][i] = v.reshape(B, Sq, -1)
        cache["cross_k"][i] = xk.reshape(B, memory.shape[1], -1)
        cache["cross_v"][i] = xv.reshape(B, memory.shape[1], -1)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, x[:, -1:])[:, 0]
    return logits, cache


def _cross_decode(p: L.Attention, x: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One token's cross-attention against the cached memory keys and
    values (B, Sm, KV * hd): float32 scores and softmax, no mask."""
    B = x.shape[0]
    KV, hd, H = cfg.n_kv_heads, cfg.head_dim_, cfg.n_heads
    G = H // KV
    Sm = xk.shape[1]
    xk = xk.reshape(B, Sm, KV, hd)
    xv = xv.reshape(B, Sm, KV, hd)
    q = L.project(x, p.wq)[:, 0]
    if cfg.qk_norm:
        q = L.rmsnorm(q, p.q_norm, cfg.norm_eps)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     xk.float()) / math.sqrt(hd)
    prob = torch.softmax(s, dim=-1).to(xv.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", prob, xv)
    return torch.einsum("bhk,hkd->bd", o.reshape(B, H, hd), p.wo)[:, None]


def dec_block_decode(p: DecBlock, x: torch.Tensor, ck: torch.Tensor,
                     cv: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                     pos: int, cfg: ModelConfig) -> torch.Tensor:
    """One decode step of a `DecBlock`; the self sheets ``ck`` / ``cv``
    are written in place at ``pos``."""
    a, _, _ = L.attention_decode(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps),
                                 ck, cv, pos, cfg)
    h = x + a
    h = h + _cross_decode(p.cross, L.rmsnorm(h, p.ln_x, cfg.norm_eps), xk,
                          xv, cfg)
    return h + _ffn(p, h, cfg)


@torch.no_grad()
def encdec_decode_step(params: EncDec, token: torch.Tensor, cache: Dict,
                       pos: int, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. token: (B,) ids; the self sheets are written in
    place at ``pos``, the cross caches read. Returns (logits (B, V), the
    cache)."""
    x = L.embed(params.embed, token[:, None])
    for i, p in enumerate(params.dec):
        x = dec_block_decode(p, x, cache["self"]["k"][i],
                             cache["self"]["v"][i], cache["cross_k"][i],
                             cache["cross_v"][i], pos, cfg)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, x)[:, 0]
    return logits, cache
