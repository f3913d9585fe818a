"""VLM family (Llama-3.2-Vision backbone): training and serving.

The counterpart of `repro.models.vision`. A decoder-only LM in which
every ``cross_attn_every``-th layer also cross-attends to image patch
embeddings; the vision frontend is a stub, as in the reference (the batch
carries ``patches (B, n_frontend_tokens, frontend_dim)``, the model owns a
linear adapter). The layers come in ``n_layers // cross_attn_every``
groups: ``cross_attn_every - 1`` self-attention `DenseBlock`s (``self``),
then one self + cross + MLP `encdec.DecBlock` (``cross``). The self KV
sheets of all ``n_layers`` are group-major; the cross keys and values are
one pair per group.

`vlm_apply` is the training stack (`transformer.lm_loss`'s ``apply_fn``).
With grad on, each self layer and each `encdec.dec_block` is checkpointed
on its own under ``remat`` (`transformer.remat_call`), as the port's
dense family is; the reference checkpoints a whole group
(``jax.checkpoint`` on its ``g_body``). The recomputation differs, the
numbers do not.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.encdec import (DecBlock, _frontend_dim,
                                       cross_prefill, dec_block,
                                       dec_block_decode, frontend_proj)
from repro_torch.models.transformer import (DenseBlock, _ffn,
                                            attention_prefill, block_decode,
                                            check_remat, dense_block,
                                            remat_call)


class VLMGroup(nn.Module):
    """``self`` (``cross_attn_every - 1`` `DenseBlock`s, absent when that
    is 0) and ``cross`` (one `DecBlock`), the reference's leaf names."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        n_self = cfg.cross_attn_every - 1
        if n_self:
            setattr(self, "self", nn.ModuleList(
                DenseBlock(cfg, device) for _ in range(n_self)))
        self.cross = DecBlock(cfg, device)

    def self_blocks(self):
        return list(getattr(self, "self", ()))

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        for block in (*self.self_blocks(), self.cross):
            block.init_(generator, cfg)


class VLM(nn.Module):
    """``embed``, ``frontend_proj (Df, D)``, ``final_norm`` and ``groups``
    (``n_layers // cross_attn_every`` `VLMGroup`s)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = L.torch_dtype(cfg)
        self.embed = L.Embed(cfg, device)
        self.frontend_proj = L._param((_frontend_dim(cfg), cfg.d_model), dt,
                                      device)
        self.final_norm = L._param((cfg.d_model,), dt, device)
        self.groups = nn.ModuleList(
            VLMGroup(cfg, device)
            for _ in range(cfg.n_layers // cfg.cross_attn_every))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def vlm_init(generator: torch.Generator, cfg: ModelConfig,
             device) -> VLM:
    """A `VLM` on ``device`` with weights drawn from ``generator`` (on
    that device), one matrix at a time."""
    model = VLM(cfg, device)
    L.check_generator(generator, model.device)
    with torch.no_grad():
        model.embed.init_(generator, cfg)
        L.dense_init_(model.frontend_proj, generator)
        model.final_norm.fill_(1)
        for group in model.groups:
            group.init_(generator, cfg)
    return model


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def vlm_apply(params: VLM, tokens: torch.Tensor, cfg: ModelConfig,
              patches: torch.Tensor, remat: str = "block"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S), patches: (B, Sp, Df) -> (hidden (B, S, D), aux =
    0): the adapted patches as the cross-attention memory, then per group
    its self layers and one `encdec.dec_block` (flash chunks ``min(512,
    S)``), then the final norm."""
    check_remat(remat)
    memory = frontend_proj(params.frontend_proj, patches, cfg)
    x = constrain(L.embed(params.embed, tokens), "batch", "seq", "embed_act")
    qc = min(512, tokens.shape[1])
    for group in params.groups:
        for p in group.self_blocks():
            x = remat_call(dense_block, p, x, cfg, qc, qc, remat=remat)
        x = remat_call(dec_block, group.cross, x, memory, cfg, qc,
                           remat=remat)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def vlm_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   device) -> Dict:
    """``{"self": {"k", "v"}}`` of ``(n_layers, B, max_len, KV * hd)``,
    group-major, and ``cross_k`` / ``cross_v`` of ``(n_groups, B, Sp, KV *
    hd)``."""
    n_groups = cfg.n_layers // cfg.cross_attn_every
    shape = (n_groups, batch, cfg.n_frontend_tokens,
             cfg.n_kv_heads * cfg.head_dim_)
    dt = L.torch_dtype(cfg)
    return {"self": L.kv_cache_init(cfg, cfg.n_layers, batch, max_len,
                                    device),
            "cross_k": torch.zeros(shape, dtype=dt, device=device),
            "cross_v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
def vlm_prefill(params: VLM, tokens: torch.Tensor, cfg: ModelConfig,
                patches: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Prefill over ``tokens`` with ``patches`` as the cross-attention
    memory: (last-position logits (B, V), the cache of `vlm_cache_init`
    filled up to S)."""
    memory = frontend_proj(params.frontend_proj, patches, cfg)
    B, Sq = tokens.shape
    Sm = memory.shape[1]
    x = L.embed(params.embed, tokens)
    positions = torch.arange(Sq, device=x.device)[None, :]
    cache = vlm_cache_init(cfg, B, Sq, x.device)
    layer = 0
    for g, group in enumerate(params.groups):
        for p in (*group.self_blocks(), group.cross):
            x, k, v = attention_prefill(p, x, cfg, positions)
            cache["self"]["k"][layer] = k.reshape(B, Sq, -1)
            cache["self"]["v"][layer] = v.reshape(B, Sq, -1)
            layer += 1
            if p is group.cross:
                x, xk, xv = cross_prefill(p, x, memory, cfg)
                cache["cross_k"][g] = xk.reshape(B, Sm, -1)
                cache["cross_v"][g] = xv.reshape(B, Sm, -1)
            else:
                x = x + _ffn(p, x, cfg)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, x[:, -1:])[:, 0]
    return logits, cache


@torch.no_grad()
def vlm_decode_step(params: VLM, token: torch.Tensor, cache: Dict, pos: int,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step. token: (B,) ids; the self sheets are written in
    place at ``pos``, the cross caches read. Returns (logits (B, V), the
    cache)."""
    x = L.embed(params.embed, token[:, None])
    ck, cv = cache["self"]["k"], cache["self"]["v"]
    layer = 0
    for g, group in enumerate(params.groups):
        for p in group.self_blocks():
            x, _, _ = block_decode(p, x, ck[layer], cv[layer], pos, cfg)
            layer += 1
        x = dec_block_decode(group.cross, x, ck[layer], cv[layer],
                             cache["cross_k"][g], cache["cross_v"][g], pos,
                             cfg)
        layer += 1
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, x)[:, 0]
    return logits, cache
