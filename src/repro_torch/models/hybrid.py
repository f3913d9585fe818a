"""SSM (Mamba2) and hybrid (Zamba2) model families: training and serving.

The counterpart of `repro.models.hybrid`. Mamba2 is a stack of SSM mixer
blocks (no MLP, no attention). Zamba2 is a Mamba2 backbone in which ONE
shared transformer block (attention + MLP, one parameter set) runs after
every ``attn_every`` SSM blocks: ``n_layers // attn_every`` groups, each
application with its own KV sheet at decode time. The reference stacks
the blocks on leading axes and scans them; here `Hybrid` holds one
`SSMBlock` per layer (``layers`` for Mamba2, ``groups[g][j]`` for
Zamba2) and Python loops walk them. The SSM caches are layer-major
``(n_layers, ...)`` in both families, as the reference's reshape of its
``(n_groups, attn_every, ...)`` scan output gives them. Decode writes
every cache in place and returns it.

`hybrid_apply` is the training stack (`transformer.lm_loss`'s
``apply_fn``). With grad on, each SSM block and each application of
Zamba2's shared block is checkpointed on its own under ``remat``
(`transformer.remat_call`), as the port's dense family is; the reference
checkpoints a whole Zamba2 group (``jax.checkpoint`` on its ``g_body``).
The recomputation differs, the numbers do not.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (DenseBlock, _ffn,
                                            attention_prefill, block_decode,
                                            check_remat, dense_block,
                                            remat_call)


class SSMBlock(nn.Module):
    """``ln`` + the mixer ``ssm``, a pre-norm residual block."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln = L._param((cfg.d_model,), L.torch_dtype(cfg), device)
        self.ssm = S.SSM(cfg, device)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        self.ln.fill_(1)
        self.ssm.init_(generator, cfg)


class Hybrid(nn.Module):
    """``embed``, ``final_norm`` and, for Mamba2, ``layers`` (one
    `SSMBlock` per layer); for Zamba2, ``groups`` (``n_layers //
    attn_every`` lists of ``attn_every`` `SSMBlock`s) and the one
    ``shared`` `DenseBlock`."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family not in ("ssm", "hybrid") or cfg.block_pattern:
            raise ValueError(f"{cfg.name} is {cfg.family!r}, not an SSM or "
                             "hybrid config of Zamba2's kind (a block "
                             "pattern builds `nemotron_h.NemotronH`)")
        self.embed = L.Embed(cfg, device)
        self.final_norm = L._param((cfg.d_model,), L.torch_dtype(cfg),
                                   device)
        if cfg.family == "hybrid":
            self.groups = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, device)
                              for _ in range(cfg.attn_every))
                for _ in range(cfg.n_layers // cfg.attn_every))
            self.shared = DenseBlock(cfg, device)
        else:
            self.layers = nn.ModuleList(SSMBlock(cfg, device)
                                        for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def ssm_blocks(self):
        """Every `SSMBlock` in layer order (group-major for Zamba2)."""
        if hasattr(self, "groups"):
            return [b for g in self.groups for b in g]
        return list(self.layers)


def hybrid_init(generator: torch.Generator, cfg: ModelConfig,
                device) -> Hybrid:
    """A `Hybrid` on ``device`` with weights drawn from ``generator`` (on
    that device), one matrix at a time."""
    model = Hybrid(cfg, device)
    L.check_generator(generator, model.device)
    with torch.no_grad():
        model.embed.init_(generator, cfg)
        model.final_norm.fill_(1)
        for block in model.ssm_blocks():
            block.init_(generator, cfg)
        if cfg.family == "hybrid":
            model.shared.init_(generator, cfg)
    return model


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def ssm_block(p: SSMBlock, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    y, _ = S.ssm_forward(p.ssm, L.rmsnorm(x, p.ln, cfg.norm_eps), cfg)
    return x + y


def hybrid_apply(params: Hybrid, tokens: torch.Tensor, cfg: ModelConfig,
                 remat: str = "block") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (hidden (B, S, D), aux = 0): embed, the SSM
    blocks in layer order and, for Zamba2, the shared `DenseBlock` after
    every ``attn_every`` of them (flash chunks ``min(512, S)``), then the
    final norm."""
    check_remat(remat)
    x = constrain(L.embed(params.embed, tokens), "batch", "seq", "embed_act")
    qc = min(512, tokens.shape[1])
    for i, block in enumerate(params.ssm_blocks()):
        x = remat_call(ssm_block, block, x, cfg, remat=remat)
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            x = remat_call(dense_block, params.shared, x, cfg, qc, qc,
                           remat=remat)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def hybrid_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"ssm": {"state", "conv"}}`` over all ``n_layers``, and for
    Zamba2 ``"attn": {"k", "v"}`` with one sheet per application of the
    shared block."""
    cache = {"ssm": S.ssm_cache_init(cfg, cfg.n_layers, batch, device)}
    if cfg.family == "hybrid":
        cache["attn"] = L.kv_cache_init(cfg, cfg.n_layers // cfg.attn_every,
                                        batch, max_len, device)
    return cache


def _ssm_block_prefill(p: SSMBlock, x: torch.Tensor, cfg: ModelConfig):
    y, (state, conv) = S.ssm_forward(
        p.ssm, L.rmsnorm(x, p.ln, cfg.norm_eps), cfg, return_cache=True)
    return x + y, state, conv


def _ssm_block_decode(p: SSMBlock, x: torch.Tensor, state, conv,
                      cfg: ModelConfig):
    y, state, conv = S.ssm_decode_step(
        p.ssm, L.rmsnorm(x, p.ln, cfg.norm_eps), state, conv, cfg)
    return x + y, state, conv


@torch.no_grad()
def hybrid_prefill(params: Hybrid, tokens: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict]:
    """Prefill: (last-position logits (B, V), the cache of
    `hybrid_cache_init` filled: every layer's final SSM state and raw
    conv tail, and for Zamba2 each application's keys and values up to
    S)."""
    B, Sq = tokens.shape
    x = L.embed(params.embed, tokens)
    positions = torch.arange(Sq, device=x.device)[None, :]
    cache = hybrid_cache_init(cfg, B, Sq, x.device)
    blocks = params.ssm_blocks()
    for i, block in enumerate(blocks):
        x, state, conv = _ssm_block_prefill(block, x, cfg)
        cache["ssm"]["state"][i] = state
        cache["ssm"]["conv"][i] = conv
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            g = i // cfg.attn_every
            x, k, v = attention_prefill(params.shared, x, cfg, positions)
            x = x + _ffn(params.shared, x, cfg)
            cache["attn"]["k"][g] = k.reshape(B, Sq, -1)
            cache["attn"]["v"][g] = v.reshape(B, Sq, -1)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, x[:, -1:])[:, 0]
    return logits, cache


@torch.no_grad()
def hybrid_decode_step(params: Hybrid, token: torch.Tensor, cache: Dict,
                       pos: int, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. token: (B,) ids; the cache is updated in place
    (the SSM state and conv window of every layer, and for Zamba2 each
    application's KV sheet at ``pos``). Returns (logits (B, V), the
    cache)."""
    x = L.embed(params.embed, token[:, None])
    state, conv = cache["ssm"]["state"], cache["ssm"]["conv"]
    for i, block in enumerate(params.ssm_blocks()):
        x, st, cv = _ssm_block_decode(block, x, state[i], conv[i], cfg)
        state[i] = st
        conv[i] = cv
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            g = i // cfg.attn_every
            x, _, _ = block_decode(params.shared, x, cache["attn"]["k"][g],
                                   cache["attn"]["v"][g], pos, cfg)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, x)[:, 0]
    return logits, cache
