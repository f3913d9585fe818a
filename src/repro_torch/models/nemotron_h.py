"""The pattern-driven hybrid stack (Nemotron-H): training and serving.

``cfg.block_pattern`` lays out the model one character a block, each a
pre-norm residual block ``x + mixer(rmsnorm(x))`` of its own kind:

* ``M``: the Mamba-2 mixer (`ssm.ssm_forward`, with ``cfg.ssm_groups``
  groups of B and C and the gated norm per group);
* ``E``: the MoE (`moe.moe_ffn`: the sigmoid router with its selection
  bias, dropless dispatch, relu^2 experts and the shared expert);
* ``*``: causal GQA self-attention, without RoPE when ``cfg.use_rope`` is
  False (Nemotron-H applies no position encoding).

`NemotronH` holds ``embed``, ``blocks`` (one module a block, in pattern
order: ``blocks.<i>.ln`` and ``blocks.<i>.ssm`` / ``.moe`` / ``.attn``)
and ``final_norm``. The serving cache holds two kinds of state
side by side: ``{"ssm": {"state", "conv"}}`` over the M blocks in order
(`ssm.ssm_cache_init`) and ``{"attn": {"k", "v"}}`` over the attention
blocks (`layers.kv_cache_init`); `serve.generate` pads the latter for the
decoded ids. Prefill computes the head on each sequence's last position
only, and hands each block's input and mixer output and the final norm's
input to the ``block`` and ``final`` taps (`obs.taps`). `pattern_apply` is the training stack (`transformer.lm_loss`'s
``apply_fn``), each block checkpointed under ``remat``; the sigmoid
router trains without a load-balancing loss (aux 0).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.transformer import _chunks_for, check_remat, remat_call
from repro_torch.obs import taps

#: pattern character -> the block's mixer attribute
MIXERS = {"M": "ssm", "E": "moe", "*": "attn"}


class PatternBlock(nn.Module):
    """``ln`` and one mixer, named by the block's kind (`MIXERS`)."""

    def __init__(self, kind: str, cfg: ModelConfig, device):
        super().__init__()
        self.kind = kind
        self.ln = L._param((cfg.d_model,), L.torch_dtype(cfg), device)
        make = {"M": S.SSM, "E": M.MoE, "*": L.Attention}[kind]
        setattr(self, MIXERS[kind], make(cfg, device))

    @property
    def mixer(self) -> nn.Module:
        return getattr(self, MIXERS[self.kind])

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        self.ln.fill_(1)
        self.mixer.init_(generator, cfg)


def check_pattern(cfg: ModelConfig) -> None:
    bad = set(cfg.block_pattern) - set(MIXERS)
    if not cfg.block_pattern or bad or len(cfg.block_pattern) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: block_pattern {cfg.block_pattern!r} "
                         f"must hold {cfg.n_layers} of {sorted(MIXERS)}")


class NemotronH(nn.Module):
    """``embed``, ``blocks`` (a `PatternBlock` per pattern character) and
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_pattern(cfg)
        self.embed = L.Embed(cfg, device)
        self.blocks = nn.ModuleList(PatternBlock(k, cfg, device)
                                    for k in cfg.block_pattern)
        self.final_norm = L._param((cfg.d_model,), L.torch_dtype(cfg),
                                   device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def pattern_init(generator: torch.Generator, cfg: ModelConfig,
                 device) -> NemotronH:
    """A `NemotronH` on ``device`` with weights drawn from ``generator``
    (on that device), block by block."""
    model = NemotronH(cfg, device)
    L.check_generator(generator, model.device)
    with torch.no_grad():
        model.embed.init_(generator, cfg)
        model.final_norm.fill_(1)
        for block in model.blocks:
            block.init_(generator, cfg)
    return model


def _count(cfg: ModelConfig, kind: str) -> int:
    return cfg.block_pattern.count(kind)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _attend(p: L.Attention, h: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor):
    """Causal self-attention of normed ``h`` through the flash kernel:
    (output, k, v)."""
    qc, kc = _chunks_for(h.shape[1])
    q, k, v = L._project_qkv(p, h, cfg, positions)
    o = L.chunked_attention(q, k, v, causal=True, q_chunk=qc, kv_chunk=kc)
    return torch.einsum("bshk,hkd->bsd", o, p.wo), k, v


def block_apply(p: PatternBlock, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's training forward: (x + mixer(rmsnorm(x)), its aux
    loss)."""
    h = L.rmsnorm(x, p.ln, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if p.kind == "M":
        y, _ = S.ssm_forward(p.ssm, h, cfg)
    elif p.kind == "E":
        y, aux = M.moe_ffn(p.moe, h, cfg)
    else:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        y = _attend(p.attn, h, cfg, positions)[0]
    return x + y, aux


def pattern_apply(params: NemotronH, tokens: torch.Tensor, cfg: ModelConfig,
                  remat: str = "block") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (hidden (B, S, D), the MoE blocks' aux losses
    summed): embed, the blocks in pattern order, the final norm."""
    check_remat(remat)
    x = L.embed(params.embed, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params.blocks:
        x, a = remat_call(block_apply, block, x, cfg, remat=remat)
        aux = aux + a
    return L.rmsnorm(x, params.final_norm, cfg.norm_eps), aux


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def pattern_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                       device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"ssm": {"state", "conv"}}`` over the M blocks and ``{"attn":
    {"k", "v"}}`` over the attention blocks, each in pattern order."""
    cache = {}
    if _count(cfg, "M"):
        cache["ssm"] = S.ssm_cache_init(cfg, _count(cfg, "M"), batch, device)
    if _count(cfg, "*"):
        cache["attn"] = L.kv_cache_init(cfg, _count(cfg, "*"), batch,
                                        max_len, device)
    return cache


def _slots(cfg: ModelConfig) -> List[int]:
    """Each block's index among the blocks of its kind (its cache row)."""
    seen: Dict[str, int] = {}
    out = []
    for kind in cfg.block_pattern:
        out.append(seen.get(kind, 0))
        seen[kind] = out[-1] + 1
    return out


@torch.no_grad()
def pattern_prefill(params: NemotronH, tokens: torch.Tensor,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Prefill: (last-position logits (B, V), the cache of
    `pattern_cache_init` filled: each M block's final SSM state and raw
    conv tail, each attention block's keys and values up to S)."""
    B, Sq = tokens.shape
    x = L.embed(params.embed, tokens)
    positions = torch.arange(Sq, device=x.device)[None, :]
    cache = pattern_cache_init(cfg, B, Sq, x.device)
    for i, (block, slot) in enumerate(zip(params.blocks, _slots(cfg))):
        h = L.rmsnorm(x, block.ln, cfg.norm_eps)
        if block.kind == "M":
            y, (state, conv) = S.ssm_forward(block.ssm, h, cfg,
                                             return_cache=True)
            cache["ssm"]["state"][slot] = state
            cache["ssm"]["conv"][slot] = conv
        elif block.kind == "*":
            y, k, v = _attend(block.attn, h, cfg, positions)
            cache["attn"]["k"][slot] = k.reshape(B, Sq, -1)
            cache["attn"]["v"][slot] = v.reshape(B, Sq, -1)
        else:
            y = M.moe_ffn(block.moe, h, cfg)[0]
        taps.emit("block", index=i, x=x, y=y)
        x = x + y
        del h, y
    taps.emit("final", x=x[:, -1])
    x = L.rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return L.lm_logits(params.embed, x)[:, 0], cache


@torch.no_grad()
def pattern_decode_step(params: NemotronH, token: torch.Tensor, cache: Dict,
                        pos: int, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. token: (B,) ids; the cache is updated in place
    (each M block's state and conv window, each attention block's sheets
    at ``pos``). Returns (logits (B, V), the cache)."""
    x = L.embed(params.embed, token[:, None])
    for block, slot in zip(params.blocks, _slots(cfg)):
        h = L.rmsnorm(x, block.ln, cfg.norm_eps)
        if block.kind == "M":
            ssm = cache["ssm"]
            y, ssm["state"][slot], ssm["conv"][slot] = S.ssm_decode_step(
                block.ssm, h, ssm["state"][slot], ssm["conv"][slot], cfg)
        elif block.kind == "*":
            y, _, _ = L.attention_decode(block.attn, h, cache["attn"]["k"][slot],
                                         cache["attn"]["v"][slot], pos, cfg)
        else:
            y = M.moe_ffn(block.moe, h, cfg)[0]
        x = x + y
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return L.lm_logits(params.embed, x)[:, 0], cache
