"""Decoder-only transformer stack, dense and MoE families: the training
forward and LM loss, prefill and one decode step.

The counterpart of `repro.models.transformer`. The reference scans over
layers stacked on a leading axis (the MoE family over super-layers of
``moe_every - 1`` dense blocks and one MoE block, after ``n_dense_layers``
leading dense blocks); here a `Transformer` holds one module per block in
the reference's tree: the dense family's ``layers.<i>``, the MoE family's
``lead.<i>`` and ``groups.<g>.dense.<j>`` / ``groups.<g>.moe`` (a
`MoEGroup` per super-layer), so that `optim.optimizers.leaves` stacks them
into the reference's leaves. `Transformer.blocks` lists the blocks in
layer order (`layer_kinds`) and a Python loop walks them (PyTorch runs
eagerly). The MoE family's dense blocks take ``dense_d_ff`` where it is
set. The reference rematerialises each scanned block (``jax.checkpoint``
with ``nothing_saveable`` for ``remat="block"`` and ``"full"``,
``dots_with_no_batch_dims_saveable`` for ``"dots"``); here each block
runs under non-reentrant `torch.utils.checkpoint.checkpoint` while grad
is on (`remat_call`, which the other families' training stacks use too),
so its forward runs again in the backward, under ``"dots"`` with the
outputs of its products with no batch dims kept (`dots_policy`). The
reference's sharding constraints (`dist.sharding.constrain`) stand where
it has them: the identity outside a mesh, a DTensor redistribution under
one (`launch.cells`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import moe as M


class DenseBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``, as the reference's block."""

    def __init__(self, cfg: ModelConfig, device, d_ff: Optional[int] = None):
        super().__init__()
        dt = L.torch_dtype(cfg)
        self.ln1 = L._param((cfg.d_model,), dt, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L._param((cfg.d_model,), dt, device)
        self.mlp = L.MLP(cfg, device, d_ff=d_ff)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        self.ln1.fill_(1)
        self.ln2.fill_(1)
        self.attn.init_(generator, cfg)
        self.mlp.init_(generator, cfg)


class MoEBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``moe``, as the reference's MoE block."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = L.torch_dtype(cfg)
        self.ln1 = L._param((cfg.d_model,), dt, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L._param((cfg.d_model,), dt, device)
        self.moe = M.MoE(cfg, device)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        self.ln1.fill_(1)
        self.ln2.fill_(1)
        self.attn.init_(generator, cfg)
        self.moe.init_(generator, cfg)


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """"dense" or "moe" per layer, in the reference's order: the dense
    family's ``n_layers`` dense blocks; the MoE family's
    ``n_dense_layers`` leading dense blocks, then ``(n_layers -
    n_dense_layers) // moe_every`` super-layers of ``moe_every - 1``
    dense blocks and one MoE block."""
    if cfg.family != "moe":
        return ("dense",) * cfg.n_layers
    group = ("dense",) * (cfg.moe_every - 1) + ("moe",)
    return ("dense",) * cfg.n_dense_layers + group * _n_groups(cfg)


def _n_groups(cfg: ModelConfig) -> int:
    return (cfg.n_layers - cfg.n_dense_layers) // cfg.moe_every


class MoEGroup(nn.Module):
    """One super-layer of the MoE family: ``dense`` (``moe_every - 1``
    `DenseBlock`s, absent when that is 0) and ``moe`` (a `MoEBlock`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.moe_every > 1:
            self.dense = nn.ModuleList(
                DenseBlock(cfg, device, d_ff=cfg.dense_d_ff or None)
                for _ in range(cfg.moe_every - 1))
        self.moe = MoEBlock(cfg, device)

    def blocks(self) -> List[nn.Module]:
        return [*getattr(self, "dense", ()), self.moe]


class Transformer(nn.Module):
    """``embed``, the blocks and ``final_norm``. The dense family's
    blocks are ``layers`` (one `DenseBlock` a layer); the MoE family's
    are ``lead`` (``n_dense_layers`` `DenseBlock`s, absent when 0) and
    ``groups`` (one `MoEGroup` a super-layer), the reference's tree."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"the port's transformer holds the dense and MoE families; "
                f"{cfg.name} is {cfg.family!r}")
        self.embed = L.Embed(cfg, device)
        if cfg.family == "moe":
            if cfg.n_dense_layers:
                self.lead = nn.ModuleList(
                    DenseBlock(cfg, device, d_ff=cfg.dense_d_ff or None)
                    for _ in range(cfg.n_dense_layers))
            self.groups = nn.ModuleList(MoEGroup(cfg, device)
                                        for _ in range(_n_groups(cfg)))
        else:
            self.layers = nn.ModuleList(DenseBlock(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.final_norm = L._param((cfg.d_model,), L.torch_dtype(cfg),
                                   device)

    def blocks(self) -> List[nn.Module]:
        """Every block in layer order (`layer_kinds`): the order of the
        KV cache's layers."""
        if "layers" in self._modules:
            return list(self.layers)
        out = list(getattr(self, "lead", ()))
        for group in self.groups:
            out += group.blocks()
        return out

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def transformer_init(generator: torch.Generator, cfg: ModelConfig,
                     device) -> Transformer:
    """A `Transformer` on ``device`` with weights drawn from
    ``generator`` (which must live on that device): N(0, 0.02^2) matrices,
    output projections scaled by 1/sqrt(2 n_layers), unit norms."""
    model = Transformer(cfg, device)
    L.check_generator(generator, model.device)
    with torch.no_grad():
        model.embed.init_(generator, cfg)
        model.final_norm.fill_(1)
        for block in model.blocks():
            block.init_(generator, cfg)
    return model


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def dense_block(p: DenseBlock, x: torch.Tensor, cfg: ModelConfig,
                q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    x = constrain(x, "batch", "seq", "embed_act")
    h = x + L.attention_train(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps),
                              cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)
    h = h + L.mlp(p.mlp, L.rmsnorm(h, p.ln2, cfg.norm_eps), cfg)
    return h


def moe_block(p: MoEBlock, x: torch.Tensor, cfg: ModelConfig,
              q_chunk: int = 512, kv_chunk: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block's training forward: (output, its aux loss)."""
    x = constrain(x, "batch", "seq", "embed_act")
    h = x + L.attention_train(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps),
                              cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)
    y, aux = M.moe_ffn(p.moe, L.rmsnorm(h, p.ln2, cfg.norm_eps), cfg)
    return h + y, aux


def _ffn(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's feed-forward on its normed input: the MLP of a
    `DenseBlock`, the MoE of a `MoEBlock` (its aux loss dropped, as the
    reference's serving paths drop it)."""
    hn = L.rmsnorm(h, p.ln2, cfg.norm_eps)
    if isinstance(p, MoEBlock):
        return M.moe_ffn(p.moe, hn, cfg)[0]
    return L.mlp(p.mlp, hn, cfg)


def block_decode(p, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 pos: int, cfg: ModelConfig):
    """One decode step of a `DenseBlock` or a `MoEBlock` (the reference's
    ``dense_block_decode`` / ``moe_block_decode``)."""
    a, ck, cv = L.attention_decode(
        p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps), ck, cv, pos, cfg)
    h = x + a
    return h + _ffn(p, h, cfg), ck, cv


def _chunks_for(seq: int) -> Tuple[int, int]:
    c = min(512, seq)
    return c, c


#: the reference's weight on the MoE load-balancing loss (dense: aux = 0)
MOE_AUX_WEIGHT = 0.01
#: remat policies: "block" and "full" keep only a block's input, "dots"
#: also the outputs of its products with no batch dims
REMAT_POLICIES = ("block", "full", "dots")


def check_remat(remat: str) -> None:
    """Raise for an unknown remat policy."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; expected one of "
                         f"{REMAT_POLICIES}")


_aten = torch.ops.aten


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The reference's ``dots_with_no_batch_dims_saveable`` over aten
    ops: keep the output of a product with no batch dims, recompute
    everything else. A weight product ``torch.einsum("bsd,dhk->bshk", x,
    w)`` reaches ``aten.bmm`` with a batch of 1 (``x @ w`` reaches
    ``aten.mm``); the experts' products (a batch of E experts) and the
    attention's (a batch of B x H) are batched and recomputed, as the
    reference recomputes its batched dots and its flash kernel."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(dots_policy)


def remat_call(fn, *args, remat: str = "block"):
    """``fn(*args)``; while grad is on, under non-reentrant
    `torch.utils.checkpoint.checkpoint` (the reference's ``jax.checkpoint``):
    under "block" / "full" (``nothing_saveable``) only the arguments are
    kept and the forward runs again in the backward; under "dots" the
    outputs `dots_policy` keeps are reused in that rerun."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_contexts)
    return checkpoint(fn, *args, use_reentrant=False)


def transformer_apply(params: Transformer, tokens: torch.Tensor,
                      cfg: ModelConfig, remat: str = "block"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (hidden (B, S, D), aux_loss: the sum of the MoE
    blocks' load-balancing losses, 0 for the dense family). While grad is
    on, each block is checkpointed under ``remat`` (`remat_call`): its
    forward runs again in the backward."""
    check_remat(remat)
    qc, kc = _chunks_for(tokens.shape[1])
    x = constrain(L.embed(params.embed, tokens), "batch", "seq", "embed_act")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params.blocks():
        if isinstance(block, MoEBlock):
            x, a = remat_call(moe_block, block, x, cfg, qc, kc,
                              remat=remat)
            aux = aux + a
        else:
            x = remat_call(dense_block, block, x, cfg, qc, kc, remat=remat)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x, aux


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            apply_fn=None, remat: str = "block"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"xent", "aux"}) of ``batch`` ("tokens", "labels", optional
    "mask"): `layers.softmax_xent` of the logits over the padded
    vocabulary, plus the MoE weight times the aux loss. ``apply_fn(params,
    tokens, cfg, remat=)`` -> (hidden, aux) is the family's stack
    (`transformer_apply` by default; `hybrid.hybrid_apply`,
    `encdec.encdec_apply`, `vision.vlm_apply`)."""
    apply_fn = apply_fn or transformer_apply
    x, aux = apply_fn(params, batch["tokens"], cfg, remat=remat)
    logits = constrain(L.lm_logits(params.embed, x), "batch", "seq", "vocab")
    xent = L.softmax_xent(logits, batch["labels"], batch.get("mask"))
    loss = xent + MOE_AUX_WEIGHT * aux
    return loss, {"xent": xent, "aux": aux}


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------

def attention_prefill(p, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor):
    """A block's causal self-attention over the prompt, through the flash
    kernel: (x + attention, k, v), the keys and values for the cache; the
    caller adds the rest of the block."""
    qc, kc = _chunks_for(x.shape[1])
    xn = L.rmsnorm(x, p.ln1, cfg.norm_eps)
    q, k, v = L._project_qkv(p.attn, xn, cfg, positions)
    o = L.chunked_attention(q, k, v, causal=True, q_chunk=qc, kv_chunk=kc)
    return x + torch.einsum("bshk,hkd->bsd", o, p.attn.wo), k, v


@torch.no_grad()
def transformer_prefill(params: Transformer, tokens: torch.Tensor,
                        cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: (last-position logits (B, V), KV cache filled up to S).
    The cache is layer-major ``(L, B, S, KV * hd)``, as `kv_cache_init`
    lays it out."""
    B, S = tokens.shape
    x = L.embed(params.embed, tokens)
    positions = torch.arange(S, device=x.device)[None, :]
    blocks = params.blocks()
    cache = L.kv_cache_init(cfg, len(blocks), B, S, x.device)
    for i, p in enumerate(blocks):
        h, k, v = attention_prefill(p, x, cfg, positions)
        x = h + _ffn(p, h, cfg)
        cache["k"][i] = k.reshape(B, S, -1)
        cache["v"][i] = v.reshape(B, S, -1)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, x[:, -1:])[:, 0]
    return logits, cache


@torch.no_grad()
def transformer_decode_step(params: Transformer, token: torch.Tensor,
                            cache: Dict[str, torch.Tensor], pos: int,
                            cfg: ModelConfig
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. token: (B,) ids; cache: {"k", "v"} of shape (L, B,
    S_max, KV * hd), written in place at ``pos``. Returns (logits (B, V),
    the cache)."""
    x = constrain(L.embed(params.embed, token[:, None]), "batch", None,
                  "embed_act")
    for i, p in enumerate(params.blocks()):
        x, _, _ = block_decode(p, x, cache["k"][i], cache["v"][i], pos,
                               cfg)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, x)[:, 0]
    return logits, cache
