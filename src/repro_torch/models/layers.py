"""Core transformer layers: norms, RoPE, GQA attention, MLP, embedding.

The counterpart of `repro.models.layers`. Parameters live in `nn.Module`s
in the reference's layouts (``wq (D, H, hd)``, ``wi (D, 2, F)``, ``head (D,
V)``, ...), so a JAX parameter tree carries across as a copy
(`repro_torch.convert.model_params_from_reference`). The functions keep
the reference's names and cast points: statistics, RoPE, the SwiGLU gate
and the softmax in float32, activations in ``cfg.dtype``.

Train and prefill attention run `kernels.ops.flash_attention`: the CUDA
kernels on the card and their plain versions on the CPU; the device is
the only selector, and with grad on it is differentiable through the
backward kernel. The reference's ``attention_backend`` ("chunked", its
online softmax in ``jnp``, or "flash", its Pallas kernel) and
``attention_remat`` (a checkpoint per query chunk) context managers,
which `launch.cells` sets from a cell's plan, keep their names and
values here, but both backends reach the flash kernels: the flash
`torch.autograd.Function` saves q, k, v, o and the logsumexp rows, so no
O(S^2) state arises to rematerialise, and the plain version stays off
the card. The two record what was asked (`current_attention`) and
refuse an unknown backend. Decode attention is plain
PyTorch, as the reference's is plain ``jnp``; it writes the new key and
value into the cache in place where the reference returns an updated
copy (``dynamic_update_slice``).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

INIT_STD = 0.02
NEG_INF = -1e30


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter (filled by `init_` or a carried-across
    copy); serving needs no gradients, and the train step turns them on
    (`train.step.trainable`)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def check_generator(generator: torch.Generator,
                    device: torch.device) -> None:
    """Raise unless ``generator`` lives on ``device``'s type: an init
    draws on the model's device."""
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"model on {device}")


@torch.no_grad()
def dense_init_(p: torch.Tensor, generator: torch.Generator,
                std: float = INIT_STD) -> None:
    """Fill ``p`` with N(0, std^2) drawn in float32, then cast."""
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                    device=p.device)
    p.copy_(x * std)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """`rope_freqs` as float32 on ``device``, copied there once: a copy
    per call would stall the host on the device's queue every layer."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs      # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]              # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------

class Attention(nn.Module):
    """``wq (D, H, hd)``, ``wk`` / ``wv (D, KV, hd)``, ``wo (H, hd, D)``;
    ``bq`` / ``bk`` / ``bv`` with ``qkv_bias``, ``q_norm`` / ``k_norm``
    with ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D = cfg.d_model
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        dt = torch_dtype(cfg)
        self.wq = _param((D, H, hd), dt, device)
        self.wk = _param((D, KV, hd), dt, device)
        self.wv = _param((D, KV, hd), dt, device)
        self.wo = _param((H, hd, D), dt, device)
        if cfg.qkv_bias:
            self.bq = _param((H, hd), dt, device)
            self.bk = _param((KV, hd), dt, device)
            self.bv = _param((KV, hd), dt, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), dt, device)
            self.k_norm = _param((hd,), dt, device)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        dense_init_(self.wq, generator)
        dense_init_(self.wk, generator)
        dense_init_(self.wv, generator)
        dense_init_(self.wo, generator,
                    INIT_STD / np.sqrt(2 * max(cfg.n_layers, 1)))
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        for name in ("q_norm", "k_norm"):
            if hasattr(self, name):
                getattr(self, name).fill_(1)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)``: x (B, S, D) times w (D, A, C),
    a head projection (D, H, hd) or SwiGLU's fused ``wi`` (D, 2, F).

    On DTensors (a mesh) the product runs in a `local_map` region, laid
    out as the reference's rules lay it out: w's D axis (``fsdp``)
    gathered, its other axes sharded where w has them sharded, x's batch
    and sequence sharded where x has them; x is replicated over the axes
    that shard w. DTensor's own product would flatten ``A * C`` and may
    shard it over more ranks than ``A`` (8 KV heads, or SwiGLU's 2, on a
    model axis of 16), which no split back into (A, C) can keep."""
    if not isinstance(x, DTensor):
        return torch.einsum("bsd,dhk->bshk", x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.hlocost import per_shard
    mesh = x.device_mesh
    w_pl = tuple(q if isinstance(q, Shard) and q.dim > 0 else Replicate()
                 for q in w.placements)
    on_w = [isinstance(q, Shard) for q in w_pl]
    x_pl = tuple(Replicate() if s or not isinstance(q, Shard) or q.dim > 1
                 else q for s, q in zip(on_w, x.placements))
    out_pl = tuple(Shard(q.dim + 1) if s else r
                   for s, q, r in zip(on_w, w_pl, x_pl))
    x_grad = tuple(Partial() if s else q for s, q in zip(on_w, x_pl))
    w_grad = tuple(Partial() if isinstance(q, Shard) else p
                   for q, p in zip(x_pl, w_pl))
    shards = 1
    for q, n in zip(out_pl, mesh.shape):
        shards *= n if isinstance(q, Shard) else 1
    return local_map(
        per_shard(lambda a, b: torch.einsum("bsd,dhk->bshk", a, b), shards),
        out_placements=(out_pl,), in_placements=(x_pl, w_pl),
        in_grad_placements=(x_grad, w_grad), device_mesh=mesh,
        redistribute_inputs=True)(x, w)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, rope: bool = True):
    q, k, v = project(x, p.wq), project(x, p.wk), project(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if rope and cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


#: the reference's attention backends (`attention_backend`)
ATTENTION_BACKENDS = ("chunked", "flash")
_ATTN = {"remat": False, "backend": "chunked"}


@contextlib.contextmanager
def attention_remat(enabled: bool = True):
    """The reference's per-query-chunk checkpoint switch. Recorded only:
    the flash Function keeps no O(S^2) state to recompute."""
    prev = _ATTN["remat"]
    _ATTN["remat"] = bool(enabled)
    try:
        yield
    finally:
        _ATTN["remat"] = prev


@contextlib.contextmanager
def attention_backend(name: str):
    """The reference's attention backend, ``"chunked"`` or ``"flash"``;
    any other name raises. Both run `kernels.ops.flash_attention` here."""
    if name not in ATTENTION_BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}; expected "
                         f"one of {ATTENTION_BACKENDS}")
    prev = _ATTN["backend"]
    _ATTN["backend"] = name
    try:
        yield
    finally:
        _ATTN["backend"] = prev


def current_attention() -> dict:
    """The innermost ``{"remat": ..., "backend": ...}`` asked for."""
    return dict(_ATTN)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_chunk: int = 512,
                      kv_chunk: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd): the
    flash kernel on CUDA tensors, its plain version (the reference's
    online softmax over ``q_chunk`` x ``kv_chunk`` blocks) on CPU
    tensors."""
    return kops.flash_attention(q, k, v, causal=causal, block_q=q_chunk,
                                block_k=kv_chunk)


def attention_train(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill)."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


def cross_attention(p: Attention, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig, kv=None) -> torch.Tensor:
    """x: (B, Sq, D) queries; memory: (B, Sm, D) keys and values. No RoPE,
    not causal; the flash kernel at the reference's 512 x 512 blocks.
    ``kv``: the projections ``(memory wk, memory wv)`` where the caller
    has them already (the serving prefill caches them), else computed
    here."""
    q = project(x, p.wq)
    if kv is None:
        kv = (project(memory, p.wk), project(memory, p.wv))
    k, v = kv
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    o = chunked_attention(q, k, v, causal=False)
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


# ---- decode path ---------------------------------------------------------

def kv_cache_init(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                  device) -> dict:
    """Zeroed ``(n_layers, batch, max_len, KV * hd)`` key and value sheets
    (the reference's flat trailing layout)."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads * cfg.head_dim_)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attention_decode(p: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); cache_{k,v}: (B, S_max, KV*hd),
    written in place at ``pos``; returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    S_max = cache_k.shape[1]
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    H = cfg.n_heads
    G = H // KV
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    cache_k[:, pos] = k.reshape(B, KV * hd)
    cache_v[:, pos] = v.reshape(B, KV * hd)
    k4 = cache_k.reshape(B, S_max, KV, hd)
    v4 = cache_v.reshape(B, S_max, KV, hd)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k4.float()) / math.sqrt(hd)
    valid = torch.arange(S_max, device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    prob = torch.softmax(s, dim=-1).to(v4.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", prob, v4)
    out = torch.einsum("bhk,hkd->bd", o.reshape(B, H, hd), p.wo)[:, None, :]
    return out, cache_k, cache_v


# --------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU: ``wi (D, 2, F)`` (gate and up fused on the output dim),
    ``wo (F, D)``; GELU and relu^2: ``wi (D, F)``, ``wo (F, D)``. ``F`` is ``d_ff``
    where given (the MoE family's dense layers and shared experts), else
    ``cfg.d_ff``."""

    def __init__(self, cfg: ModelConfig, device, d_ff: Optional[int] = None):
        super().__init__()
        D, F = cfg.d_model, d_ff or cfg.d_ff
        dt = torch_dtype(cfg)
        wi_shape = (D, 2, F) if cfg.mlp_kind == "swiglu" else (D, F)
        self.wi = _param(wi_shape, dt, device)
        self.wo = _param((F, D), dt, device)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        dense_init_(self.wi, generator)
        dense_init_(self.wo, generator,
                    INIT_STD / np.sqrt(2 * max(cfg.n_layers, 1)))


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        h = project(x, p.wi)                 # einsum("bsd,dcf->bscf")
        gate, up = h[:, :, 0], h[:, :, 1]
        a = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    elif cfg.mlp_kind == "relu2":
        a = relu2(torch.einsum("bsd,df->bsf", x, p.wi))
    else:
        h = torch.einsum("bsd,df->bsf", x, p.wi)
        a = torch.nn.functional.gelu(h.float(),
                                     approximate="tanh").to(x.dtype)
    return torch.einsum("bsf,fd->bsd", a, p.wo)


def relu2(h: torch.Tensor) -> torch.Tensor:
    """Squared ReLU in ``h``'s dtype (Nemotron-H's ``relu2``)."""
    h = torch.relu(h)
    return h * h


# --------------------------------------------------------------------------
# Embedding / LM head
# --------------------------------------------------------------------------

class Embed(nn.Module):
    """``tok (V, D)`` and an untied ``head (D, V)`` over the padded
    vocabulary."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        V, D = cfg.padded_vocab, cfg.d_model
        dt = torch_dtype(cfg)
        self.tok = _param((V, D), dt, device)
        self.head = _param((D, V), dt, device)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        dense_init_(self.tok, generator)
        dense_init_(self.head, generator)


def embed(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(p.tok, DTensor):
        return _embed_on_mesh(p.tok, tokens)
    return p.tok[tokens]


def _embed_on_mesh(tok: DTensor, tokens: torch.Tensor) -> DTensor:
    """The lookup with the table on a mesh, in a `local_map` region laid
    out as the reference's rules lay it out: the table's D axis
    (``fsdp``) gathered, its vocabulary sharded where the table has it
    sharded, the ids' batch sharded where theirs is. Each rank looks up
    the ids that fall in its slice of the vocabulary and leaves zeros
    for the rest, so the rows are a sum over the vocabulary's axes
    (``Partial``). DTensor's own indexing has no rule for its backward on
    a sharded table in torch 2.11, nor its embedding one for the batch
    and the vocabulary both sharded in 2.13."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.hlocost import per_shard
    mesh = tok.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    vocab = [q == Shard(0) for q in tok.placements]
    t_pl = tuple(Shard(0) if v else Replicate() for v in vocab)
    i_pl = tuple(Replicate() if v or not isinstance(q, Shard) else q
                 for v, q in zip(vocab, tokens.placements))
    out_pl = tuple(Partial() if v else q for v, q in zip(vocab, i_pl))
    t_grad = tuple(Partial() if isinstance(q, Shard) else p
                   for q, p in zip(i_pl, t_pl))
    first, shards = 0, 1
    for v, q, name, n in zip(vocab, i_pl, mesh.mesh_dim_names, mesh.shape):
        if v:                   # this rank's slice of the vocabulary
            first = first * n + mesh.get_local_rank(name)
        elif isinstance(q, Shard):
            shards *= n
    n_vocab = math.prod(n for v, n in zip(vocab, mesh.shape) if v)
    v0 = first * (tok.shape[0] // n_vocab)

    def local(table, ids):
        ids = ids.long() - v0
        hit = (ids >= 0) & (ids < table.shape[0])
        rows = table[ids.clamp(0, table.shape[0] - 1)]
        return rows * hit[..., None].to(table.dtype)

    return local_map(per_shard(local, shards), out_placements=(out_pl,),
                     in_placements=(t_pl, i_pl),
                     in_grad_placements=(t_grad, i_pl), device_mesh=mesh,
                     redistribute_inputs=True)(tok, tokens)


def lm_logits(p: Embed, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dv->bsv", x, p.head)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Mean cross-entropy over valid positions, float32, with z-loss. The
    logsumexp runs over every column of ``logits``: the padded vocabulary
    of `lm_logits`, as the reference's does."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # the picked logit keeps its trailing axis until it meets lse: on a
    # mesh, a vocab-sharded gather is a masked partial sum that DTensor
    # reduces at that first use, in the gather's own shape
    ll = torch.gather(logits, -1, labels.long()[..., None])
    loss = (lse[..., None] - ll)[..., 0] + z_loss * lse * lse
    if mask is not None:
        return (loss * mask).sum() / mask.sum().clamp_min(1)
    return loss.mean()
