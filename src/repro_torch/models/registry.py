"""Model registry: the reference's `ModelBundle` API over every family.

    bundle = build(cfg)                     # device="cuda" unless asked
    params = bundle.init(torch.Generator("cuda").manual_seed(0))
    loss, metrics = bundle.loss(params, batch)
    logits, cache = bundle.prefill(params, {"tokens": tokens})
    logits, cache = bundle.decode_step(params, token, cache, pos)

The counterpart of `repro.models.registry`, with the same field names.
``params`` is the family's `nn.Module` on the bundle's device: a
`transformer.Transformer` (dense, MoE), `hybrid.Hybrid` (SSM, hybrid),
`nemotron_h.NemotronH` (a hybrid laid out by ``cfg.block_pattern``),
`encdec.EncDec` or `vision.VLM`. The enc-dec and VLM prefills take the
frontend's stub embeddings from the batch (``frames`` / ``patches``).
Token tensors and frontend embeddings keep their device; host arrays
(numpy, lists) go to the model's device; tensors on another device than
the model raise. ``loss`` trains every family, through
`transformer.lm_loss` with the family's stack as its ``apply_fn``
(`transformer.transformer_apply` for the dense and MoE families, the
MoE's load-balancing loss in ``metrics["aux"]`` and weighted into the
loss; `hybrid.hybrid_apply`, `encdec.encdec_apply` over
``batch["frames"]``, `vision.vlm_apply` over ``batch["patches"]``), as
the reference's ``build`` does.

``abstract()`` returns ``(shapes, specs)`` without allocating: ``shapes``
is the family's `nn.Module` built on the ``meta`` device (its
``named_parameters()`` give every parameter's shape and dtype, and it
runs as ``params`` under `launch.hlocost.count`), ``specs`` maps each
parameter name to its logical-axis names (`param_spec`). The reference
stacks a block's parameters on one leading ``"layers"`` axis per level of
stacking (``layers.attn.wq`` of shape ``(L, D, H, hd)``, spec
``("layers", "fsdp", "heads", "head_dim")``); the port keeps one module
per block, so its leaf ``layers.<i>.attn.wq`` is that leaf's ``i``-th
slice, ``(D, H, hd)`` with spec ``("fsdp", "heads", "head_dim")``: drop
one leading ``"layers"`` for each layer index in the name
(`optim.optimizers.leaves` stacks them back). `input_specs` and
`batch_logical_specs` give each (arch, shape) cell's inputs as ``meta``
tensors and their logical names.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, operand_device, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import frontend_name
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import nemotron_h as NH
from repro_torch.models import transformer as TF
from repro_torch.models import vision as VI

Params = Dict[str, Any]

@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable            # generator -> params
    abstract: Callable        # () -> (module on meta, logical specs)
    loss: Callable            # (params, batch) -> (loss, metrics)
    prefill: Callable         # (params, batch) -> (logits, cache)
    decode_step: Callable     # (params, token, cache, pos) -> (logits, cache)
    cache_init: Callable      # (batch, max_len) -> cache
    device: torch.device      # where init puts the weights


def _device_of(x, params) -> torch.device:
    """The device of operand ``x`` for ``params``: the model's (a model on
    ``meta``, from `abstract`, takes the ``meta`` stand-ins of
    `input_specs`)."""
    if params.device.type != "meta":
        return operand_device([x], params.device)
    if not (isinstance(x, torch.Tensor) and x.is_meta):
        raise ValueError(f"operands lie on different devices: a model on "
                         f"meta takes meta operands, not "
                         f"{getattr(x, 'device', type(x).__name__)}")
    return x.device


def _tokens(x, params) -> torch.Tensor:
    """Token ids as an int64 tensor on the model's device."""
    return torch.as_tensor(x, device=_device_of(x, params)).long()


def _frontend(batch: Dict[str, Any], name: str, params) -> torch.Tensor:
    """The batch's frontend embeddings ``batch[name]`` as a tensor on the
    model's device (their dtype kept; the model casts them)."""
    if batch.get(name) is None:
        raise ValueError(f"this model reads batch[{name!r}], the "
                         "frontend's stub embeddings")
    x = batch[name]
    dev = _device_of(x, params)
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)


def _batch(batch: Dict[str, Any], params,
           cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A training batch's tokens and labels as int64, its mask as
    float32 and, for a model with a frontend, its stub embeddings
    (`_frontend`), on the model's device."""
    out = {k: _tokens(batch[k], params) for k in ("tokens", "labels")}
    if batch.get("mask") is not None:
        dev = _device_of(batch["mask"], params)
        out["mask"] = torch.as_tensor(batch["mask"], device=dev).float()
    front = frontend_name(cfg)
    if front:
        out[front] = _frontend(batch, front, params)
    return out


def _apply_fn(cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """The family's training stack as `transformer.lm_loss`'s
    ``apply_fn``, bound to the batch's frontend embeddings."""
    if cfg.block_pattern:
        return NH.pattern_apply
    if cfg.family in ("ssm", "hybrid"):
        return HY.hybrid_apply
    if cfg.family == "encdec":
        return functools.partial(ED.encdec_apply, frames=batch["frames"])
    if cfg.family == "vlm":
        return functools.partial(VI.vlm_apply, patches=batch["patches"])
    return TF.transformer_apply


def _family(cfg: ModelConfig, dev: torch.device):
    """(init, prefill, decode_step, cache_init) over the family's
    functions, each taking the bundle's arguments."""
    if cfg.block_pattern:
        return (lambda g: NH.pattern_init(g, cfg, dev),
                lambda p, b: NH.pattern_prefill(
                    p, _tokens(b["tokens"], p), cfg),
                NH.pattern_decode_step,
                lambda batch, max_len: NH.pattern_cache_init(
                    cfg, batch, max_len, dev))
    if cfg.family in ("dense", "moe"):
        return (lambda g: TF.transformer_init(g, cfg, dev),
                lambda p, b: TF.transformer_prefill(
                    p, _tokens(b["tokens"], p), cfg),
                TF.transformer_decode_step,
                lambda batch, max_len: L.kv_cache_init(
                    cfg, len(TF.layer_kinds(cfg)), batch, max_len, dev))
    if cfg.family in ("ssm", "hybrid"):
        return (lambda g: HY.hybrid_init(g, cfg, dev),
                lambda p, b: HY.hybrid_prefill(
                    p, _tokens(b["tokens"], p), cfg),
                HY.hybrid_decode_step,
                lambda batch, max_len: HY.hybrid_cache_init(
                    cfg, batch, max_len, dev))
    if cfg.family == "encdec":
        return (lambda g: ED.encdec_init(g, cfg, dev),
                lambda p, b: ED.encdec_prefill(
                    p, _tokens(b["tokens"], p), cfg,
                    frames=_frontend(b, "frames", p)),
                ED.encdec_decode_step,
                lambda batch, max_len: ED.encdec_cache_init(
                    cfg, batch, max_len, dev))
    if cfg.family == "vlm":
        return (lambda g: VI.vlm_init(g, cfg, dev),
                lambda p, b: VI.vlm_prefill(
                    p, _tokens(b["tokens"], p), cfg,
                    patches=_frontend(b, "patches", p)),
                VI.vlm_decode_step,
                lambda batch, max_len: VI.vlm_cache_init(
                    cfg, batch, max_len, dev))
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


META = torch.device("meta")

_ATTN_SPECS = {
    "wq": ("fsdp", "heads", "head_dim"),
    "wk": ("fsdp", "kv_heads", "head_dim"),
    "wv": ("fsdp", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "fsdp"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "q_norm": ("head_dim",),
    "k_norm": ("head_dim",),
}
#: the MLP's ``wi`` by rank: SwiGLU's fused ``(D, 2, F)``, GELU's ``(D, F)``
_MLP_SPECS = {"wi": {3: ("fsdp", None, "mlp"), 2: ("fsdp", "mlp")},
              "wo": ("mlp", "fsdp")}
#: the reference's logical names of a per-block parameter, by the module
#: that owns it (the name's last part but one) and its own name
_PARAM_SPECS: Dict[str, Dict[str, Any]] = {
    "embed": {"tok": ("vocab", "fsdp"), "head": ("fsdp", "vocab")},
    "attn": _ATTN_SPECS,
    "cross": _ATTN_SPECS,
    "mlp": _MLP_SPECS,
    "shared": _MLP_SPECS,          # the MoE's shared experts, an MLP
    "moe": {"router": ("fsdp", None),
            "e_bias": (None,),
            "wi": {4: ("experts", "fsdp", None, "mlp"),
                   3: ("experts", "fsdp", "mlp")},
            "wo": ("experts", "mlp", "fsdp")},
    "ssm": {"in_proj": ("fsdp", "ssm_inner"),
            "conv_w": (None, "ssm_inner"),
            "conv_b": ("ssm_inner",),
            "a_log": ("ssm_heads",),
            "d_skip": ("ssm_heads",),
            "dt_bias": ("ssm_heads",),
            "norm": ("ssm_inner",),
            "out_proj": ("ssm_inner", "fsdp")},
}
#: the norm scales, ``("embed",)`` wherever they sit
_NORMS = ("ln", "ln1", "ln2", "ln_x", "final_norm", "enc_norm")
#: the cache's leaves by name (`batch_logical_specs`)
_CACHE_SPECS = {
    "k": ("layers", "batch", "kv_seq", "kv_flat"),
    "v": ("layers", "batch", "kv_seq", "kv_flat"),
    "cross_k": ("layers", "batch", None, "kv_flat"),
    "cross_v": ("layers", "batch", None, "kv_flat"),
    "state": ("layers", "batch", "ssm_heads", None, None),
    "conv": ("layers", "batch", None, "ssm_inner"),
}


def param_spec(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical-axis names of the port's parameter ``name`` (of rank
    ``ndim``): the reference's spec of its leaf without the leading
    ``"layers"`` of each stacking level (the module docstring)."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    leaf, owner = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if leaf in _NORMS:
        spec = ("embed",)
    elif leaf == "frontend_proj":
        spec = (None, "embed")
    else:
        spec = _PARAM_SPECS.get(owner, {}).get(leaf)
        if isinstance(spec, dict):
            spec = spec.get(ndim)
    if spec is None or len(spec) != ndim:
        raise KeyError(f"no logical spec for parameter {name!r} of rank "
                       f"{ndim}")
    return spec


def _module(cfg: ModelConfig):
    """The family's model class."""
    if cfg.block_pattern:
        return NH.NemotronH
    if cfg.family in ("dense", "moe"):
        return TF.Transformer
    if cfg.family in ("ssm", "hybrid"):
        return HY.Hybrid
    if cfg.family == "encdec":
        return ED.EncDec
    if cfg.family == "vlm":
        return VI.VLM
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def build(cfg: ModelConfig, device=None, remat: str = "block"
          ) -> ModelBundle:
    """The bundle of ``cfg`` on ``device`` (default ``"cuda"``; asking for
    the card where there is none raises). Every family serves
    (``prefill``, ``decode_step``, ``cache_init``) and trains (``loss``),
    with ``remat`` "block" or "full" (each block recomputed in the
    backward, the reference's ``nothing_saveable``) or "dots" (the
    products with no batch dims kept, the rest recomputed;
    `transformer.remat_call`)."""
    TF.check_remat(remat)
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    init, prefill, decode, cache_init = _family(cfg, dev)

    def abstract():
        model = _module(cfg)(cfg, META)
        return model, {n: param_spec(n, p.dim())
                       for n, p in model.named_parameters()}

    def loss(params, batch):
        b = _batch(batch, params, cfg)
        return TF.lm_loss(params, b, cfg, apply_fn=_apply_fn(cfg, b),
                          remat=remat)

    def decode_step(params, token, cache, pos):
        return decode(params, _tokens(token, params), cache, int(pos), cfg)

    return ModelBundle(cfg=cfg, init=init, abstract=abstract, loss=loss,
                       prefill=prefill, decode_step=decode_step,
                       cache_init=cache_init, device=dev)


# --------------------------------------------------------------------------
# input specs (meta tensors; nothing allocates)
# --------------------------------------------------------------------------

def _frontend_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return torch.empty((batch, cfg.n_frontend_tokens, ED._frontend_dim(cfg)),
                       dtype=L.torch_dtype(cfg), device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for the model inputs of one cell, in the
    reference's shapes and dtypes:

    train  -> {tokens, labels (int32), mask (float32)(, frames|patches)}
    prefill-> {tokens(, frames|patches)}
    decode -> {token, cache, pos}  (one new token, cache of length seq_len)

    The frontend's stub embeddings are in ``cfg.dtype``; the decode cache
    is the family's ``cache_init`` on ``meta``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    front = frontend_name(cfg)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": torch.empty((B, S), dtype=i32, device=META)}
        if shape.kind == "train":
            out["labels"] = torch.empty((B, S), dtype=i32, device=META)
            out["mask"] = torch.empty((B, S), dtype=torch.float32,
                                      device=META)
        if front:
            out[front] = _frontend_spec(cfg, B)
        return out
    cache_init = _family(cfg, META)[3]
    return {"token": torch.empty((B,), dtype=i32, device=META),
            "cache": cache_init(B, S),
            "pos": torch.empty((), dtype=i32, device=META)}


def _cache_specs(cache: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _cache_specs(v) if isinstance(v, dict) else _CACHE_SPECS[k]
            for k, v in cache.items()}


def batch_logical_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    """Logical sharding names for each input in `input_specs`."""
    front = frontend_name(cfg)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            out.update(labels=("batch", "seq"), mask=("batch", "seq"))
        if front:
            out[front] = ("batch", None, None)
        return out
    cache = input_specs(cfg, shape)["cache"]
    return {"token": ("batch",), "cache": _cache_specs(cache), "pos": None}
