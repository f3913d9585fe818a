"""Model registry: the reference's `ModelBundle` API over every family.

    bundle = build(cfg)                     # device="cuda" unless asked
    params = bundle.init(torch.Generator("cuda").manual_seed(0))
    loss, metrics = bundle.loss(params, batch)
    logits, cache = bundle.prefill(params, {"tokens": tokens})
    logits, cache = bundle.decode_step(params, token, cache, pos)

The counterpart of `repro.models.registry`, with the same field names.
``params`` is the family's `nn.Module` on the bundle's device: a
`transformer.Transformer` (dense, MoE), `hybrid.Hybrid` (SSM, hybrid),
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
the reference's ``build`` does. ``abstract`` (shapes without allocating, for the dry run and the sharded
cells) waits for §A8.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, operand_device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import frontend_name
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models import vision as VI

Params = Dict[str, Any]

@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable            # generator -> params
    abstract: Callable        # raises: ROADMAP §A8
    loss: Callable            # (params, batch) -> (loss, metrics)
    prefill: Callable         # (params, batch) -> (logits, cache)
    decode_step: Callable     # (params, token, cache, pos) -> (logits, cache)
    cache_init: Callable      # (batch, max_len) -> cache
    device: torch.device      # where init puts the weights


def _tokens(x, params) -> torch.Tensor:
    """Token ids as an int64 tensor on the model's device."""
    dev = operand_device([x], params.device)
    return torch.as_tensor(x, device=dev).long()


def _frontend(batch: Dict[str, Any], name: str, params) -> torch.Tensor:
    """The batch's frontend embeddings ``batch[name]`` as a tensor on the
    model's device (their dtype kept; the model casts them)."""
    if batch.get(name) is None:
        raise ValueError(f"this model reads batch[{name!r}], the "
                         "frontend's stub embeddings")
    x = batch[name]
    dev = operand_device([x], params.device)
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
        dev = operand_device([batch["mask"]], params.device)
        out["mask"] = torch.as_tensor(batch["mask"], device=dev).float()
    front = frontend_name(cfg)
    if front:
        out[front] = _frontend(batch, front, params)
    return out


def _apply_fn(cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """The family's training stack as `transformer.lm_loss`'s
    ``apply_fn``, bound to the batch's frontend embeddings."""
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


def build(cfg: ModelConfig, device=None, remat: str = "block"
          ) -> ModelBundle:
    """The bundle of ``cfg`` on ``device`` (default ``"cuda"``; asking for
    the card where there is none raises). Every family serves
    (``prefill``, ``decode_step``, ``cache_init``) and trains (``loss``),
    with ``remat`` "block" or "full" (each block recomputed in the
    backward, the reference's ``nothing_saveable``; "dots" waits for
    ROADMAP §A8)."""
    TF.check_remat(remat)
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    init, prefill, decode, cache_init = _family(cfg, dev)

    def abstract():
        raise NotImplementedError(
            "bundle.abstract (parameter shapes without allocating) serves "
            "the dry run and the sharded cells, which wait for ROADMAP §A8")

    def loss(params, batch):
        b = _batch(batch, params, cfg)
        return TF.lm_loss(params, b, cfg, apply_fn=_apply_fn(cfg, b),
                          remat=remat)

    def decode_step(params, token, cache, pos):
        return decode(params, _tokens(token, params), cache, int(pos), cfg)

    return ModelBundle(cfg=cfg, init=init, abstract=abstract, loss=loss,
                       prefill=prefill, decode_step=decode_step,
                       cache_init=cache_init, device=dev)
