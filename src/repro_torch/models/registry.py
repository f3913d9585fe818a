"""Model registry: the reference's `ModelBundle` API, dense and MoE
families.

    bundle = build(cfg)                     # device="cuda" unless asked
    params = bundle.init(torch.Generator("cuda").manual_seed(0))
    loss, metrics = bundle.loss(params, batch)
    logits, cache = bundle.prefill(params, {"tokens": tokens})
    logits, cache = bundle.decode_step(params, token, cache, pos)

The counterpart of `repro.models.registry`, with the same field names.
``params`` is a `models.transformer.Transformer` on the bundle's device.
Token tensors keep their device; host token arrays (numpy, lists) go to
the model's device; tokens on another device than the model raise.
``abstract`` (shapes without allocating, for the dry run and the sharded
cells) waits for ROADMAP §A8; the MoE family's ``loss`` waits for §A4b
(MoE training); the other families (SSM / hybrid, enc-dec, VLM) raise at
`build`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch._device import DEFAULT_DEVICE, operand_device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF

Params = Dict[str, Any]

#: the ROADMAP item (queue A) that ports each family the port lacks
_FAMILY_SLICE = {"ssm": "A5 (SSM / hybrid)", "hybrid": "A5 (SSM / hybrid)",
                 "encdec": "A6 (enc-dec)", "vlm": "A7 (VLM)"}


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


def _tokens(x, params: TF.Transformer) -> torch.Tensor:
    """Token ids as an int64 tensor on the model's device."""
    dev = operand_device([x], params.device)
    return torch.as_tensor(x, device=dev).long()


def _batch(batch: Dict[str, Any], params: TF.Transformer
           ) -> Dict[str, torch.Tensor]:
    """A training batch's tokens and labels as int64 and its mask as
    float32, on the model's device."""
    out = {k: _tokens(batch[k], params) for k in ("tokens", "labels")}
    if batch.get("mask") is not None:
        dev = operand_device([batch["mask"]], params.device)
        out["mask"] = torch.as_tensor(batch["mask"], device=dev).float()
    return out


def build(cfg: ModelConfig, device=None, remat: str = "block"
          ) -> ModelBundle:
    """The bundle of ``cfg`` (dense or MoE family) on ``device`` (default
    ``"cuda"``; asking for the card where there is none raises). ``remat``
    is the loss's rematerialisation policy: "block" or "full" (each block
    recomputed in the backward, the reference's ``nothing_saveable``);
    "dots" waits for ROADMAP §A8. The MoE family serves (``prefill``,
    ``decode_step``, ``cache_init``); its ``loss`` raises until ROADMAP
    §A4b ports MoE training."""
    if cfg.family not in ("dense", "moe"):
        where = _FAMILY_SLICE.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP queue {where}); the port builds the dense and MoE "
            "families")
    TF.check_remat(remat)
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)

    def init(generator: torch.Generator) -> TF.Transformer:
        return TF.transformer_init(generator, cfg, dev)

    def abstract():
        raise NotImplementedError(
            "bundle.abstract (parameter shapes without allocating) serves "
            "the dry run and the sharded cells, which wait for ROADMAP §A8")

    def loss(params, batch):
        return TF.lm_loss(params, _batch(batch, params), cfg, remat=remat)

    def prefill(params, batch):
        return TF.transformer_prefill(params, _tokens(batch["tokens"], params),
                                      cfg)

    def decode_step(params, token, cache, pos):
        return TF.transformer_decode_step(params, _tokens(token, params),
                                          cache, int(pos), cfg)

    def cache_init(batch, max_len):
        return L.kv_cache_init(cfg, len(TF.layer_kinds(cfg)), batch, max_len,
                               dev)

    return ModelBundle(cfg=cfg, init=init, abstract=abstract, loss=loss,
                       prefill=prefill, decode_step=decode_step,
                       cache_init=cache_init, device=dev)
