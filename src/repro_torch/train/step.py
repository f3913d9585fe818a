"""Training step: loss + grad (+ microbatch accumulation) + clip +
optimizer update.

The counterpart of `repro.train.step`. Two variants:

* `make_train_step`: one worker. Gradients come from
  `torch.autograd.grad` of ``bundle.loss``; with ``grad_accum > 1`` the
  batch splits into equal microbatches along its leading axis, their
  gradients are summed into float32 zeros and divided by ``grad_accum``,
  as the reference's ``lax.scan`` does, so the activations are sized by
  the microbatch. With one microbatch the gradients keep the parameters'
  dtype. Either way one set of gradients is alive after the backward,
  and `optim.clip_by_global_norm` scales it in place.
* `make_train_step_compressed`: data parallel over a `torch.distributed`
  process group (in place of the reference's mesh and ``shard_map``).
  Every worker holds the whole parameters and the global batch, and
  takes its 1 / D of the batch (`data.host_shard`); the only gradient
  exchange is the 1-bit majority vote inside the signum optimizer, which
  must be ``signum(..., group=group)``. The loss is averaged over the
  group.

Both return ``train_step(params, opt_state, step, batch) -> (params,
opt_state, metrics)``; the update writes the parameters in place. A step
opens the spans ``step.grads``, ``step.clip`` and ``step.update``
(`obs.Telemetry.span` on the published telemetry): profiler ranges while a
`torch.profiler` session runs, tracer spans when a tracing telemetry is
published, and otherwise one flag test each.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import host_shard
from repro_torch.dist.sharding import whole
from repro_torch.obs.telemetry import get_telemetry
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm


def trainable(params) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by name, with gradients turned on (the
    model is built for serving, without them)."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    return named


def _split(batch: Dict[str, torch.Tensor], accum: int):
    """``accum`` equal microbatches along the leading axis."""
    out = [{} for _ in range(accum)]
    for k, x in batch.items():
        n = x.shape[0]
        if n % accum:
            raise ValueError(f"batch {k!r} of {n} rows does not split into "
                             f"{accum} microbatches")
        for i, part in enumerate(torch.as_tensor(x).chunk(accum)):
            out[i][k] = part
    return out


def loss_and_grads(bundle, params, batch, grad_accum: int = 1
                   ) -> Tuple[torch.Tensor, Dict, Dict[str, torch.Tensor]]:
    """(loss, metrics, grads by parameter name) of ``bundle.loss`` on one
    batch: with ``grad_accum`` microbatches, summed in float32 and
    averaged (and no metrics, as the reference's)."""
    named = trainable(params)
    names, tensors = list(named), list(named.values())

    def one(mb):
        loss, metrics = bundle.loss(params, mb)
        grads = torch.autograd.grad(loss, tensors)
        return loss.detach(), metrics, grads

    if grad_accum == 1:
        loss, metrics, grads = one(batch)
        return loss, {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, grads))
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in tensors]
    lsum = 0.0
    for mb in _split(batch, grad_accum):
        loss, _, grads = one(mb)
        for a, g in zip(acc, grads):
            a += g.float()
        lsum = lsum + loss
        del grads
    for a in acc:
        a /= grad_accum
    return lsum / grad_accum, {}, dict(zip(names, acc))


def _replicated_like(params, batch: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``batch`` as DTensors replicated over the mesh of DTensor
    ``params`` (a model sharded over the model axis); as it is for plain
    parameters."""
    from torch.distributed.tensor import DTensor, Replicate
    p = next(iter(dict(params.named_parameters()).values()))
    if not isinstance(p, DTensor):
        return batch
    mesh = p.device_mesh
    return {k: DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
            if isinstance(x, torch.Tensor) else x for k, x in batch.items()}


def make_train_step(bundle, optimizer: Optimizer, grad_accum: int = 1,
                    clip: float = 1.0) -> Callable:
    """Returns train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics {"loss", "grad_norm", and with one microbatch the
    loss's "xent" / "aux"})."""

    def train_step(params, opt_state, step, batch):
        tel = get_telemetry()
        with tel.span("step.grads"):
            loss, metrics, grads = loss_and_grads(bundle, params, batch,
                                                  grad_accum)
        with tel.span("step.clip"):
            grads, gnorm = clip_by_global_norm(grads, clip)
        with tel.span("step.update"):
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 step)
        return params, opt_state, {k: whole(v) for k, v in dict(
            loss=loss, grad_norm=gnorm, **metrics).items()}

    return train_step


def make_train_step_compressed(bundle, optimizer: Optimizer,
                               group: dist.ProcessGroup, grad_accum: int = 1,
                               clip: float = 1.0) -> Callable:
    """The signum / majority-vote step over ``group``; ``optimizer``
    should be ``signum(..., group=group)``. Returns train_step(params,
    opt_state, step, batch) -> (params, opt_state, {"loss", "grad_norm"}),
    ``batch`` being the global batch (each worker takes its shard)."""
    D = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def train_step(params, opt_state, step, batch):
        tel = get_telemetry()
        local = _replicated_like(params, host_shard(batch, rank, D))
        with tel.span("step.grads"):
            loss, _, grads = loss_and_grads(bundle, params, local,
                                            grad_accum)
        # no all-reduce of the gradients: the 1-bit majority exchange
        # inside optimizer.update is the only one
        with tel.span("step.clip"):
            grads, gnorm = clip_by_global_norm(grads, clip)
        with tel.span("step.update"):
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 step)
        loss = whole(loss).float().clone()
        gnorm = whole(gnorm)
        dist.all_reduce(loss, group=group)
        return params, opt_state, {"loss": loss / D, "grad_norm": gnorm}

    return train_step
