"""Elastic rescale planning: preserve the global batch when the number of
data-parallel shards changes (node loss / capacity growth).

Keep the per-shard microbatch fixed and absorb the shard-count change into
gradient accumulation. The chip cluster reads it as: the slot grid is the
global batch, each chip drives ``n_banks`` slots a sweep, and the sweeps a
chip runs are the accumulation steps (`service.QueryService.rescale`).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    """New-layout execution plan with the same global batch."""

    global_batch: int
    per_shard_batch: int   # per-shard microbatch (unchanged across rescale)
    grad_accum: int        # accumulation steps on the NEW layout
    new_mesh_shards: int

    @property
    def effective_batch(self) -> int:
        return self.per_shard_batch * self.new_mesh_shards * self.grad_accum


def plan_rescale(global_batch: int, old_mesh_shards: int,
                 new_mesh_shards: int, old_accum: int = 1) -> RescalePlan:
    """Plan for moving `global_batch` from old to new shard count.

    per_shard = global / (old_shards * old_accum) is held fixed;
    grad_accum on the new layout becomes global / (new_shards * per_shard).
    Raises if the global batch cannot be preserved exactly.
    """
    if global_batch % (old_mesh_shards * old_accum):
        raise ValueError(
            f"global_batch {global_batch} not divisible by old layout "
            f"{old_mesh_shards}x{old_accum}")
    per_shard = global_batch // (old_mesh_shards * old_accum)
    if global_batch % (new_mesh_shards * per_shard):
        raise ValueError(
            f"global_batch {global_batch} not preservable on "
            f"{new_mesh_shards} shards with per-shard batch {per_shard}")
    accum = global_batch // (new_mesh_shards * per_shard)
    return RescalePlan(global_batch=global_batch, per_shard_batch=per_shard,
                       grad_accum=accum, new_mesh_shards=new_mesh_shards)
