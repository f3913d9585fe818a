"""Bitmap-index analytics (paper §8.1): the service's query template.

Only the weekly-activity template is ported so far; the direct-ops
client of the reference (`repro.apps.bitmap_index`) waits for the
bitwise kernels.
"""
from __future__ import annotations


def week_or(w: int, prefix: str = "") -> str:
    """The 7-day OR-tree query template for week `w`.

    One definition shared with the synthetic stream
    (`repro_torch.service.workload`): plan-cache sharing between clients
    depends on the template staying structurally identical.
    """
    return "(" + " | ".join(f"{prefix}w{w}d{d}" for d in range(7)) + ")"
