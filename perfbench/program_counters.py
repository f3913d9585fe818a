"""The query service's own counters, for the per-layer metrics that read
them: a snapshot of the `MetricsRegistry` of the port's metering
`Telemetry` that served the run's batches (the query driver builds one).

It is found among the process's objects and told apart by its
``queries_total``, which counts every query the run served: the
warm-up batches, the untraced part of the window and the profiled
stretch. A program without the counters a metric reads (the
``cse_pass_seconds_total`` of the scheduler's CSE pass marks them) gives
None, and so does a run whose service is not found.
"""
from __future__ import annotations

import gc
import sys
from typing import Dict, Optional

#: the counter whose presence marks a program that keeps the counters
MARK = "cse_pass_seconds_total"


def service_counters(ctx) -> Optional[Dict[str, float]]:
    """The registry snapshot of the service that served this run, or
    None."""
    mod = sys.modules.get("repro_torch.obs.telemetry")
    if mod is None or not ctx.stretch:
        return None
    t = ctx.traffic
    served = (t["warmup_batches"] + ctx.pre["units"]
              + ctx.stretch["units"]) * len(t["shapes"])
    for obj in gc.get_objects():
        if issubclass(type(obj), mod.Telemetry) and obj.metering:
            snap = obj.metrics.snapshot()
            if MARK in snap and snap.get("queries_total") == served:
                return snap
    return None


def per_query(ctx, name: str, scale: float = 1.0) -> Optional[float]:
    """Counter ``name`` (summed over its labels) per query served, times
    ``scale``; 0 where the program keeps the counters but ``name`` never
    moved."""
    snap = service_counters(ctx)
    if snap is None:
        return None
    total = sum(v for k, v in snap.items()
                if k == name or k.startswith(name + "{"))
    return total / snap["queries_total"] * scale
