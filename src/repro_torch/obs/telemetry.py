"""Telemetry facade: one object bundling a tracer and a metrics registry.

`Telemetry` is what flows through the serving stack — `QueryService`
accepts ``telemetry=`` and hands it to the planner, scheduler, cluster
wrappers and fault-tolerance machinery. Two cheap booleans gate every
instrumentation site:

  * ``tel.tracing`` — span/trace emission is on (a real `Tracer`);
  * ``tel.metering`` — counter/gauge/histogram updates go to a real
    `MetricsRegistry`.

Call sites must test the boolean *before* building kwargs or f-strings,
so the disabled path costs one attribute load + branch and allocates
nothing (the contract `benchmarks/obs_overhead.py` gates).

`NULL_TELEMETRY` is the fully-off singleton used by bare components
(e.g. a `Scheduler` constructed without a service). The default
`QueryService` telemetry is `Telemetry(trace=False)`: metrics on (they
back `stats()` and cost what the old ad-hoc counters cost), tracing off.

Core layers (`core.engine`, `core.bankgroup`, `core.cluster`, the VM's
`core.lowering.VmCall`, the train step) have no handle on the service
object, so they consult the module-global set by `set_telemetry` — the
scheduler installs its telemetry there for each batch when tracing or
metering; the default global is `NULL_TELEMETRY`.

Spans (`span`, `begin` / `end`) are recorded while ``tracing`` or while a
`torch.profiler` session runs, then also as profiler ranges
(`obs.trace.open_span`); with neither, `span` returns the shared no-op context
manager. Python's collector is charged to the published telemetry by one
process-wide `gc.callbacks` hook, installed when the first metering
`Telemetry` is built: ``gc_pause_seconds_total{generation}`` and
``gc_collections_total{generation}``, and a ``gc`` span.
"""
from __future__ import annotations

import gc
import time
from typing import Optional

from torch.autograd import profiler as _autograd_profiler

from repro_torch.obs import device as _device
from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from repro_torch.obs.trace import (
    _NULL_CM,
    NULL_TRACER,
    Span,
    Tracer,
    close_span,
    open_span,
    validate_chrome_trace,
    write_chrome_trace,
)


class Telemetry:
    """A tracer + metrics registry with fast on/off flags."""

    def __init__(self, trace: bool = True, metrics: bool = True):
        self.tracer = Tracer() if trace else NULL_TRACER
        self.metrics = MetricsRegistry() if metrics else NULL_METRICS
        self.tracing = bool(trace)
        self.metering = bool(metrics)
        if self.metering:
            _install_gc_hook()

    # -- spans ----------------------------------------------------------------

    def spans_on(self) -> bool:
        """Whether a span opened now is recorded: tracing, a profiler
        session running, or `obs.device` recording a window. Sites whose
        span takes arguments test it first."""
        return (self.tracing or _autograd_profiler._is_profiler_enabled
                or _device.RECORDER is not None)

    def span(self, name: str, **args):
        """The span site helper: a context manager recording ``name`` as a
        tracer span when tracing, as a profiler range while a profiler
        runs and as device edges while `obs.device` records; with none,
        the shared no-op context manager."""
        if not (self.tracing or _autograd_profiler._is_profiler_enabled
                or _device.RECORDER is not None):
            return _NULL_CM
        return Span(self.tracer if self.tracing else None, name, args)

    def begin(self, name: str, **args) -> None:
        """Open a span closed by `end` (sites call both only when
        `spans_on`)."""
        open_span(self.tracer if self.tracing else None, name, args)

    def end(self) -> None:
        close_span()

    def export_chrome_trace(self, path=None):
        """The Chrome trace payload; validated + written when `path` given."""
        payload = self.tracer.export()
        if path is not None:
            return write_chrome_trace(payload, path)
        validate_chrome_trace(payload)
        return payload

    def prometheus(self) -> str:
        return self.metrics.to_prometheus()


class _NullTelemetry(Telemetry):
    """Fully-disabled telemetry: shared null tracer + null metrics."""

    def __init__(self):
        self.tracer = NULL_TRACER
        self.metrics = NULL_METRICS
        self.tracing = False
        self.metering = False


NULL_TELEMETRY = _NullTelemetry()

#: process-wide telemetry consulted by core layers (engine/bankgroup/
#: cluster/VM) that have no service handle; NULL by default.
_GLOBAL: Telemetry = NULL_TELEMETRY

#: the collection under way: (telemetry charged, start, span depth or None)
_GC_RUNNING: Optional[tuple] = None


def _on_gc(phase: str, info: dict) -> None:
    """`gc.callbacks` hook: charge each collection to the telemetry
    published when it started (counters when metering; a ``gc`` span
    when tracing or profiling). With nothing published each phase
    returns after one check."""
    global _GC_RUNNING
    if phase == "start":
        tel = _GLOBAL
        if tel is NULL_TELEMETRY:
            return
        depth = None
        if tel.tracing or _autograd_profiler._is_profiler_enabled:
            depth = open_span(tel.tracer if tel.tracing else None, "gc",
                              {"generation": info["generation"]})
        _GC_RUNNING = (tel, time.perf_counter(), depth)
        return
    running = _GC_RUNNING
    if running is None:
        return
    _GC_RUNNING = None
    tel, t0, depth = running
    if depth is not None:
        close_span(depth)
    if tel.metering:
        gen = str(info["generation"])
        tel.metrics.counter("gc_pause_seconds_total", generation=gen).inc(
            time.perf_counter() - t0)
        tel.metrics.counter("gc_collections_total", generation=gen).inc()


def _install_gc_hook() -> None:
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def get_telemetry() -> Telemetry:
    return _GLOBAL


def set_telemetry(tel: Optional[Telemetry]) -> Telemetry:
    """Install `tel` as the process-wide telemetry; returns the previous
    one so callers can restore it (`None` resets to `NULL_TELEMETRY`)."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tel if tel is not None else NULL_TELEMETRY
    return prev


__all__ = [
    "Telemetry",
    "NULL_TELEMETRY",
    "get_telemetry",
    "set_telemetry",
]
