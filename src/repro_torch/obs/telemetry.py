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

Core layers (`core.engine`, `core.bankgroup`, `core.cluster`) have no
handle on the service object, so they consult the module-global set by
`set_telemetry` — `QueryService` installs its telemetry there for the
duration of a dispatch; the default global is `NULL_TELEMETRY`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from repro_torch.obs.trace import (
    NULL_TRACER,
    Tracer,
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

    def reset_trace(self) -> None:
        self.tracer.reset()

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
#: cluster) that have no service handle; NULL by default.
_GLOBAL: Telemetry = NULL_TELEMETRY


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
