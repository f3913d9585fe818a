"""Unified observability layer: tracing, metrics, Chrome-trace export.

See `repro_torch.obs.telemetry` for the facade the serving stack threads
through (`QueryService(telemetry=...)`), `repro_torch.obs.trace` for the
span/timeline tracer and trace-event schema validator, and
`repro_torch.obs.metrics` for the counter/gauge/histogram registry backing
`QueryService.stats()` and the Prometheus snapshot.
"""
from repro_torch.obs.metrics import (
    HISTOGRAM_CAP,
    NULL_METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullMetrics,
)
from repro_torch.obs.telemetry import (
    NULL_TELEMETRY,
    Telemetry,
    get_telemetry,
    set_telemetry,
)
from repro_torch.obs.trace import (
    MODEL_PID,
    NULL_TRACER,
    WALL_PID,
    NullTracer,
    Tracer,
    validate_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "HISTOGRAM_CAP",
    "NULL_METRICS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullMetrics",
    "NULL_TELEMETRY",
    "Telemetry",
    "get_telemetry",
    "set_telemetry",
    "MODEL_PID",
    "NULL_TRACER",
    "WALL_PID",
    "NullTracer",
    "Tracer",
    "validate_chrome_trace",
    "write_chrome_trace",
]
