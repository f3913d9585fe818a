"""Metrics registry: counters, gauges, histograms + Prometheus text export.

One `MetricsRegistry` replaces the three ad-hoc stat surfaces the serving
stack grew (`PlanCache` hit/miss integers, `Scheduler` running totals,
`FaultTolerance` event counters): every layer increments named instruments
in the registry the `QueryService` owns, and `QueryService.stats()` is a
read-through view of it (old keys kept as aliases).

Instruments are memoized by ``(name, labels)`` so call sites can hold a
reference once and pay a bare attribute add per event:

    m = registry.counter("queries_total", tenant="t0")
    m.inc()

`NULL_METRICS` is the no-op twin: every instrument method does nothing, so
un-telemetered components (a bare `Scheduler`, the default `QueryService`
path when metrics are off) keep their hot loops allocation-free. Callers
that would *build* label kwargs should still guard on
`Telemetry.metering` — constructing the kwargs dict is the allocation.

Histograms retain raw samples (bounded) so percentiles use the *same*
nearest-rank formula as `service.scheduler.BatchReport.latency_percentile_ns`
— the registry's p50/p99 and the batch report's agree exactly
(tests/test_obs.py asserts it).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple, Union

#: histogram sample-retention cap; counts/sums stay exact beyond it
HISTOGRAM_CAP = 65536

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


class Counter:
    """Monotonically increasing total."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """A value that goes up and down (last write wins)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Sample accumulator with exact count/sum and bounded raw retention.

    `percentile(pct)` uses the nearest-rank rule of
    `BatchReport.latency_percentile_ns` so the registry's latency
    percentiles and the batch report's match bit-for-bit while every
    sample is retained (the first `HISTOGRAM_CAP` observations; count and
    sum stay exact forever).
    """

    __slots__ = ("count", "total", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if len(self.samples) < HISTOGRAM_CAP:
            self.samples.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, pct: float) -> float:
        lats = sorted(self.samples)
        if not lats:
            return 0.0
        i = min(len(lats) - 1, int(math.ceil(pct / 100.0 * len(lats))) - 1)
        return lats[max(i, 0)]


class _NullInstrument:
    """No-op counter/gauge/histogram standing in for all three."""

    __slots__ = ()
    value = 0.0
    count = 0
    total = 0.0
    mean = 0.0
    samples: List[float] = []

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, pct: float) -> float:
        return 0.0


_NULL_INSTRUMENT = _NullInstrument()


def _key(name: str, labels: Dict[str, str]) -> LabelKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class MetricsRegistry:
    """Named, labeled instruments with a flat snapshot and text export."""

    def __init__(self):
        self._counters: Dict[LabelKey, Counter] = {}
        self._gauges: Dict[LabelKey, Gauge] = {}
        self._histograms: Dict[LabelKey, Histogram] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        key = _key(name, labels)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = _key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, **labels: str) -> Histogram:
        key = _key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram()
        return h

    # -- export --------------------------------------------------------------

    def snapshot(self) -> Dict[str, Union[int, float]]:
        """Flat ``name{label="v"} -> value`` view (histograms expand to
        ``_count`` / ``_sum`` / ``_p50`` / ``_p99`` pseudo-series)."""
        out: Dict[str, Union[int, float]] = {}
        for (name, labels), c in sorted(self._counters.items()):
            out[f"{name}{_label_str(labels)}"] = c.value
        for (name, labels), g in sorted(self._gauges.items()):
            out[f"{name}{_label_str(labels)}"] = g.value
        for (name, labels), h in sorted(self._histograms.items()):
            ls = _label_str(labels)
            out[f"{name}_count{ls}"] = h.count
            out[f"{name}_sum{ls}"] = h.total
            out[f"{name}_p50{ls}"] = h.percentile(50)
            out[f"{name}_p99{ls}"] = h.percentile(99)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (type-annotated, one final
        newline; histograms export summary-style count/sum/quantiles)."""
        lines: List[str] = []
        seen_type: set = set()

        def typeline(name: str, kind: str) -> None:
            if name not in seen_type:
                seen_type.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for (name, labels), c in sorted(self._counters.items()):
            typeline(name, "counter")
            lines.append(f"{name}{_label_str(labels)} {c.value:g}")
        for (name, labels), g in sorted(self._gauges.items()):
            typeline(name, "gauge")
            lines.append(f"{name}{_label_str(labels)} {g.value:g}")
        for (name, labels), h in sorted(self._histograms.items()):
            typeline(name, "summary")
            for pct in (50, 99):
                q = dict(labels)
                q["quantile"] = f"0.{pct}"
                lines.append(f"{name}{_label_str(tuple(sorted(q.items())))} "
                             f"{h.percentile(pct):g}")
            lines.append(f"{name}_sum{_label_str(labels)} {h.total:g}")
            lines.append(f"{name}_count{_label_str(labels)} {h.count}")
        return "\n".join(lines) + "\n"


class NullMetrics(MetricsRegistry):
    """No-op registry: every instrument is the shared null singleton."""

    def __init__(self):  # deliberately no instrument dicts
        pass

    def counter(self, name: str, **labels: str):
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels: str):
        return _NULL_INSTRUMENT

    def histogram(self, name: str, **labels: str):
        return _NULL_INSTRUMENT

    def snapshot(self) -> Dict[str, Union[int, float]]:
        return {}

    def to_prometheus(self) -> str:
        return "\n"


NULL_METRICS = NullMetrics()
