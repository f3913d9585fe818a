"""Synthetic multi-tenant query workload for the bulk-bitwise service.

Models the paper's §8 killer applications as an interactive query stream:

  * bitmap-index analytics (§8.1) — per-tenant daily activity bitmaps plus
    a gender attribute; query templates are the weekly-activity OR-trees,
    the "active every week" AND-of-weeks, and the male-per-week filters.
  * BitWeaving column scans (§8.2) — a per-tenant integer column in
    vertical layout, queried with repeated range predicates.
  * bitvector set operations (§8.3) — per-tenant element sets, queried
    with k-ary intersections and unions.
  * bit-serial arithmetic (SIMDRAM-style, beyond the paper) — per-tenant
    value columns queried with `sum(col)` aggregations, `col < K`
    comparison predicates, and `sum(colA + colB)` ripple-adder sums.

The stream is deliberately repetitive in *shape* (each tenant re-asks the
same templates, and all tenants share template structure), which is exactly
the pattern the planner's canonical plan cache and the scheduler's
plan-grouped batching exploit.

Two consumers share the template bank:

  * `query_stream` — a closed-loop batch of `n_queries` (the serve_qps
    benchmark shape: submit everything at once, measure the batch);
  * `poisson_arrivals` — an open-loop arrival trace for the continuous
    serving runtime (`service.server.ServingLoop.run_trace`): seeded
    per-tenant Poisson processes with skewed rates and a heavy-tailed
    query-size mix, so benchmarks and chaos tests replay the exact same
    offered load.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.apps.bitmap_index import week_or
from repro_torch.service.scheduler import AGGREGATE, POPCOUNT, Query
from repro_torch.service.server import Arrival
from repro_torch.service.service import QueryService


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Knobs of the synthetic stream (defaults sized for CI)."""

    n_tenants: int = 4
    n_weeks: int = 3
    domain_bits: int = 1 << 12      # users / column length / set domain
    col_bits: int = 8               # integer column width for range scans
    n_sets: int = 6                 # element sets per tenant
    n_queries: int = 96
    seed: int = 0
    p_active: float = 0.35


def _week_or(tenant: str, week: int) -> str:
    # shared template: keeps this stream plan-cache-compatible with the
    # apps.bitmap_index service-client path
    return week_or(week, prefix=f"{tenant}/")


def build_service(spec: WorkloadSpec, n_banks: int = 8,
                  telemetry=None, **kwargs) -> QueryService:
    """Populate a service catalog with every tenant's vectors.

    `telemetry` passes through to `QueryService` (a `repro_torch.obs.Telemetry`
    or `NULL_TELEMETRY`; None keeps the service default of metrics-on /
    tracing-off), as do any extra keyword arguments — `device="cpu"`
    serves from the host instead of the card, `optimize=False` builds the
    unoptimized baseline side. The draws are the JAX package's, so one
    seed gives both packages the same catalog.
    """
    rng = np.random.default_rng(spec.seed)
    svc = QueryService(n_banks=n_banks, telemetry=telemetry, **kwargs)
    m = spec.domain_bits
    for t in range(spec.n_tenants):
        tenant = f"t{t}"
        for w in range(spec.n_weeks):
            for d in range(7):
                bits = rng.random(m) < spec.p_active
                svc.register_bits(f"{tenant}/w{w}d{d}", bits, group=tenant)
        svc.register_bits(f"{tenant}/male", rng.random(m) < 0.5, group=tenant)
        for s in range(spec.n_sets):
            svc.register_bits(f"{tenant}/s{s}", rng.random(m) < 0.4,
                              group=tenant)
        svc.register_column(f"{tenant}/col",
                            rng.integers(0, 1 << spec.col_bits, m,
                                         dtype=np.uint32),
                            spec.col_bits, group=tenant)
        svc.register_column(f"{tenant}/col2",
                            rng.integers(0, 1 << spec.col_bits, m,
                                         dtype=np.uint32),
                            spec.col_bits, group=tenant)
    return svc


def _make_templates(spec: WorkloadSpec, svc: QueryService, rng):
    """The shared per-tenant query template bank.

    Consumes the first six integer draws of `rng` for the fixed range-scan
    bounds (so the closed-loop stream stays seed-stable), then returns the
    template closures keyed by name. Every template takes a tenant id and
    its own random draws from the same `rng`.
    """
    # a few fixed range predicates per tenant so scans repeat
    bounds: List[Tuple[int, int]] = []
    for _ in range(3):
        lo = int(rng.integers(0, (1 << spec.col_bits) - 1))
        hi = int(rng.integers(lo, 1 << spec.col_bits))
        bounds.append((lo, hi))

    def weekly(t: str, w: int) -> Query:
        return Query(_week_or(t, w), POPCOUNT, tenant=t)

    def every_week(t: str) -> Query:
        text = " & ".join(_week_or(t, w) for w in range(spec.n_weeks))
        return Query(text, POPCOUNT, tenant=t)

    def male_week(t: str, w: int) -> Query:
        return Query(f"{_week_or(t, w)} & {t}/male", POPCOUNT, tenant=t)

    def range_scan(t: str, which: int) -> Query:
        lo, hi = bounds[which]
        return Query(svc.range_scan_query(f"{t}/col", lo, hi),
                     POPCOUNT, tenant=t)

    def intersect(t: str, k: int) -> Query:
        text = " & ".join(f"{t}/s{s}" for s in range(k))
        return Query(text, POPCOUNT, tenant=t)

    def union_diff(t: str) -> Query:
        return Query(f"({t}/s0 | {t}/s1 | {t}/s2) & ~{t}/s3",
                     POPCOUNT, tenant=t)

    def sum_col(t: str) -> Query:
        return Query(f"sum({t}/col)", AGGREGATE, tenant=t)

    def lt_filter(t: str, which: int) -> Query:
        lo, _ = bounds[which]
        k = max(1, lo)  # grammar rejects constant predicates (k == 0)
        return Query(f"{t}/col < {k} & {t}/male", POPCOUNT, tenant=t)

    def sum_add(t: str) -> Query:
        return Query(f"sum({t}/col + {t}/col2)", AGGREGATE, tenant=t)

    def draw(t: str) -> Query:
        kind = int(rng.integers(9))
        if kind == 0:
            return weekly(t, int(rng.integers(spec.n_weeks)))
        elif kind == 1:
            return every_week(t)
        elif kind == 2:
            return male_week(t, int(rng.integers(spec.n_weeks)))
        elif kind == 3:
            return range_scan(t, int(rng.integers(len(bounds))))
        elif kind == 4:
            return intersect(t, int(rng.integers(2, spec.n_sets)))
        elif kind == 5:
            return union_diff(t)
        elif kind == 6:
            return sum_col(t)
        elif kind == 7:
            return lt_filter(t, int(rng.integers(len(bounds))))
        return sum_add(t)

    def draw_light(t: str) -> Query:
        kind = int(rng.integers(4))
        if kind == 0:
            return weekly(t, int(rng.integers(spec.n_weeks)))
        elif kind == 1:
            return male_week(t, int(rng.integers(spec.n_weeks)))
        elif kind == 2:
            return union_diff(t)
        return intersect(t, 2)

    def draw_heavy(t: str) -> Query:
        kind = int(rng.integers(4))
        if kind == 0:
            return every_week(t)
        elif kind == 1:
            return sum_col(t)
        elif kind == 2:
            return sum_add(t)
        return range_scan(t, int(rng.integers(len(bounds))))

    return {"draw": draw, "light": draw_light, "heavy": draw_heavy}


def query_stream(spec: WorkloadSpec, svc: QueryService) -> List[Query]:
    """A mixed, repetitive multi-tenant stream of `n_queries` queries."""
    rng = np.random.default_rng(spec.seed + 1)
    templates = _make_templates(spec, svc, rng)
    queries: List[Query] = []
    while len(queries) < spec.n_queries:
        t = f"t{int(rng.integers(spec.n_tenants))}"
        queries.append(templates["draw"](t))
    return queries


def poisson_arrivals(spec: WorkloadSpec, svc: QueryService, *,
                     rate_qps: float, n_arrivals: int = 64,
                     seed: Optional[int] = None,
                     tenant_weights: Optional[Sequence[float]] = None,
                     heavy_frac: float = 0.2,
                     priorities: Optional[Dict[str, int]] = None,
                     ) -> List[Arrival]:
    """Seeded open-loop arrival trace for the continuous serving runtime.

    Each tenant is an independent Poisson process: the aggregate offered
    rate `rate_qps` (queries per modeled second) splits across tenants by
    `tenant_weights` (default: a 2:1 geometric skew, so tenant 0 is the
    hog and the tail tenants trickle — the shape DRR fairness and
    per-tenant SLO shedding are tested against), `n_arrivals` splits by a
    multinomial draw on the same weights, and inter-arrival gaps are
    exponential. The query mix is heavy-tailed in *size*: probability
    `heavy_frac` draws a heavy template (multi-week AND trees, ripple-add
    SUMs, range scans — many-plane programs), the rest draw light
    single-plane-ish templates. `priorities` maps tenant id -> admission
    priority (higher sheds last); unlisted tenants get 0.

    Deterministic for a given (spec.seed, seed, rate, n): benchmarks and
    chaos tests replay byte-identical offered load.
    """
    rng = np.random.default_rng(spec.seed + 2 if seed is None else seed)
    templates = _make_templates(spec, svc, rng)
    if tenant_weights is None:
        tenant_weights = [2.0 ** -i for i in range(spec.n_tenants)]
    w = np.asarray(tenant_weights, float)
    if len(w) != spec.n_tenants or np.any(w < 0) or w.sum() <= 0:
        raise ValueError(f"bad tenant_weights {tenant_weights!r}")
    w = w / w.sum()
    counts = rng.multinomial(n_arrivals, w)
    priorities = priorities or {}
    arrivals: List[Arrival] = []
    for i, n_t in enumerate(counts):
        if n_t == 0:
            continue
        tenant = f"t{i}"
        rate_per_ns = rate_qps * w[i] / 1e9
        times = np.cumsum(rng.exponential(1.0 / rate_per_ns, size=int(n_t)))
        for t_ns in times:
            heavy = rng.random() < heavy_frac
            q = templates["heavy" if heavy else "light"](tenant)
            arrivals.append(Arrival(t_ns=float(t_ns), query=q,
                                    priority=priorities.get(tenant, 0)))
    arrivals.sort(key=lambda a: a.t_ns)
    return arrivals
