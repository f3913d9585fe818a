"""`QueryService` — the user-facing facade of the bulk-bitwise query engine.

Wires catalog -> planner/plan-cache -> batching scheduler into one object:

    svc = QueryService(ServiceConfig(n_banks=8))        # on the CUDA card
    svc.register_bits("mon", monday_bits, group="tenant0")
    svc.register_bits("tue", tuesday_bits, group="tenant0")
    n = svc.query("mon & tue").value          # popcount aggregate
    svc.materialize("both", "mon & tue")      # derived vector, re-queryable

The catalog's words and every plane live on ``config.device`` ("cuda" by
default; constructing the service on a machine without a card raises, and
``ServiceConfig(device="cpu")`` serves from the host).

The serving surface is the async handle model:

    h = svc.submit("mon & tue", tenant="t0")  # -> QueryHandle
    h.done(); h.result().scalar

`query()`, `query_batch()` and `range_scan()` are thin synchronous
wrappers over `submit()` — a batch defers its handles and `flush()`
serves them as one scheduler dispatch. Without an attached serving loop
`submit()` executes eagerly (a batch of one); with a running
`ServingLoop` (`svc.serve_loop().start()`) it enqueues into the
continuous-serving runtime (`service.server`).

Columns (BitWeaving-V layout) ride the same machinery: `register_column`
transposes the values into vertical bit planes (the bit-transpose kernel
on the card) and places each plane as a catalog vector, and `range_scan`
lowers `lo <= v <= hi` to the fusable predicate DAG of `ops.predicate`.
Registered columns also unlock the bit-serial arithmetic grammar:

    svc.register_column("age", ages, 7)
    svc.query("age < 30 & male")            # comparison predicate
    svc.query("sum(age)").value             # SUM aggregation
    svc.materialize_column("total", "spend + refund")   # derived column

TRA reliability is a deployment mode: with
``ServiceConfig(reliability=ReliabilityConfig(mode="vote" | "ecc", ...))``
every plan group runs as seeded fault-injected replicas whose outputs are
voted (`core.errors`, `service.scheduler`), and ``"ecc"`` checks the
catalog's parity planes before each batch.

The distributed deployment: ``ServiceConfig(n_chips=C, max_chips=M)``
serves from a `core.cluster.ChipCluster` of C chips on ``config.device``
(C distinct cards on ``"cuda"``, ``["cpu"] * C`` on the CPU), every
catalog vector word-sharded over ``M * n_banks`` slots; `rescale(C')`
re-places the catalog on C' chips. ``fault_tolerance=`` (a
`dist.fault_tolerance.FaultTolerance`) replays failed plan groups, with
a chip failure first shrinking the cluster, and `serve_stream` serves a
stream of batches with checkpointed recovery (`checkpoint.Checkpointer`).
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.errors import ReliabilityConfig
from repro_torch.core.bitplane import as_words
from repro_torch.core.compiler import Expr
from repro_torch.ops.predicate import VerticalColumn, range_scan_expr
from repro_torch.service.catalog import Catalog, CatalogEntry
from repro_torch.service.config import (CONFIG_FIELDS, DEPRECATED_KWARGS,
                                        ServiceConfig)
from repro_torch.service.optimizer import (CostParams, ExplainReport,
                                           QueryOptimizer)
from repro_torch.service.planner import PlanCache, Planner
from repro_torch.service.scheduler import (MATERIALIZE, POPCOUNT, BatchReport,
                                           Query, QueryResult, Scheduler)
from repro_torch.service.server import QueryHandle, ServingLoop


class QueryService:
    """Catalog + planner + scheduler behind one serving interface.

    Construct with a `ServiceConfig` or its fields as keywords; keywords
    override config fields (``reliability``, ``fault_tolerance`` and
    ``n_chips`` as keywords warn with a `DeprecationWarning`, as the
    reference's do). ``n_chips=None`` (default) is the single-process
    deployment: one device, ``config.device``, bank-axis batching only.
    ``n_chips=C`` is the distributed deployment: a
    `core.cluster.ChipCluster` of C chips, catalog vectors word-sharded
    across chips (placement recorded per vector, affinity groups
    chip-local), every plan-group dispatched as one VM launch per chip,
    popcounts tree-psum'd. `rescale(C')` re-plans the layout through
    `dist.elastic.plan_rescale` and re-places the catalog without losing
    a single registered vector.
    """

    def __init__(self, config: Optional[ServiceConfig] = None, **kwargs):
        if config is None:
            config = ServiceConfig()
        if kwargs:
            unknown = sorted(set(kwargs) - CONFIG_FIELDS)
            if unknown:
                raise TypeError(
                    f"QueryService: unknown keyword(s) {unknown}; valid "
                    f"fields: {sorted(CONFIG_FIELDS)}")
            deprecated = sorted(set(kwargs) & DEPRECATED_KWARGS)
            if deprecated:
                warnings.warn(
                    f"QueryService({', '.join(deprecated)}=...) keywords "
                    "are deprecated; pass "
                    f"ServiceConfig({', '.join(deprecated)}=...) instead",
                    DeprecationWarning, stacklevel=2)
            config = dataclasses.replace(config, **kwargs)
        if config.reliability is not None \
                and not isinstance(config.reliability, ReliabilityConfig):
            raise TypeError(
                "ServiceConfig.reliability takes a repro_torch.core.errors."
                f"ReliabilityConfig, got {type(config.reliability).__name__}")
        self.config = config
        self.device = resolve_device(config.device)
        self.n_banks = config.n_banks
        self.timing = config.timing
        self.n_chips = config.n_chips
        self.max_chips = config.max_chips
        self.reliability = config.reliability
        self.fault_tolerance = config.fault_tolerance
        self.telemetry = config.telemetry
        self.optimize = config.optimize
        self.plan_cache_capacity = config.plan_cache_capacity
        if self.telemetry is None:
            from repro_torch.obs.telemetry import Telemetry

            self.telemetry = Telemetry(trace=False)
        self.catalog = Catalog(device=self.device)
        optimizer = None
        if self.optimize:
            optimizer = QueryOptimizer(params=CostParams(
                timing=self.timing, n_banks=self.n_banks,
                n_chips=self.n_chips or 1, device=self.device.type))
        self.optimizer = optimizer
        self.planner = Planner(cache=PlanCache(
            timing=self.timing, optimizer=optimizer,
            capacity=self.plan_cache_capacity))
        self.cluster = None
        if self.n_chips is not None:
            self.cluster = self._create_cluster(self.n_chips, self.max_chips)
            self.max_chips = self.cluster.max_chips
            self.catalog.attach_cluster(self.cluster)
        if (self.fault_tolerance is not None
                and self.fault_tolerance.on_chip_failure is None):
            self.fault_tolerance.on_chip_failure = self._recover_chip_failure
        self.scheduler = Scheduler(catalog=self.catalog, planner=self.planner,
                                   n_banks=self.n_banks, timing=self.timing,
                                   cluster=self.cluster,
                                   reliability=self.reliability,
                                   fault_tolerance=self.fault_tolerance,
                                   telemetry=self.telemetry)
        self._columns: Dict[str, VerticalColumn] = {}
        #: serializes direct dispatch against a live serving loop
        self._dispatch_lock = threading.RLock()
        self._loop: Optional[ServingLoop] = None
        self._pending: List[tuple] = []     # deferred (Query, QueryHandle)

    # -- catalog management --------------------------------------------------

    def register(self, name: str, value, n_bits: Optional[int] = None,
                 group: Optional[str] = None) -> CatalogEntry:
        return self.catalog.register(name, value, n_bits, group)

    def register_bits(self, name: str, bits,
                      group: Optional[str] = None) -> CatalogEntry:
        return self.catalog.register_bits(name, bits, group)

    def register_column(self, name: str, values, n_bits: int,
                        group: Optional[str] = None) -> VerticalColumn:
        """Store an integer column: one catalog vector per vertical plane.

        Plane j of column `name` becomes catalog row `{name}.b{j}`; the
        column's logical length must equal the catalog bit domain so plane
        vectors and bitmap vectors are freely combinable in one query.
        Registration also records the column's width, which is what lets
        the planner expand `sum(name)` / `name + other` / `name < K`.
        """
        col = VerticalColumn.encode(as_words(values, self.device), n_bits)
        if self.catalog.n_bits is not None \
                and col.n_values != self.catalog.n_bits:
            raise ValueError(
                f"column {name!r}: {col.n_values} values != catalog domain "
                f"{self.catalog.n_bits}")
        self.catalog.register_column(name, col.planes, col.n_values, n_bits,
                                     group=group)
        self._columns[name] = col
        return col

    def materialize_column(self, name: str, query: Union[str, Expr],
                           group: Optional[str] = None) -> VerticalColumn:
        """Run an arithmetic query (`a + b`, `a - b`), register the result
        planes as a new column, re-queryable like any registered column."""
        r = self.query(query, mode=MATERIALIZE)
        planes = as_words(r.value, self.device)
        if planes.dim() != 2:
            raise ValueError(
                f"{query!r} did not produce a plane stack; "
                "materialize_column needs an arithmetic query")
        assert self.catalog.n_bits is not None
        col = VerticalColumn(planes, int(planes.shape[0]),
                             self.catalog.n_bits)
        self.catalog.register_column(name, planes, self.catalog.n_bits,
                                     col.n_bits, group=group)
        self._columns[name] = col
        return col

    # -- query interface (async handle model) --------------------------------

    def submit(self, query: Union[str, Expr, Query], *,
               mode: str = POPCOUNT, tenant: Optional[str] = None,
               priority: int = 0, deadline_ns: Optional[float] = None,
               defer: bool = False) -> QueryHandle:
        """Submit one query; returns a `QueryHandle`.

        Routing: with a running `ServingLoop` attached (`serve_loop()` +
        `start()`), the query enqueues into the continuous-serving
        runtime and the handle resolves when its tick completes (or
        raises `QueryShedError` if admission control dropped it). With
        ``defer=True`` the handle parks until the next `flush()` serves
        every deferred query as ONE scheduler batch (what
        `query_batch()` does). Otherwise the query executes eagerly as
        a batch of one and the handle returns already resolved.
        """
        q = query if isinstance(query, Query) else Query(query, mode, tenant)
        if self._loop is not None and self._loop.accepting and not defer:
            return self._loop.submit(q, priority=priority,
                                     deadline_ns=deadline_ns)
        handle = QueryHandle(q, priority=priority, deadline_ns=deadline_ns)
        if defer:
            self._pending.append((q, handle))
            return handle
        self._run_batch([(q, handle)])
        return handle

    def flush(self) -> BatchReport:
        """Serve every deferred `submit(..., defer=True)` as one batch."""
        pending, self._pending = self._pending, []
        return self._run_batch(pending)

    def _run_batch(self, pending: Sequence[tuple]) -> BatchReport:
        """Direct (loop-less) dispatch path; resolves the handles."""
        queries = [q for q, _ in pending]
        with self._dispatch_lock:
            try:
                report = self.scheduler.submit(queries)
            except BaseException as e:
                for _, handle in pending:
                    handle._fail(e)
                raise
        for (_, handle), result in zip(pending, report.results):
            handle._resolve(result)
        return report

    def query(self, query: Union[str, Expr], mode: str = POPCOUNT,
              tenant: Optional[str] = None) -> QueryResult:
        """Serve one query synchronously (`submit()` + `result()`)."""
        return self.submit(query, mode=mode, tenant=tenant).result()

    def query_batch(self, queries: Sequence[Query]) -> BatchReport:
        """Serve a batch of concurrent queries through the scheduler.

        A thin wrapper over the handle model: every query defers, one
        `flush()` serves them as a single plan-grouped dispatch.
        """
        for q in queries:
            self.submit(q, defer=True)
        return self.flush()

    # -- continuous serving --------------------------------------------------

    def serve_loop(self, **kwargs) -> ServingLoop:
        """Build (and attach) the continuous-serving runtime.

        Returns a `service.server.ServingLoop` bound to this service's
        scheduler; its SLO defaults to ``config.slo``. Use
        ``run_trace(arrivals)`` for deterministic open-loop replay or
        ``start()``/``submit()``/``stop()`` for live serving (while the
        loop accepts, `submit()` on this service routes into it).
        """
        loop = ServingLoop(self, **kwargs)
        self._loop = loop
        return loop

    def materialize(self, name: str, query: Union[str, Expr],
                    group: Optional[str] = None) -> CatalogEntry:
        """Run `query`, register its result vector under `name`."""
        r = self.query(query, mode=MATERIALIZE)
        return self.catalog.register(name, r.value, self.catalog.n_bits,
                                     group=group)

    # -- range scans ---------------------------------------------------------

    def range_scan_query(self, column: str, lo: int, hi: int) -> Expr:
        """The predicate lo <= column <= hi as a fusable Expr DAG."""
        col = self._columns[column]
        return range_scan_expr(col.n_bits, lo, hi,
                               plane_prefix=f"{column}.b")

    def range_scan(self, column: str, lo: int, hi: int,
                   mode: str = POPCOUNT,
                   tenant: Optional[str] = None) -> QueryResult:
        """Serve lo <= column <= hi through the general optimizer path:
        the predicate DAG goes through the same cost-driven pipeline as
        every other query."""
        return self.query(self.range_scan_query(column, lo, hi), mode, tenant)

    def explain(self, queries: Sequence[Union[Query, str]]) -> ExplainReport:
        """Plan a batch without executing it; report every decision.

        Returns the optimizer's `ExplainReport`: per-plan cost breakdown
        (AAPs vs the unoptimized pipeline, modeled latency/energy/
        transfers), the chosen backend per plan, the shared-subexpression
        planes the batch would compute once, and the modeled makespan.
        """
        return self.scheduler.explain(queries)

    # -- elastic deployment --------------------------------------------------

    def _create_cluster(self, n_chips: int, max_chips: Optional[int],
                        devices=None):
        """A cluster of `n_chips` on the service's device: distinct cards
        on "cuda", the host repeated on "cpu" (or the given ``devices``)."""
        from repro_torch.core.cluster import ChipCluster

        if devices is None and self.device.type == "cpu":
            devices = [self.device] * n_chips
        return ChipCluster.create(n_chips, n_banks=self.n_banks,
                                  max_chips=max_chips, devices=devices)

    def rescale(self, n_chips: int, devices=None):
        """Elastically change the chip count of a distributed deployment.

        The placement granularity (``max_chips * n_banks`` word-slots) is
        the preserved "global batch" of `dist.elastic.plan_rescale`: each
        chip always drives `n_banks` physical banks per sweep
        (``per_shard_batch``), and the slot grid is re-divided so the new
        chips cover it in ``plan.grad_accum`` sequential sweeps. Raises
        `ValueError` (from `plan_rescale`) when the layout cannot be
        preserved exactly — e.g. 3 chips over an 8-chip-granular
        placement. On success the catalog is re-placed onto the new
        chips: every registered vector keeps its bits (slot contents are
        invariant, only slot->chip assignment moves) and every derived
        column / affinity group survives. The new chips are on the
        service's device (distinct cards on "cuda"), or ``devices`` (e.g.
        ``["cuda:0"] * n_chips`` for several chips on one card). Returns
        the `RescalePlan`.
        """
        if self.cluster is None:
            raise ValueError(
                "rescale() needs a distributed service; construct with "
                "ServiceConfig(n_chips=...)")
        from repro_torch.dist.elastic import plan_rescale

        old = self.cluster
        plan = plan_rescale(global_batch=old.slots,
                            old_mesh_shards=old.n_chips,
                            new_mesh_shards=n_chips,
                            old_accum=old.sweeps)
        assert plan.per_shard_batch == self.n_banks
        self.cluster = self._create_cluster(n_chips, old.max_chips, devices)
        assert self.cluster.sweeps == plan.grad_accum
        self.n_chips = n_chips
        self.catalog.attach_cluster(self.cluster)
        self.scheduler.cluster = self.cluster
        return plan

    # -- fault tolerance -----------------------------------------------------

    def _recover_chip_failure(self, exc: BaseException) -> None:
        """Default `FaultTolerance.on_chip_failure` hook: rescale down.

        A `dist.fault_tolerance.ChipFailure` on a distributed deployment
        means one chip is gone; recovery elastically re-plans the
        placement onto the largest valid smaller chip count (the slot
        grid constrains which counts divide evenly — `rescale` raises
        `ValueError` for the rest) and re-places every catalog vector, so
        the replayed plan-group lands on the surviving chips with nothing
        lost. The survivors keep the devices of the first chips. Non-chip
        failures (a transient kernel fault) need no topology change; the
        scheduler's replay alone recovers them.
        """
        from repro_torch.dist.fault_tolerance import ChipFailure

        if not isinstance(exc, ChipFailure) or self.cluster is None:
            return
        old = self.cluster.n_chips
        for c in range(old - 1, 0, -1):
            try:
                self.rescale(c, devices=self.cluster.devices[:c])
            except ValueError:
                continue    # slot grid not divisible by c chips
            if self.fault_tolerance is not None:
                self.fault_tolerance.timeline.append(f"rescale@{old}->{c}")
            tel = self.telemetry
            if tel.metering:
                tel.metrics.counter("chip_rescales_total").inc()
            if tel.tracing:
                tel.tracer.instant("chip_rescale", old=old, new=c)
            return
        raise RuntimeError(
            f"chip failure on a {old}-chip cluster with no valid smaller "
            "layout") from exc

    def serve_stream(self, batches: Sequence[Sequence[Query]],
                     checkpoint_dir: str, ckpt_every: int = 2,
                     failure_injector=None, max_restores: int = 16):
        """Serve a stream of query batches with checkpointed recovery.

        Each batch is one step of a `dist.fault_tolerance.ResilientRunner`:
        scalar results land in a flat values array inside the runner state,
        which is checkpointed every ``ckpt_every`` batches
        (`checkpoint.Checkpointer`, atomic + async). A failure mid-stream
        replays from the last checkpoint; a *fresh* service pointed at the
        same directory resumes where the previous job stopped and skips
        the already-served prefix. Returns ``(values, RunReport)`` with
        ``values[i]`` the scalar of the i-th query in stream order.

        Scalar modes only — a materialized word vector has no slot in the
        fixed-structure checkpoint state.
        """
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.dist.fault_tolerance import ResilientRunner

        batches = [list(b) for b in batches]
        for b in batches:
            for q in b:
                if q.mode == MATERIALIZE:
                    raise ValueError(
                        "serve_stream checkpoints scalar results; "
                        "materialize queries don't fit the stream state")
        sizes = [len(b) for b in batches]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        n_total = int(offsets[-1])

        def step_fn(state, step, batch):
            report = self.query_batch(batch)
            # a restored state holds CPU tensors: re-host + re-cast
            # instead of mutating
            values = np.asarray(state["values"]).astype(np.int64).copy()
            lo = int(offsets[step])
            values[lo:lo + len(batch)] = [int(r.value)
                                          for r in report.results]
            return {"done": np.int64(step + 1), "values": values}, {}

        runner = ResilientRunner(
            step_fn, lambda step: batches[step],
            Checkpointer(checkpoint_dir), ckpt_every=ckpt_every,
            max_restores=max_restores, telemetry=self.telemetry)
        init = {"done": np.int64(0),
                "values": np.zeros(n_total, np.int64)}
        state, report = runner.run(init, len(batches),
                                   failure_injector=failure_injector)
        return np.asarray(state["values"]).astype(np.int64), report

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """One unified stat surface, backed by the metrics registry.

        With metering on (the default), the counter-backed keys read
        through `telemetry.metrics`; with metering off they fall back to
        the always-maintained legacy attributes, so the dict shape is
        stable either way; with metering on the dict also carries latency
        percentiles plus the reliability / fault-tolerance totals.
        """
        cache = self.planner.cache
        tel = self.telemetry
        ft = self.fault_tolerance
        if tel.metering:
            m = tel.metrics
            s: Dict[str, float] = {
                "queries_served": int(m.counter("queries_total").value),
                "plans_cached": len(cache),
                "plan_cache_hits": int(
                    m.counter("plan_cache_hits_total").value),
                "plan_cache_misses": int(
                    m.counter("plan_cache_misses_total").value),
                "plan_cache_hit_rate": cache.hit_rate,
                "plan_cache_evictions": int(
                    m.counter("plan_cache_evictions_total").value),
                "cse_planes": int(m.counter("cse_planes_total").value),
                "compile_count": self.planner.compile_count,
                "total_modeled_ns": m.counter("modeled_ns_total").value,
                "total_energy_nj": m.counter(
                    "modeled_energy_nj_total").value,
                "n_chips": self.n_chips or 1,
                "chip_sweeps": self.cluster.sweeps if self.cluster else 0,
                "parity_checks": int(
                    m.counter("parity_checks_total").value),
                "batches": int(m.counter("batches_total").value),
                "modeled_latency_p50_ns": m.histogram(
                    "modeled_latency_ns").percentile(50),
                "modeled_latency_p99_ns": m.histogram(
                    "modeled_latency_ns").percentile(99),
                "reliability_replicas": int(
                    m.counter("reliability_replicas_total").value),
                "ecc_tiebreaks": int(
                    m.counter("ecc_tiebreaks_total").value),
                "tra_corrected_bits": int(
                    m.counter("tra_corrected_bits_total").value),
                "chip_rescales": int(
                    m.counter("chip_rescales_total").value),
                "serve_queue_depth": m.gauge("serve_queue_depth").value,
                "serve_shed": int(m.counter("serve_shed_total").value),
                "serve_ticks": int(m.counter("serve_ticks_total").value),
            }
        else:
            s = {
                "queries_served": self.scheduler.queries_served,
                "plans_cached": len(cache),
                "plan_cache_hits": cache.hits,
                "plan_cache_misses": cache.misses,
                "plan_cache_hit_rate": cache.hit_rate,
                "plan_cache_evictions": cache.evictions,
                "cse_planes": self.scheduler.cse_planes_built,
                "compile_count": self.planner.compile_count,
                "total_modeled_ns": self.scheduler.total_modeled_ns,
                "total_energy_nj": self.scheduler.total_energy_nj,
                "n_chips": self.n_chips or 1,
                "chip_sweeps": self.cluster.sweeps if self.cluster else 0,
                "parity_checks": self.scheduler.parity_checks,
                "chip_rescales": (sum(
                    1 for t in ft.timeline if t.startswith("rescale@"))
                    if ft else 0),
            }
        # fault-tolerance state folds in from the policy object (the
        # legacy source of truth); the registry's ft_* counters mirror it
        s["replays"] = ft.replays if ft else 0
        s["failures"] = ft.failures if ft else 0
        s["stragglers"] = len(ft.stragglers) if ft else 0
        s["straggler_ema_s"] = (ft.monitor.ema or 0.0) if ft else 0.0
        return s

    def export_chrome_trace(self, path=None):
        """Export the batch span trees + modeled timelines recorded so far
        as Chrome trace-event JSON (needs `telemetry` with tracing on);
        validated against the trace schema, written to `path` if given."""
        return self.telemetry.export_chrome_trace(path)

    def prometheus(self) -> str:
        """The metrics registry as Prometheus text exposition format."""
        return self.telemetry.prometheus()
