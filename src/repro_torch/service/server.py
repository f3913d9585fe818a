"""Continuous-serving runtime: the long-lived `ServingLoop`.

`QueryService` (service.py) is a one-shot facade: every `query_batch`
serializes host-side planning against device execution at the batch
boundary. This module promotes serving to a persistent loop (ROADMAP
item 1, in the style of vLLM's TPU worker) built from four pieces:

  * **request queue** — open-loop arrivals land in per-tenant FIFO
    queues (`submit()` in live mode, an `Arrival` trace in deterministic
    replay). Per-tenant order is preserved end-to-end: the property
    suite asserts no query is lost, duplicated, or reordered within a
    tenant.
  * **tick packing** — each scheduler tick selects up to ``capacity``
    queries with deficit-round-robin per-tenant fairness and hands them
    to the scheduler, which groups them by canonical plan shape into
    stacked dispatches over the fixed ``(max_chips, local_banks,
    queries)`` slot grid (`capacity = slots * depth`: every (chip, bank)
    slot holds ``depth`` in-flight queries per tick).
  * **double-buffered dispatch** — the host-side parse/plan/bind of tick
    N+1 (`Scheduler.plan_queries`) overlaps with device execution of
    tick N (a one-slot worker thread running
    ``Scheduler.submit(preplanned=...)``). Tick N+1's formation time is
    projected from an EMA service-time estimate, exactly the information
    a real server has while a tick is still in flight — so the replay is
    deterministic regardless of thread scheduling. Tracing serializes
    the pipeline (span stacks are single-threaded by design).
  * **admission control / backpressure** — with an `SloConfig`, each
    tick projects every queued query's sojourn (waited-so-far + queue
    position x EMA per-query service time). Policy "shed" drops the
    newest lowest-priority queries until the projection fits the p99
    target (`QueryShedError` on the handle); "defer" parks the
    lowest-priority class while higher-priority work drains (never
    reordering within a tenant — a deferred head parks its whole
    queue). Expired per-query deadlines shed regardless of policy.

Everything is instrumented through the telemetry layer (`obs`): queue-depth
gauge, shed/deferred counters, per-tick occupancy histogram, tick spans
plus queue-depth counter samples in the Chrome trace.

Two clocks, as everywhere in this repo: `run_trace` replays an arrival
trace in *modeled* nanoseconds (DDR3 AAP timing — deterministic,
CI-gateable p99s), while wall-clock throughput of the pipelined loop vs
the serialized closed loop is measured separately
(`benchmarks/serve_loop.py`). Live mode (`start`/`submit`/`stop`) runs
the same machinery against the wall clock.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.service.config import DEFER, OBSERVE, SHED, SloConfig
from repro_torch.service.scheduler import POPCOUNT, Query, QueryResult

# handle lifecycle states
PENDING = "pending"
DONE = "done"
SHED_STATUS = "shed"
FAILED = "failed"

SERVED = "served"


class QueryShedError(RuntimeError):
    """The admission controller dropped this query before execution."""

    def __init__(self, message: str, reason: Optional[str] = None):
        super().__init__(message)
        self.reason = reason


class QueryHandle:
    """Async result handle returned by ``submit()``.

    ``result()`` blocks until the query is served (returning its
    `QueryResult`), raises `QueryShedError` if admission control dropped
    it, or re-raises the serving failure. ``done()`` is the non-blocking
    probe. Handles resolve exactly once.
    """

    def __init__(self, query: Query, priority: int = 0,
                 deadline_ns: Optional[float] = None):
        self.query = query
        self.priority = priority
        self.deadline_ns = deadline_ns
        self.status = PENDING
        self._event = threading.Event()
        self._result: Optional[QueryResult] = None
        self._error: Optional[BaseException] = None

    @property
    def tenant(self) -> Optional[str]:
        return self.query.tenant

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> QueryResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query not served within {timeout}s (status={self.status})")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    # -- resolution (serving side) ------------------------------------------

    def _resolve(self, result: QueryResult) -> None:
        self._result = result
        self.status = DONE
        self._event.set()

    def _shed(self, reason: str) -> None:
        self._error = QueryShedError(f"query shed ({reason})", reason)
        self.status = SHED_STATUS
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self.status = FAILED
        self._event.set()


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop request: a query arriving at modeled time ``t_ns``."""

    t_ns: float
    query: Query
    priority: int = 0
    deadline_ns: Optional[float] = None


@dataclasses.dataclass
class ServeRecord:
    """Per-query outcome of a serving run, in arrival order."""

    index: int
    tenant: Optional[str]
    priority: int
    arrival_ns: float
    status: str                       # "served" | "shed"
    shed_reason: Optional[str] = None
    tick: int = -1
    dispatch_ns: float = 0.0
    complete_ns: float = 0.0
    result: Optional[QueryResult] = None

    @property
    def sojourn_ns(self) -> float:
        """Modeled arrival -> completion latency (served records)."""
        return self.complete_ns - self.arrival_ns


@dataclasses.dataclass
class TickStats:
    """One scheduler tick: packing + timing accounting."""

    tick: int
    form_ns: float                    # formation time (modeled)
    start_ns: float                   # device dispatch start (modeled)
    makespan_ns: float
    n_queries: int
    n_groups: int                     # distinct plan shapes packed
    occupancy: float                  # n_queries / capacity
    queue_depth: int                  # left queued after formation
    plan_wall_us: float = 0.0
    exec_wall_us: float = 0.0


@dataclasses.dataclass
class ServeReport:
    """Aggregate outcome of one serving run (trace replay or live)."""

    records: List[ServeRecord]
    ticks: List[TickStats]
    capacity: int
    wall_s: float
    slo: Optional[SloConfig] = None
    deferred_total: int = 0
    pipelined: bool = False

    @property
    def served(self) -> List[ServeRecord]:
        return [r for r in self.records if r.status == SERVED]

    @property
    def shed(self) -> List[ServeRecord]:
        return [r for r in self.records if r.status == SHED_STATUS]

    @property
    def duration_ns(self) -> float:
        """Modeled first-arrival -> last-completion span."""
        served = self.served
        if not served:
            return 0.0
        first = min(r.arrival_ns for r in self.records)
        return max(r.complete_ns for r in served) - first

    @property
    def sustained_qps(self) -> float:
        """Modeled served-query throughput over the whole run."""
        d = self.duration_ns
        return len(self.served) / (d * 1e-9) if d > 0 else 0.0

    @property
    def wall_qps(self) -> float:
        """Host wall-clock served-query throughput (pipeline metric)."""
        return len(self.served) / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def shed_frac(self) -> float:
        return len(self.shed) / len(self.records) if self.records else 0.0

    @property
    def occupancy_mean(self) -> float:
        if not self.ticks:
            return 0.0
        return sum(t.occupancy for t in self.ticks) / len(self.ticks)

    def sojourn_percentile_ns(self, pct: float) -> float:
        """Nearest-rank percentile of served sojourns (as BatchReport)."""
        lats = sorted(r.sojourn_ns for r in self.served)
        if not lats:
            return 0.0
        i = min(len(lats) - 1, int(math.ceil(pct / 100.0 * len(lats))) - 1)
        return lats[max(i, 0)]

    def results(self) -> List[Optional[QueryResult]]:
        """Per-arrival results in arrival order (None where shed)."""
        return [r.result for r in self.records]


@dataclasses.dataclass
class _Item:
    """A queued query inside the loop."""

    index: int
    seq: int                          # admission order tiebreak
    arrival_ns: float
    query: Query
    priority: int
    deadline_ns: Optional[float]
    handle: Optional[QueryHandle] = None
    tick: int = -1

    @property
    def tenant_key(self) -> str:
        return self.query.tenant or ""


class _Done:
    """Already-resolved stand-in for a Future (serial mode)."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


@dataclasses.dataclass
class _Inflight:
    future: object                    # Future[(BatchReport, exec_wall_us)]
    batch: List[_Item]
    start_ns: float                   # exact: device was free at launch
    form_ns: float
    est_free_ns: float                # projected completion (EMA)
    plan_wall_us: float
    tick: int


class ServingLoop:
    """Long-lived slot-packing serving loop over a `QueryService`.

    Deterministic replay: ``run_trace(arrivals)`` steps modeled time
    through an open-loop arrival trace and returns a `ServeReport`.
    Live serving: ``start()`` spawns the loop thread, ``submit()``
    returns a `QueryHandle`, ``stop()`` drains and reports.
    """

    def __init__(self, service, *, depth: int = 4,
                 capacity: Optional[int] = None,
                 slo: Optional[SloConfig] = None,
                 drr_quantum: int = 4,
                 pipeline: bool = True,
                 max_queue: Optional[int] = None,
                 est_alpha: float = 0.25,
                 on_tick=None):
        self.service = service
        self.scheduler = service.scheduler
        self.telemetry = service.telemetry
        cluster = service.cluster
        #: (chip, bank) positions of the placement slot grid — the
        #: granularity (max_chips * n_banks) when clustered, else the
        #: bank group
        self.slots = cluster.slots if cluster is not None else service.n_banks
        self.depth = depth
        self.capacity = capacity if capacity is not None \
            else self.slots * depth
        if self.capacity <= 0:
            raise ValueError("capacity must be positive")
        self.slo = slo if slo is not None else service.config.slo
        self.drr_quantum = max(1, drr_quantum)
        self.pipeline = pipeline
        self.max_queue = max_queue
        self.est_alpha = est_alpha
        #: optional callback(TickStats) fired as each tick finalizes —
        #: the launcher's live dashboard hook
        self.on_tick = on_tick
        self.accepting = False
        #: serializes device dispatch against the service's direct path
        self.dispatch_lock = service._dispatch_lock
        self._thread: Optional[threading.Thread] = None
        self._cv = threading.Condition()
        self._live_buffer: List[Tuple[float, _Item]] = []
        self._stopping = False
        self._live_error: Optional[BaseException] = None
        self._reset_state()
        if self.telemetry.metering:
            m = self.telemetry.metrics
            self._g_depth = m.gauge("serve_queue_depth")
            self._c_admitted = m.counter("serve_admitted_total")
            self._c_shed = m.counter("serve_shed_total")
            self._c_deferred = m.counter("serve_deferred_total")
            self._c_ticks = m.counter("serve_ticks_total")
            self._h_occupancy = m.histogram("serve_tick_occupancy")
            self._h_sojourn = m.histogram("serve_sojourn_ns")

    # -- shared state --------------------------------------------------------

    def _reset_state(self) -> None:
        self._queues: "OrderedDict[str, Deque[_Item]]" = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self._rr_start = 0
        self._n_queued = 0
        self._seq = 0
        self._tick_seq = 0
        self._device_free = 0.0
        self._est_query_ns: Optional[float] = None
        self._records: List[ServeRecord] = []
        self._ticks: List[TickStats] = []
        self._deferred_total = 0

    @property
    def queue_depth(self) -> int:
        return self._n_queued

    def _admit(self, item: _Item) -> None:
        if (self.max_queue is not None
                and self._n_queued >= self.max_queue):
            self._shed_item(item, "backpressure", item.arrival_ns)
            return
        q = self._queues.get(item.tenant_key)
        if q is None:
            q = self._queues[item.tenant_key] = deque()
            self._deficit.setdefault(item.tenant_key, 0.0)
        q.append(item)
        self._n_queued += 1
        if self.telemetry.metering:
            self._c_admitted.inc()

    def _queued_snapshot(self) -> List[_Item]:
        """All queued items in global arrival order (service-order
        approximation for sojourn projection)."""
        items = [it for q in self._queues.values() for it in q]
        items.sort(key=lambda it: (it.arrival_ns, it.seq))
        return items

    def _oldest_arrival(self) -> float:
        return min(q[0].arrival_ns for q in self._queues.values() if q)

    def _remove(self, item: _Item) -> None:
        self._queues[item.tenant_key].remove(item)
        self._n_queued -= 1

    def _shed_item(self, item: _Item, reason: str, now_ns: float) -> None:
        self._records.append(ServeRecord(
            index=item.index, tenant=item.query.tenant,
            priority=item.priority, arrival_ns=item.arrival_ns,
            status=SHED_STATUS, shed_reason=reason, complete_ns=now_ns))
        if item.handle is not None:
            item.handle._shed(reason)
        tel = self.telemetry
        if tel.metering:
            self._c_shed.inc()
        if tel.tracing:
            tel.tracer.instant("serve_shed", index=item.index,
                               reason=reason, tenant=item.query.tenant)

    # -- admission control ---------------------------------------------------

    def _projection_target(self) -> Optional[float]:
        if (self.slo is None or self.slo.policy == OBSERVE
                or self._est_query_ns is None):
            return None
        return self.slo.p99_ns * self.slo.safety

    def _projected_sojourns(self, now_ns: float) -> List[Tuple[float, _Item]]:
        """(projected sojourn, item) per queued query: time already
        waited plus queue position x EMA per-query service time — the
        modeled queue delay the SLO policy acts on."""
        est = self._est_query_ns or 0.0
        return [((now_ns - it.arrival_ns) + (p + 1) * est, it)
                for p, it in enumerate(self._queued_snapshot())]

    def _shed_deadlines(self, now_ns: float) -> None:
        expired = [it for q in self._queues.values() for it in q
                   if it.deadline_ns is not None
                   and now_ns - it.arrival_ns > it.deadline_ns]
        for it in expired:
            self._remove(it)
            self._shed_item(it, "deadline", now_ns)

    def _slo_shed(self, now_ns: float) -> None:
        """Drop newest lowest-priority queries until every projected
        sojourn fits the target."""
        target = self._projection_target()
        if target is None:
            return
        while True:
            over = [it for s, it in self._projected_sojourns(now_ns)
                    if s > target]
            if not over:
                return
            victim = min(over, key=lambda it: (it.priority,
                                               -it.arrival_ns, -it.seq))
            self._remove(victim)
            self._shed_item(victim, "slo", now_ns)

    def _defer_floor(self, now_ns: float) -> Optional[int]:
        """Priority class parked this tick (defer policy, on breach)."""
        target = self._projection_target()
        if target is None:
            return None
        if not any(s > target for s, _ in self._projected_sojourns(now_ns)):
            return None
        prios = {it.priority for q in self._queues.values() for it in q}
        if len(prios) < 2:
            return None     # nothing lower-priority to defer to
        return min(prios)

    # -- tick formation (DRR) ------------------------------------------------

    def _form_tick(self, now_ns: float, can_defer: bool) -> List[_Item]:
        """Select up to ``capacity`` queries, deficit-round-robin fair.

        Each round visits the active tenants in rotating order, credits
        each visited tenant ``drr_quantum`` units, and drains its FIFO
        head while credit and room remain — a hog tenant gets the same
        per-round credit as everyone else, so its backlog cannot starve
        light tenants. A tenant whose head is deferred is skipped whole
        (taking a later query would reorder within the tenant).
        """
        self._shed_deadlines(now_ns)
        if self.slo is not None and self.slo.policy == SHED:
            self._slo_shed(now_ns)
        floor = None
        if can_defer and self.slo is not None and self.slo.policy == DEFER:
            floor = self._defer_floor(now_ns)
            if floor is not None:
                parked = sum(1 for q in self._queues.values()
                             for it in q if it.priority <= floor)
                self._deferred_total += parked
                if self.telemetry.metering:
                    self._c_deferred.inc(parked)
        selected: List[_Item] = []
        room = self.capacity
        order = [t for t in self._queues if self._queues[t]]
        if not order:
            return selected
        self._rr_start %= len(order)
        order = order[self._rr_start:] + order[:self._rr_start]
        self._rr_start += 1
        while room > 0:
            progressed = False
            for t in order:
                q = self._queues[t]
                if not q:
                    self._deficit[t] = 0.0
                    continue
                self._deficit[t] = min(self._deficit[t] + self.drr_quantum,
                                       float(self.capacity))
                while q and self._deficit[t] >= 1.0 and room > 0:
                    head = q[0]
                    if floor is not None and head.priority <= floor:
                        break       # deferred head parks the tenant queue
                    q.popleft()
                    self._n_queued -= 1
                    self._deficit[t] -= 1.0
                    selected.append(head)
                    room -= 1
                    progressed = True
                if not q:
                    self._deficit[t] = 0.0
            if not progressed:
                break
        if self.telemetry.metering:
            self._g_depth.set(self._n_queued)
        return selected

    # -- dispatch ------------------------------------------------------------

    def _execute(self, queries: List[Query], bound) -> object:
        """Device stage: one preplanned scheduler dispatch.

        CSE stays off in the loop — the sharing pass compiles ephemeral
        plans through the planner cache the pipelined host stage is
        using from the other thread; cross-tick plan-shape packing is
        the loop's sharing mechanism instead.
        """
        with self.dispatch_lock:
            return self.scheduler.submit(queries, preplanned=bound,
                                         allow_cse=False)

    def _launch(self, batch: List[_Item], bound, form_ns: float,
                plan_us: float, pool) -> _Inflight:
        start = max(self._device_free, form_ns)
        tick = self._tick_seq
        self._tick_seq += 1
        for it in batch:
            it.tick = tick
        queries = [it.query for it in batch]

        def run():
            w0 = time.perf_counter()
            rep = self._execute(queries, bound)
            return rep, (time.perf_counter() - w0) * 1e6

        fut = pool.submit(run) if pool is not None else _Done(run())
        est = self._est_query_ns or 0.0
        return _Inflight(fut, batch, start, form_ns,
                         start + est * len(batch), plan_us, tick)

    def _finalize(self, fl: _Inflight) -> None:
        rep, exec_us = fl.future.result()
        self._device_free = fl.start_ns + rep.makespan_ns
        per_q = rep.makespan_ns / max(1, len(fl.batch))
        if self._est_query_ns is None:
            self._est_query_ns = per_q
        else:
            a = self.est_alpha
            self._est_query_ns = a * per_q + (1 - a) * self._est_query_ns
        occupancy = len(fl.batch) / self.capacity
        stats = TickStats(
            tick=fl.tick, form_ns=fl.form_ns, start_ns=fl.start_ns,
            makespan_ns=rep.makespan_ns, n_queries=len(fl.batch),
            n_groups=rep.n_plan_groups, occupancy=occupancy,
            queue_depth=self._n_queued, plan_wall_us=fl.plan_wall_us,
            exec_wall_us=exec_us)
        self._ticks.append(stats)
        if self.on_tick is not None:
            self.on_tick(stats)
        tel = self.telemetry
        for it, r in zip(fl.batch, rep.results):
            complete = fl.start_ns + r.latency_ns
            self._records.append(ServeRecord(
                index=it.index, tenant=it.query.tenant,
                priority=it.priority, arrival_ns=it.arrival_ns,
                status=SERVED, tick=fl.tick, dispatch_ns=fl.start_ns,
                complete_ns=complete, result=r))
            if it.handle is not None:
                it.handle._resolve(r)
            if tel.metering:
                self._h_sojourn.observe(complete - it.arrival_ns)
        if tel.metering:
            self._c_ticks.inc()
            self._h_occupancy.observe(occupancy)
            self._g_depth.set(self._n_queued)
        if tel.tracing:
            tr = tel.tracer
            tr.model_event("tick", fl.start_ns, rep.makespan_ns,
                           "serve/ticks", tick=fl.tick,
                           n_queries=len(fl.batch),
                           n_groups=rep.n_plan_groups,
                           occupancy=occupancy)
            tr.counter_event("serve_queue_depth", fl.start_ns,
                             "serve/queue", depth=self._n_queued)

    # -- deterministic trace replay ------------------------------------------

    def run_trace(self, arrivals: Sequence[Arrival],
                  pipeline: Optional[bool] = None) -> ServeReport:
        """Replay an open-loop arrival trace in modeled time.

        ``pipeline=True`` (default: the loop's setting) overlaps host
        planning of tick N+1 with device execution of tick N on a
        one-slot worker; formation of the overlapped tick projects the
        in-flight completion from the service-time EMA, so the replay
        is deterministic either way. Tracing forces serial mode (span
        stacks are single-threaded).
        """
        use_pipe = self.pipeline if pipeline is None else pipeline
        if self.telemetry.tracing:
            use_pipe = False
        self._reset_state()
        items = [
            _Item(index=i, seq=i, arrival_ns=a.t_ns, query=a.query,
                  priority=a.priority, deadline_ns=a.deadline_ns)
            for i, a in enumerate(
                sorted(arrivals, key=lambda a: a.t_ns))
        ]
        self._seq = len(items)
        pending: Deque[_Item] = deque(items)
        pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                if use_pipe else None)
        wall0 = time.perf_counter()
        prev: Optional[_Inflight] = None
        min_now = 0.0
        tel = self.telemetry
        live = tel.spans_on()
        try:
            while pending or self._n_queued or prev is not None:
                est_free = (prev.est_free_ns if prev is not None
                            else self._device_free)
                cands = []
                if self._n_queued:
                    cands.append(self._oldest_arrival())
                if pending:
                    cands.append(pending[0].arrival_ns)
                batch: List[_Item] = []
                bound = None
                now = plan_us = 0.0
                if cands:
                    now = max(est_free, min(cands), min_now)
                    while pending and pending[0].arrival_ns <= now:
                        self._admit(pending.popleft())
                    can_defer = bool(pending) or prev is not None
                    batch = self._form_tick(now, can_defer)
                    if batch:
                        if live:
                            tel.begin("tick", tick=self._tick_seq,
                                      n_queries=len(batch))
                            tel.begin("tick_plan")
                        w0 = time.perf_counter()
                        # host stage of the double buffer: overlapped
                        # with `prev` still executing on the worker
                        bound = self.scheduler.plan_queries(
                            [it.query for it in batch])
                        plan_us = (time.perf_counter() - w0) * 1e6
                        if live:
                            tel.end()    # tick_plan
                if prev is not None:
                    self._finalize(prev)
                    prev = None
                if batch:
                    min_now = 0.0
                    prev = self._launch(batch, bound, now, plan_us, pool)
                    if pool is None:
                        self._finalize(prev)
                        prev = None
                    if live:
                        tel.end()        # tick
                elif cands and pending:
                    # nothing eligible at `now`: the next attempt must
                    # see new work, or it would spin on the same state
                    min_now = pending[0].arrival_ns
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        wall_s = time.perf_counter() - wall0
        self._records.sort(key=lambda r: r.index)
        return ServeReport(
            records=self._records, ticks=self._ticks,
            capacity=self.capacity, wall_s=wall_s, slo=self.slo,
            deferred_total=self._deferred_total, pipelined=use_pipe)

    # -- live serving --------------------------------------------------------

    def _wall_ns(self) -> float:
        return (time.perf_counter() - self._wall0) * 1e9

    def start(self) -> "ServingLoop":
        """Spawn the live serving thread; `submit()` now enqueues."""
        if self._thread is not None:
            raise RuntimeError("serving loop already started")
        self._reset_state()
        self._stopping = False
        self._live_error = None
        self._wall0 = time.perf_counter()
        self.accepting = True
        self._thread = threading.Thread(target=self._live_run,
                                        name="serving-loop", daemon=True)
        self._thread.start()
        return self

    def submit(self, query: Union[Query, str, object], *,
               mode: str = POPCOUNT, tenant: Optional[str] = None,
               priority: int = 0,
               deadline_ns: Optional[float] = None) -> QueryHandle:
        """Enqueue one query on the live loop; returns its handle."""
        q = query if isinstance(query, Query) else Query(query, mode, tenant)
        handle = QueryHandle(q, priority=priority, deadline_ns=deadline_ns)
        with self._cv:
            if not self.accepting:
                raise RuntimeError(
                    "serving loop is not accepting (call start())")
            self._live_buffer.append((self._wall_ns(), handle))
            self._cv.notify()
        return handle

    def _live_run(self) -> None:
        try:
            while True:
                with self._cv:
                    if (not self._live_buffer and not self._stopping
                            and self._n_queued == 0):
                        self._cv.wait(0.02)
                    buf, self._live_buffer = self._live_buffer, []
                    stopping = self._stopping
                for t_ns, handle in buf:
                    self._admit(_Item(
                        index=self._seq, seq=self._seq, arrival_ns=t_ns,
                        query=handle.query, priority=handle.priority,
                        deadline_ns=handle.deadline_ns, handle=handle))
                    self._seq += 1
                if self._n_queued == 0:
                    if stopping:
                        return
                    continue
                now = self._wall_ns()
                # live clock: the same formation/admission machinery
                # runs on wall nanoseconds (the EMA and projections stay
                # unit-consistent because ticks are finalized on wall
                # time below)
                batch = self._form_tick(now, can_defer=not stopping)
                if not batch:
                    continue
                bound = self.scheduler.plan_queries(
                    [it.query for it in batch])
                fl = self._launch(batch, bound, now, 0.0, None)
                # overwrite modeled bookkeeping with wall: device is
                # free when the dispatch actually returned
                rep, exec_us = fl.future.result()
                end_ns = self._wall_ns()
                fl.start_ns = now
                wall_makespan = max(end_ns - now, 1.0)
                rep = dataclasses.replace(rep, makespan_ns=wall_makespan)
                for r in rep.results:
                    r.latency_ns = wall_makespan
                fl.future = _Done((rep, exec_us))
                self._finalize(fl)
        except BaseException as e:  # noqa: BLE001 - fail pending handles
            self._live_error = e
            for q in self._queues.values():
                for it in q:
                    if it.handle is not None:
                        it.handle._fail(e)
            with self._cv:
                for _, handle in self._live_buffer:
                    handle._fail(e)
                self._live_buffer = []

    def stop(self, drain: bool = True) -> ServeReport:
        """Stop the live loop (draining the queue first by default)."""
        if self._thread is None:
            raise RuntimeError("serving loop was not started")
        with self._cv:
            self.accepting = False
            self._stopping = True
            if not drain:
                for q in self._queues.values():
                    while q:
                        it = q.popleft()
                        self._n_queued -= 1
                        self._shed_item(it, "shutdown", self._wall_ns())
            self._cv.notify()
        self._thread.join()
        self._thread = None
        if self._live_error is not None:
            raise self._live_error
        self._records.sort(key=lambda r: r.index)
        return ServeReport(
            records=self._records, ticks=self._ticks,
            capacity=self.capacity,
            wall_s=time.perf_counter() - self._wall0, slo=self.slo,
            deferred_total=self._deferred_total, pipelined=False)
