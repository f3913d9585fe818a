"""Batching scheduler: concurrent queries -> bank-parallel execution.

The scheduling insight mirrors the hardware: the memory controller can only
broadcast ONE AAP sequence at a time, but every bank applies it to its own
rows concurrently (paper §5.4/§7). So the scheduler groups a batch's
queries by their *canonical plan* — queries with the same program shape
(every tenant's weekly OR-tree, every range scan of the same width) become
one stacked dispatch where the "bank axis" is the query axis — and
executes each group through the plan's cached
`core.lowering.LoweredProgram` in a single VM dispatch: one kernel launch
per plan-group. The dispatch backend is per plan — the cost-based
optimizer records "cuda"/"interp"/"torch" on each `Plan`
(`service.optimizer.choose_backend`); a plan that carries no choice runs
the VM wrapper, which launches the CUDA kernel on a card and its plain
version on the CPU.

Before grouping, the batch runs the optimizer's cross-query sharing pass
(`_apply_cse`): bound sub-DAGs appearing in >= 2 queries compile once into
ephemeral `$cse{k}` planes, dispatched first, and consumers reference the
plane as an input leaf — a RowClone-style copy on the modeled bus instead
of recomputation. The pass keeps the rewrite only when it strictly lowers
the batch's total AAPs, so `BatchReport.total_aaps <= baseline_aaps`
always holds, and the modeled timeline charges shared work exactly once.

Three result modes per query (paper §8 workloads + the arithmetic layer):
  * `popcount`  — COUNT(*) of the predicate bitvector.
  * `materialize` — the packed result itself: one word vector for boolean
    plans, the (n_bits, words) result-plane stack for arithmetic plans,
    returned as host uint32 arrays (the reference's word type).
  * `aggregate` — the scalar sum_j 2**j * popcount(output plane j).

Latency is modeled, not measured: per 8KB row-block, placing a query's
operands in its bank costs serialized inter-bank transfers on the shared
internal bus, while per-bank AAP compute overlaps across banks. Energy
comes from `core.energy` command counts.

`run_queries_unbatched` is the independent reference path (fresh compile
per query over its natural row names, one micro-op interpreter run per
query, 1-bank serial schedule); the batched scheduler must match it
bit-for-bit.

Under a TRA reliability mode (`core.errors.ReliabilityConfig`) every
lowered plan group runs as seeded fault-injected replicas: ``"vote"`` runs
k of them and votes their output planes with the majority kernel,
``"ecc"`` runs two, accepts them when they agree and otherwise runs a
third and votes, and opens every batch with the catalog's parity probe.
The modeled timeline charges each replica's in-bank compute and one AAP
per voted output plane.

Distributed mode (``cluster=`` a `core.cluster.ChipCluster`): every
plan-group dispatches as one VM launch per chip over its word-shards
(`_run_group_sharded`) and popcount/aggregate results reduce with a
chip-axis tree psum, so only count scalars ever cross a chip boundary.
The timeline model gains per-chip buses (transfers serialize per chip,
chips are parallel) plus a ceil(log2 chips)-hop reduction term. Under a
fault-tolerance policy (``fault_tolerance=`` a
`dist.fault_tolerance.FaultTolerance`) every plan-group dispatch is
timed, replayed on failure and flagged when it straggles
(`_run_group_resilient`).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import arith_compiler, compiler, engine, lowering
from repro_torch.core.bitplane import ROW_BITS, to_uint32
from repro_torch.core.compiler import Expr, compile_expr_fused
from repro_torch.core.timing import DDR3_1600, DramTiming
from repro_torch.obs.telemetry import set_telemetry
from repro_torch.ops.popcount import popcount_words
from repro_torch.service.catalog import Catalog, plane_name
from repro_torch.service.optimizer import (CSE_PREFIX, CseBatch, CseExplain,
                                           ExplainReport, PlanExplain,
                                           bind_expr, plan_group_cse)
from repro_torch.service.planner import (DST, ArithQuery, BoundPlan, Plan,
                                         Planner, parse_any)

POPCOUNT = "popcount"
MATERIALIZE = "materialize"
AGGREGATE = "aggregate"


@dataclasses.dataclass
class Query:
    """One client request over catalog names."""

    query: Union[str, Expr, ArithQuery]
    mode: str = POPCOUNT
    tenant: Optional[str] = None

    def __post_init__(self):
        if self.mode not in (POPCOUNT, MATERIALIZE, AGGREGATE):
            raise ValueError(f"unknown result mode {self.mode!r}")


@dataclasses.dataclass
class QueryResult:
    """Outcome of one query: value + modeled cost accounting.

    `scalar` is always populated — the weighted popcount
    sum_j 2**j * popcount(plane j), which for boolean plans is exactly the
    predicate popcount. `planes` is the canonical packed view of a
    materialized result: a ``(n_output_planes, n_words)`` uint32 array.
    `value` keeps the per-mode shape: popcount/aggregate int,
    boolean-materialize 1-D words, arithmetic-materialize 2-D plane stack.
    """

    index: int                    # position in the submitted batch
    mode: str
    value: Union[int, np.ndarray]  # per-mode shape (see above)
    latency_ns: float             # modeled batch-epoch -> completion
    bank: int
    cache_hit: bool
    n_aaps: int
    energy_nj: float
    tenant: Optional[str] = None
    chip: int = 0
    #: weighted-popcount scalar, populated for EVERY mode
    scalar: Optional[int] = None

    @property
    def planes(self) -> np.ndarray:
        """Canonical ``(n_output_planes, n_words)`` packed result."""
        if self.mode != MATERIALIZE:
            raise ValueError(
                f"planes: {self.mode!r} query carries only the scalar; "
                "run with mode=MATERIALIZE for packed planes")
        v = np.asarray(self.value)
        return v[None] if v.ndim == 1 else v

    @property
    def words(self) -> np.ndarray:
        """Single-plane (boolean) materialized result as flat words."""
        p = self.planes
        if p.shape[0] != 1:
            raise ValueError(
                f"words: result has {p.shape[0]} planes (arithmetic "
                "query); use .planes")
        return p[0]


@dataclasses.dataclass
class BatchReport:
    """Aggregate view of one scheduler batch.

    `n_cse_planes` counts the batch's shared subexpression planes
    (computed once, consumed by >= 2 queries); `total_aaps` is the
    all-blocks modeled AAP spend including those defs, `baseline_aaps`
    what the unoptimized pipeline (no reordering, no sharing) would have
    spent — `total_aaps <= baseline_aaps` is an optimizer invariant.
    """

    results: List[QueryResult]
    makespan_ns: float
    n_banks: int
    n_plan_groups: int
    n_chips: int = 1
    n_cse_planes: int = 0
    total_aaps: int = 0
    baseline_aaps: int = 0

    @property
    def qps(self) -> float:
        if self.makespan_ns == 0.0:
            return 0.0
        return len(self.results) / (self.makespan_ns * 1e-9)

    def latency_percentile_ns(self, pct: float) -> float:
        lats = sorted(r.latency_ns for r in self.results)
        if not lats:
            return 0.0
        i = min(len(lats) - 1, int(math.ceil(pct / 100.0 * len(lats))) - 1)
        return lats[max(i, 0)]


def _weighted(counts: np.ndarray, n_members: int) -> List[int]:
    """Per-member ``sum_j 2**j * counts[j, s]`` in exact Python ints."""
    return [sum(int(counts[j, s]) << j for j in range(counts.shape[0]))
            for s in range(n_members)]


@dataclasses.dataclass
class Scheduler:
    """Batches queries over the bank group with a modeled timeline."""

    catalog: Catalog
    planner: Planner = dataclasses.field(default_factory=Planner)
    n_banks: int = 8
    timing: DramTiming = DDR3_1600
    #: distributed mode: a `core.cluster.ChipCluster` — plan-groups become
    #: one VM launch per chip over (banks x queries) shards and popcounts
    #: aggregate with a chip-axis tree psum. None = the single-process
    #: path (one device, bank axis only).
    cluster: Optional["ChipCluster"] = None  # noqa: F821 (forward ref)
    #: TRA reliability mode (`core.errors.ReliabilityConfig`): "vote" runs
    #: every lowered plan-group k times with independent seeded fault draws
    #: and bitwise-votes the output planes; "ecc" dual-runs with a vote
    #: tie-break plus a catalog parity check per batch. Injection targets
    #: the single-process VM path; distributed deployments handle faults
    #: at chip granularity through `fault_tolerance` instead.
    reliability: Optional["ReliabilityConfig"] = None  # noqa: F821
    #: chip/straggler fault policy (`dist.fault_tolerance.FaultTolerance`):
    #: plan-group dispatches are timed, replayed on failure (after the
    #: recovery hook — QueryService installs an elastic rescale-down), and
    #: flagged when they straggle past the EMA threshold.
    fault_tolerance: Optional["FaultTolerance"] = None  # noqa: F821
    #: observability sink (`repro_torch.obs.Telemetry`): span tree + modeled
    #: timeline per batch when tracing, registry counters/histograms when
    #: metering. None = `NULL_TELEMETRY` (both off, zero-allocation path).
    telemetry: Optional["Telemetry"] = None  # noqa: F821

    def __post_init__(self):
        self.queries_served = 0
        self.total_modeled_ns = 0.0
        self.total_energy_nj = 0.0
        self.parity_checks = 0
        self.cse_planes_built = 0
        self._group_seq = 0      # deterministic per-dispatch key chain
        if self.telemetry is None:
            from repro_torch.obs.telemetry import NULL_TELEMETRY

            self.telemetry = NULL_TELEMETRY
        # one stat surface: the planner's spans and the plan cache's
        # hit/miss counters land on the same sink as the scheduler's
        self.planner.telemetry = self.telemetry
        if self.telemetry.metering:
            m = self.telemetry.metrics
            self.planner.cache.attach_metrics(m)
            self._m_queries = m.counter("queries_total")
            self._m_batches = m.counter("batches_total")
            self._m_groups = m.counter("plan_groups_total")
            self._m_aaps = m.counter("aaps_total")
            self._m_energy = m.counter("modeled_energy_nj_total")
            self._m_modeled_ns = m.counter("modeled_ns_total")
            self._m_parity = m.counter("parity_checks_total")
            self._m_cse = m.counter("cse_planes_total")
            self._m_lat = m.histogram("modeled_latency_ns")
            self._m_wall = m.histogram("batch_wall_us")
            self._m_cse_s = m.counter("cse_pass_seconds_total")
            self._m_cse_nodes = m.counter("cse_subexprs_total")
            self._m_keys = m.counter("expr_keys_built_total")
            self._keys_built = compiler.expr_keys_built_total
            self._m_place_s = m.counter("place_seconds_total")
        if self._mitigated and self.cluster is not None:
            raise ValueError(
                "reliability injection modes run on the single-process VM "
                "path; distributed deployments recover at chip granularity "
                "(fault_tolerance=...), not per-TRA")

    # -- plumbing -----------------------------------------------------------

    @property
    def _n_blocks(self) -> int:
        """Row-blocks every operand spans (catalog domain / 8KB row)."""
        assert self.catalog.n_bits is not None
        return max(1, math.ceil(self.catalog.n_bits / ROW_BITS))

    def _xfer_ns(self, plan: Plan) -> float:
        # place each operand row in the bank + read each result row back
        # out, all serialized on the shared internal bus (inter-bank
        # RowClone); arithmetic plans move one row per operand/result plane
        return self.timing.aap_ns * (plan.n_inputs + len(plan.outputs))

    def _operand_words(self, name: str,
                       cse_planes: Optional[Dict[str, torch.Tensor]]
                       ) -> torch.Tensor:
        """A bound operand's packed words: catalog row or shared plane."""
        if cse_planes is not None and name.startswith(CSE_PREFIX):
            return cse_planes[name]
        return self.catalog.get(name).words

    @property
    def _vm_backend(self) -> str:
        """The VM a plan without a recorded backend runs: the kernel on a
        card, the plain loop on the CPU (the wrapper decides either way)."""
        return "cuda" if self.catalog.device.type == "cuda" else "torch"

    @property
    def _mitigated(self) -> bool:
        return self.reliability is not None \
            and self.reliability.mode != "none"

    # -- functional execution ------------------------------------------------

    def _run_group(self, members: List[Tuple[int, BoundPlan]],
                   need_words: bool,
                   cse_planes: Optional[Dict[str, torch.Tensor]] = None,
                   need_counts: bool = True
                   ) -> Tuple[Optional[torch.Tensor], List[int], int]:
        """One stacked VM dispatch for all queries sharing a plan.

        Each canonical input IN{i} becomes a per-query list of operand
        rows, which `lowering.vm_call` stacks once, straight into the
        kernel's ``(queries, rows, words)`` plane (one broadcast program,
        per-bank data); the plan's cached `LoweredProgram` runs as ONE VM
        launch. Returns (masked result words ``(len(members), n_outputs,
        n_words)`` on the device, or None when no member materializes;
        per-query scalars). The scalar is sum_j 2**j * popcount(output
        plane j), which for single-output boolean plans is exactly the
        popcount. For count-only groups just the ``(n_outputs,
        n_queries)`` counts cross to the host, where exact Python ints
        apply the 2**j weights. ``need_counts=False`` (shared planes,
        whose scalars nobody reads) skips the popcount and its host sync.
        Under a reliability mode a lowered plan runs as replicas
        (`_run_reliable`): they materialize, vote, then mask and count.
        The third value is the replicas run — 1 on the clean path, k under
        vote, 2 or 3 under ecc — the multiplier the modeled timeline
        charges. With a cluster the group runs sharded
        (`_run_group_sharded`).
        """
        if self.cluster is not None:
            words, scalars = self._run_group_sharded(members, need_words)
            return words, scalars, 1
        input_rows = [bp.input_map() for _, bp in members]
        data = {
            name: [self._operand_words(rows[name], cse_planes)
                   for rows in input_rows]
            for name in input_rows[0]
        }
        plan = members[0][1].plan
        backend = plan.backend or self._vm_backend
        mask = self.catalog.mask()
        replicas = 1
        if self._mitigated and plan.lowered is not None:
            out, replicas = self._run_reliable(plan, data)
        elif backend == "interp" or plan.lowered is None:
            # degenerate 1-2 command programs on the CPU: eager micro-op
            # interpreter, a VM run would cost more than the program
            data = {k: torch.stack(v) for k, v in data.items()}
            out = engine.execute(plan.program, data,
                                 outputs=list(plan.outputs),
                                 lowered=backend != "interp",
                                 backend=backend)
        elif not need_words:
            # count-only group: fused-reduction dispatch. The VM popcounts
            # each tail-masked output plane inside the kernel (the planes
            # never reach device memory)
            counts = lowering.execute_lowered(
                plan.lowered, data, outputs=list(plan.outputs),
                backend=backend, reduce="popcount", mask=mask)
            cnp = torch.stack([counts[o] for o in plan.outputs]).cpu().numpy()
            return None, _weighted(cnp, len(members)), 1
        else:
            out = lowering.execute_lowered(
                plan.lowered, data, outputs=list(plan.outputs),
                backend=backend)
        # (n_outputs, len(members), n_words), output planes LSB-first
        masked = torch.stack([out[o] & mask for o in plan.outputs])
        if not need_counts:
            return masked.movedim(0, 1), [], replicas
        counts = popcount_words(masked, axis=-1).cpu().numpy()
        scalars = _weighted(counts, len(members))
        return ((masked.movedim(0, 1) if need_words else None), scalars,
                replicas)

    def _run_reliable(self, plan: Plan, data: Dict[str, list]
                      ) -> Tuple[Dict[str, torch.Tensor], int]:
        """Mitigated dispatch: vote or ecc over the lowered program, on
        the same VM backend as a clean group.

        Each plan-group takes the next link of a deterministic key chain
        rooted at the config seed — ``(seed, group_seq)``, each replica
        appending its index — so a served batch reproduces the same fault
        pattern run-to-run on one device.
        """
        from repro_torch.core import errors as errmod

        rel = self.reliability
        key = (rel.seed, self._group_seq)
        self._group_seq += 1
        model = rel.model or errmod.TRAErrorModel(p_flip=0.0)
        tel = self.telemetry
        stats: Optional[Dict[str, int]] = {} if tel.metering else None
        if rel.mode == "vote":
            out = errmod.execute_voted(
                plan.lowered, data, list(plan.outputs),
                backend=self._vm_backend, model=model, key=key, k=rel.k,
                stats_out=stats)
            replicas = rel.k
        else:
            out, replicas = errmod.execute_ecc(
                plan.lowered, data, list(plan.outputs),
                backend=self._vm_backend, model=model, key=key,
                stats_out=stats)
        if stats is not None:
            m = tel.metrics
            m.counter("reliability_replicas_total").inc(stats["replicas"])
            m.counter("ecc_tiebreaks_total").inc(stats["tiebreaks"])
            m.counter("tra_corrected_bits_total").inc(
                stats["corrected_bits"])
            if tel.tracing and stats["corrected_bits"]:
                tel.tracer.instant("tra_correction",
                                   corrected_bits=stats["corrected_bits"],
                                   replicas=stats["replicas"])
        return out, replicas

    def _run_group_resilient(self, members: List[Tuple[int, BoundPlan]],
                             need_words: bool,
                             cse_planes: Optional[Dict[str, torch.Tensor]]
                             = None
                             ) -> Tuple[Optional[torch.Tensor], List[int],
                                        int]:
        """`_run_group` under the fault policy: timed, replayed, flagged.

        The chaos injector runs inside the guarded+timed window, so a
        raising injector is indistinguishable from a chip dying
        mid-dispatch and a sleeping one from a straggling chip. On failure
        the recovery hook runs first (elastic rescale-down when a
        QueryService owns this scheduler — `self.cluster` is re-read on
        replay, so the group re-lands on the surviving chips), then the
        whole group is re-dispatched; results are whatever the successful
        attempt produced, which the chaos suite asserts bit-identical to a
        never-failed run. The straggler clock reads the host: a dispatch
        returns once its launches are queued, and count groups wait for
        their counts.
        """
        ft = self.fault_tolerance
        tel = self.telemetry
        g = ft.groups_dispatched
        ft.groups_dispatched += 1
        for attempt in range(ft.max_replays + 1):
            t0 = time.perf_counter()
            try:
                if ft.failure_injector is not None:
                    ft.failure_injector(g)
                out = self._run_group(members, need_words, cse_planes)
            except Exception as e:  # noqa: BLE001 - any failure is replayable
                ft.failures += 1
                ft.timeline.append(f"failure@group{g}:{type(e).__name__}")
                if tel.metering:
                    tel.metrics.counter("ft_failures_total").inc()
                if tel.tracing:
                    tel.tracer.instant("ft_failure", group=g,
                                       error=type(e).__name__)
                if attempt >= ft.max_replays:
                    raise
                if ft.on_chip_failure is not None:
                    ft.on_chip_failure(e)
                ft.replays += 1
                ft.timeline.append(f"replay@group{g}")
                if tel.metering:
                    tel.metrics.counter("ft_replays_total").inc()
                if tel.tracing:
                    tel.tracer.instant("ft_replay", group=g)
                continue
            if ft.monitor.observe(g, time.perf_counter() - t0):
                ft.stragglers.append(g)
                ft.timeline.append(f"straggler@group{g}")
                if tel.metering:
                    tel.metrics.counter("ft_stragglers_total").inc()
                if tel.tracing:
                    tel.tracer.instant("ft_straggler", group=g)
            if tel.metering and ft.monitor.ema is not None:
                tel.metrics.gauge("straggler_ema_s").set(ft.monitor.ema)
            return out
        raise AssertionError("unreachable: loop exits via return or raise")

    def _run_group_sharded(self, members: List[Tuple[int, BoundPlan]],
                           need_words: bool
                           ) -> Tuple[Optional[torch.Tensor], List[int]]:
        """Distributed twin of `_run_group`: one VM launch per chip.

        Each canonical input stacks the group's queries along an inner
        axis of the catalog's per-chip shards, so chip i's rows are
        ``(local_banks, n_queries, local_words)`` on its device. Popcounts
        reduce with the chip-axis tree psum (`ChipCluster.popcounts`) —
        for scalar-only groups nothing but the count matrix leaves the
        shards; materialize gathers the output rows once per group to the
        first chip. The chips' devices pick the VM (the kernel on a card,
        the plain loop on the CPU); a plan's recorded "cuda" / "torch"
        choice is passed on, "interp" is not (the shards need the VM).
        """
        cluster = self.cluster
        input_rows = [bp.input_map() for _, bp in members]
        data = {
            name: [torch.stack([self.catalog.shards(rows[name])[i]
                                for rows in input_rows], dim=1)
                   for i in range(cluster.n_chips)]
            for name in input_rows[0]
        }
        plan = members[0][1].plan
        backend = plan.backend if plan.backend in lowering.BACKENDS \
            else None
        lp = plan.lowered
        if lp is None:      # plans built outside the cache lower here
            lp = lowering.lower(plan.program)
        if not need_words:
            # scalar-only group: only the count matrix crosses chips
            counts = cluster.popcounts(lp, data, plan.outputs,
                                       self.catalog.mask_shards(),
                                       backend=backend)
            return None, _weighted(counts, len(members))
        # materialize group: the output rows must be gathered anyway, so
        # run ONCE and derive the counts from the gathered masked planes
        # (exactly as the single-process twin does)
        out = cluster.run_lowered(lp, data, plan.outputs, backend=backend)
        n_words = self.catalog.get(
            next(iter(input_rows[0].values()))).words.shape[0]
        mask = self.catalog.mask()
        # (n_outputs, len(members), n_words), output planes LSB-first
        masked = torch.stack(
            [cluster.unshard_words(out[o], int(n_words))
             & mask.to(cluster.devices[0]) for o in plan.outputs])
        counts = popcount_words(masked, axis=-1).cpu().numpy()
        return masked.movedim(0, 1), _weighted(counts, len(members))

    # -- the scheduler proper ------------------------------------------------

    def plan_queries(self, queries: Sequence[Query]) -> List[BoundPlan]:
        """Host-side parse/plan/bind of a batch, no dispatch.

        The serving loop's double-buffered tick pipeline runs this for
        tick N+1 while tick N executes on device, then hands the bound
        plans back through ``submit(queries, preplanned=...)`` so the
        dispatch path skips planning entirely.
        """
        return [self.planner.plan(q.query, columns=self.catalog.columns,
                                  names=self.catalog)
                for q in queries]

    def submit(self, queries: Sequence[Query],
               preplanned: Optional[List[BoundPlan]] = None,
               allow_cse: bool = True) -> BatchReport:
        """Plan, group, execute, and cost one batch of concurrent queries.

        ``preplanned`` (from `plan_queries`) skips the planning stage —
        the serving loop plans tick N+1 on the host while tick N runs on
        device. ``allow_cse=False`` additionally skips the batch-level
        sharing pass: the CSE rewrite compiles ephemeral plans through
        the shared planner cache, which the pipelined loop is using from
        the other thread.
        """
        if not queries:
            return BatchReport([], 0.0, self.n_banks, 0)
        tel = self.telemetry
        live = tel.spans_on()
        if not (live or tel.metering):
            return self._submit(queries, tel, preplanned, allow_cse)
        wall0 = time.perf_counter()
        # core layers (engine, VM, Python's collector) have no handle on
        # this scheduler; publish the sink for the batch so their spans
        # nest under it and their counters land in its registry
        prev = set_telemetry(tel)
        try:
            if live:
                with tel.span("batch", n_queries=len(queries)):
                    report = self._submit(queries, tel, preplanned,
                                          allow_cse)
            else:
                report = self._submit(queries, tel, preplanned, allow_cse)
        finally:
            set_telemetry(prev)
        if tel.metering:
            self._m_batches.inc()
            self._m_groups.inc(report.n_plan_groups)
            self._m_modeled_ns.inc(report.makespan_ns)
            self._m_wall.observe((time.perf_counter() - wall0) * 1e6)
        return report

    def _submit(self, queries: Sequence[Query],
                tel: "Telemetry",  # noqa: F821
                preplanned: Optional[List[BoundPlan]] = None,
                allow_cse: bool = True) -> BatchReport:
        tracing = tel.tracing
        live = tel.spans_on()
        tr = tel.tracer
        if self.reliability is not None and self.reliability.mode == "ecc":
            # ecc mode opens every batch with a catalog integrity probe:
            # the maintained per-group XOR parity must match a fresh
            # recomputation, or some operand vector was corrupted at rest
            self.parity_checks += 1
            if tel.metering:
                self._m_parity.inc()
            if not self.catalog.verify_parity():
                raise RuntimeError(
                    "catalog parity check failed: a registered vector's "
                    "words no longer match the maintained XOR parity plane")

        # 1. plan every query through the cache (hits skip recompilation),
        #    then run the batch-level sharing pass (cross-query CSE)
        orig_bound: List[BoundPlan] = []
        if preplanned is not None:
            orig_bound = list(preplanned)
        elif live:
            for i, q in enumerate(queries):
                with tel.span("query", index=i, mode=q.mode):
                    orig_bound.append(self.planner.plan(
                        q.query, columns=self.catalog.columns,
                        names=self.catalog))
        else:
            orig_bound = self.plan_queries(queries)
        if allow_cse:
            t0 = time.perf_counter()
            with tel.span("cse_pass"):
                bound, cse = self._apply_cse(
                    queries, orig_bound,
                    self._m_cse_nodes if tel.metering else None)
            if tel.metering:
                self._m_cse_s.inc(time.perf_counter() - t0)
                # the process's key builds since the last publication
                built = compiler.expr_keys_built_total
                self._m_keys.inc(built - self._keys_built)
                self._keys_built = built
        else:
            bound, cse = orig_bound, None

        # 1b. shared-subexpression planes execute first (topo order), ONE
        #     dispatch each; consumers read them as input leaves below
        cse_planes: Dict[str, torch.Tensor] = {}
        if cse is not None:
            for d in cse.defs:
                if live:
                    tel.begin("cse_group", plane=d.name, uses=d.uses,
                              n_aaps=d.bound.plan.n_aaps)
                    tel.begin("cse_dispatch")
                stacked, _, _ = self._run_group([(0, d.bound)], True,
                                                cse_planes,
                                                need_counts=False)
                cse_planes[d.name] = stacked[0, 0]   # stays on the device
                if live:
                    tel.end()    # cse_dispatch
                    tel.end()    # cse_group
            self.cse_planes_built += len(cse.defs)
            if tel.metering:
                self._m_cse.inc(len(cse.defs))

        # 2. group by canonical plan -> one stacked dispatch per group
        groups: Dict[Tuple, List[Tuple[int, BoundPlan]]] = {}
        for idx, bp in enumerate(bound):
            groups.setdefault(bp.plan.key, []).append((idx, bp))
        words_by_idx: Dict[int, np.ndarray] = {}
        count_by_idx: Dict[int, int] = {}
        replicas_by_idx: Dict[int, int] = {}
        dispatch = (self._run_group_resilient
                    if self.fault_tolerance is not None else self._run_group)
        for members in groups.values():
            need_words = any(queries[idx].mode == MATERIALIZE
                             for idx, _ in members)
            if live:
                tel.begin("group", members=[idx for idx, _ in members],
                          n_aaps=members[0][1].plan.n_aaps)
                tel.begin("dispatch")
            stacked, scalars, replicas = dispatch(members, need_words,
                                                  cse_planes)
            if live:
                tel.end()
                tel.begin("readout")
            plan = members[0][1].plan
            # boolean plans (single DST row) materialize as a flat word
            # vector; arithmetic plans as the (n_outputs, n_words) plane
            # stack — even at width 1, so plane shapes stay stable
            is_boolean = plan.outputs == (DST,)
            host = to_uint32(stacked) if stacked is not None else None
            for slot, (idx, _) in enumerate(members):
                if host is not None:
                    w = host[slot]             # (n_outputs, n_words)
                    words_by_idx[idx] = w[0] if is_boolean else w
                count_by_idx[idx] = scalars[slot]
                replicas_by_idx[idx] = replicas
            if live:
                tel.end()    # readout
                tel.end()    # group

        # 3. modeled timeline (`_place_batch`): shared planes first, then
        #    queries on least-loaded (chip, bank) slots; a consumer cannot
        #    start before the planes it reads are ready, and shared work
        #    is placed — charged — exactly once.
        n_chips = self.cluster.n_chips if self.cluster is not None else 1
        n_blocks = self._n_blocks
        t0 = time.perf_counter()
        with tel.span("place"):
            placements, makespan = self._place_batch(
                bound, cse, replicas_by_idx, tr if tracing else None)
        if tel.metering:
            self._m_place_s.inc(time.perf_counter() - t0)
        # defs are real AAPs/energy, but shared: charge them once, to the
        # first consuming query's accounting, so the batch energy total
        # stays the sum of per-result energies
        def_aaps = (sum(d.bound.plan.n_aaps for d in cse.defs)
                    if cse is not None else 0)
        def_energy = (sum(d.bound.plan.energy_nj_per_block
                          for d in cse.defs) * n_blocks
                      if cse is not None else 0.0)
        first_consumer: Optional[int] = None
        if cse is not None:
            for idx, bp in enumerate(bound):
                if any(n.startswith(CSE_PREFIX) for n in bp.bindings):
                    first_consumer = idx
                    break
        results: List[QueryResult] = []
        for idx, (q, bp) in enumerate(zip(queries, bound)):
            c, b, lat = placements[idx]
            replicas = replicas_by_idx.get(idx, 1)
            energy = bp.plan.energy_nj_per_block * n_blocks * replicas
            extra_aaps = 0
            if idx == first_consumer:
                energy += def_energy
                extra_aaps = def_aaps
            value: Union[int, np.ndarray]
            if q.mode == MATERIALIZE:
                value = words_by_idx[idx]
            else:   # popcount / aggregate: the weighted-popcount scalar
                value = count_by_idx[idx]
            results.append(QueryResult(
                index=idx, mode=q.mode, value=value,
                latency_ns=lat, bank=b,
                cache_hit=orig_bound[idx].cache_hit,
                n_aaps=bp.plan.n_aaps,
                energy_nj=energy, tenant=q.tenant, chip=c,
                scalar=count_by_idx[idx]))
            # the legacy total accumulates per query, in the same order
            # as the registry counter, so the two agree to the last bit
            self.total_energy_nj += energy
            if tracing:
                tr.model_event(f"q{idx}", 0.0, lat, "queries",
                               latency_ns=lat, n_aaps=bp.plan.n_aaps,
                               cache_hit=orig_bound[idx].cache_hit,
                               energy_nj=energy,
                               mode=q.mode, tenant=q.tenant)
            if tel.metering:
                self._m_queries.inc()
                self._m_lat.observe(lat)
                self._m_aaps.inc((bp.plan.n_aaps + extra_aaps)
                                 * n_blocks * replicas)
                self._m_energy.inc(energy)
                if q.tenant is not None:
                    m = tel.metrics
                    m.counter("tenant_queries_total",
                              tenant=q.tenant).inc()
                    m.counter("tenant_aaps_total", tenant=q.tenant).inc(
                        bp.plan.n_aaps * n_blocks * replicas)
                    m.counter("tenant_energy_nj_total",
                              tenant=q.tenant).inc(energy)

        if tracing and n_chips > 1:
            # the chip-axis tree psum: ceil(log2 chips) serialized hops
            # after the last bank completes (recursive doubling,
            # `core.cluster.tree_psum`)
            hops = int(math.ceil(math.log2(n_chips)))
            base = makespan - hops * self.timing.aap_ns
            for h in range(hops):
                tr.model_event("psum_hop", base + h * self.timing.aap_ns,
                               self.timing.aap_ns, "reduce", hop=h)
        self.queries_served += len(queries)
        self.total_modeled_ns += makespan
        return BatchReport(
            results, makespan, self.n_banks, len(groups), n_chips=n_chips,
            n_cse_planes=(len(cse.defs) if cse is not None else 0),
            total_aaps=n_blocks * (def_aaps
                                   + sum(bp.plan.n_aaps for bp in bound)),
            baseline_aaps=n_blocks * sum(
                (bp.plan.n_aaps_unopt if bp.plan.n_aaps_unopt is not None
                 else bp.plan.n_aaps) for bp in orig_bound))

    # -- optimize: batch-level sharing + modeled placement -------------------

    def _apply_cse(self, queries: Sequence[Query],
                   orig_bound: List[BoundPlan], subexprs=None
                   ) -> Tuple[List[BoundPlan], Optional[CseBatch]]:
        """The cross-query sharing pass, where this deployment allows it
        (`subexprs`: `plan_group_cse`'s counter of the sub-DAGs counted).

        Single-process clean path only: sharded dispatch would have to
        ship planes between chips, mitigated dispatch repeats programs
        whole (a shared plane would be voted once but consumed k times),
        and the fault-tolerance chaos suite counts group dispatches. The
        pass itself guarantees the rewrite is kept only when it strictly
        lowers the batch's total AAPs (`optimizer.plan_group_cse`).
        """
        opt = getattr(self.planner.cache, "optimizer", None)
        if (opt is None or not opt.enable_cse or len(queries) < 2
                or self.cluster is not None
                or self.fault_tolerance is not None
                or self._mitigated):
            return orig_bound, None
        exprs = [
            (bind_expr(bp.plan.canon, bp.input_map())
             if bp.plan.canon is not None and bp.plan.outputs == (DST,)
             else None)
            for bp in orig_bound
        ]
        cse = plan_group_cse(orig_bound, exprs,
                             lambda e: self.planner._plan(e, None), subexprs)
        if cse is None:
            return orig_bound, None
        return cse.bound, cse

    def _place_batch(self, bound: Sequence[BoundPlan],
                     cse: Optional[CseBatch],
                     replicas_by_idx: Dict[int, int], tr=None
                     ) -> Tuple[List[Tuple[int, int, float]], float]:
        """Modeled timeline placement for one batch (no execution).

        Shared-plane defs place first (dependency-ordered), then every
        query lands on the least-loaded (chip, bank); operand transfers
        serialize on each chip's own internal bus, per-bank AAP compute
        overlaps across banks, chips are fully parallel, and a consumer
        cannot start a block before every shared plane it reads is ready.
        A k-replica dispatch repeats the in-bank AAP compute k times
        (operands are already placed, so transfers are not repeated) and
        a voted readout adds one AAP per output plane. Multi-chip readout
        adds the psum reduction tree (ceil(log2 chips) serialized hops);
        with one chip this is exactly the single-process model.
        Returns (per-query [(chip, bank, latency_ns)], makespan_ns).
        """
        n_chips = self.cluster.n_chips if self.cluster is not None else 1
        reduce_ns = (math.ceil(math.log2(n_chips)) * self.timing.aap_ns
                     if n_chips > 1 else 0.0)
        n_blocks = self._n_blocks
        bus_free = [0.0] * n_chips
        bank_free = [[0.0] * self.n_banks for _ in range(n_chips)]
        cse_ready: Dict[str, float] = {}

        def least_loaded() -> Tuple[int, int]:
            return min(((ci, bi) for ci in range(n_chips)
                        for bi in range(self.n_banks)),
                       key=lambda cb: bank_free[cb[0]][cb[1]])

        for d in (cse.defs if cse is not None else ()):
            plan = d.bound.plan
            deps = [n for n in d.bound.bindings if n.startswith(CSE_PREFIX)]
            c, b = least_loaded()
            xfer = self._xfer_ns(plan)
            for _ in range(n_blocks):
                dep = max((cse_ready[p] for p in deps), default=0.0)
                start = max(bus_free[c], bank_free[c][b], dep)
                bus_free[c] = start + xfer
                bank_free[c][b] = bus_free[c] + plan.latency_ns_per_block
                if tr is not None:
                    tr.model_event("cse_xfer", start, xfer, f"chip{c}/bus",
                                   plane=d.name)
                    tr.model_event("cse_compute", bus_free[c],
                                   plan.latency_ns_per_block,
                                   f"chip{c}/bank{b}", plane=d.name)
            cse_ready[d.name] = bank_free[c][b]

        placements: List[Tuple[int, int, float]] = []
        for idx, bp in enumerate(bound):
            deps = [n for n in bp.bindings if n.startswith(CSE_PREFIX)]
            c, b = least_loaded()
            xfer = self._xfer_ns(bp.plan)
            replicas = replicas_by_idx.get(idx, 1)
            vote_ns = (len(bp.plan.outputs) * self.timing.aap_ns
                       if replicas > 1 else 0.0)
            for _ in range(n_blocks):
                dep = max((cse_ready[p] for p in deps), default=0.0)
                start = max(bus_free[c], bank_free[c][b], dep)
                bus_free[c] = start + xfer
                bank_free[c][b] = (bus_free[c]
                                   + bp.plan.latency_ns_per_block * replicas
                                   + vote_ns)
                if tr is not None:
                    tr.model_event("xfer", start, xfer, f"chip{c}/bus",
                                   q=idx)
                    tr.model_event("compute", bus_free[c],
                                   bank_free[c][b] - bus_free[c],
                                   f"chip{c}/bank{b}", q=idx)
            placements.append((c, b, bank_free[c][b] + reduce_ns))
        makespan = max(max(per_chip) for per_chip in bank_free) + reduce_ns
        return placements, makespan

    def explain(self, queries: Sequence[Union[Query, str]]) -> ExplainReport:
        """Plan — but do not execute — a batch; report every decision.

        Runs the full `parse -> canonicalize -> optimize -> cost -> bind`
        pipeline plus the batch sharing pass and the modeled placement,
        and returns the per-plan cost/backend breakdown and the
        shared-subexpression report. Plans land in the cache (a later
        `submit` of the same batch hits), but nothing is dispatched and
        no serving counters move.
        """
        qs = [q if isinstance(q, Query) else Query(q) for q in queries]
        orig_bound = self.plan_queries(qs)
        bound, cse = self._apply_cse(qs, orig_bound)
        placements, makespan = self._place_batch(bound, cse, {})
        n_blocks = self._n_blocks
        plans: List[PlanExplain] = []
        for idx, (q, bp0, bp) in enumerate(zip(qs, orig_bound, bound)):
            plans.append(PlanExplain(
                index=idx, query=str(q.query),
                backend=bp.plan.backend or self._vm_backend,
                cache_hit=bp0.cache_hit,
                n_aaps=bp.plan.n_aaps,
                n_aaps_unopt=(bp0.plan.n_aaps_unopt
                              if bp0.plan.n_aaps_unopt is not None
                              else bp0.plan.n_aaps),
                latency_ns=bp.plan.latency_ns_per_block,
                energy_nj=bp.plan.energy_nj_per_block,
                xfer_ns=self._xfer_ns(bp.plan),
                n_inputs=bp.plan.n_inputs,
                shared=tuple(sorted({n for n in bp.bindings
                                     if n.startswith(CSE_PREFIX)})),
                rewritten=bp is not bp0))
        cse_rows = [CseExplain(name=d.name, n_aaps=d.bound.plan.n_aaps,
                               uses=d.uses)
                    for d in (cse.defs if cse is not None else ())]
        def_aaps = sum(r.n_aaps for r in cse_rows)
        return ExplainReport(
            plans=plans, cse=cse_rows,
            n_plan_groups=len({bp.plan.key for bp in bound}),
            total_aaps=n_blocks * (def_aaps
                                   + sum(bp.plan.n_aaps for bp in bound)),
            baseline_aaps=n_blocks * sum(
                (bp.plan.n_aaps_unopt if bp.plan.n_aaps_unopt is not None
                 else bp.plan.n_aaps) for bp in orig_bound),
            makespan_ns=makespan, n_banks=self.n_banks,
            n_chips=(self.cluster.n_chips
                     if self.cluster is not None else 1))


def results_bit_identical(a: Sequence[QueryResult],
                          b: Sequence[QueryResult]) -> bool:
    """Mode-aware value equality across two result lists.

    Popcount values are ints, materialize values are packed word arrays;
    `np.array_equal` handles both.
    """
    if len(a) != len(b):
        return False
    return all(np.array_equal(np.asarray(x.value), np.asarray(y.value))
               for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Reference path: sequential, unbatched, uncached
# ---------------------------------------------------------------------------


def run_queries_unbatched(catalog: Catalog, queries: Sequence[Query],
                          timing: DramTiming = DDR3_1600) -> BatchReport:
    """Execute queries one at a time with fresh per-query compilation.

    This is the service's ground truth: no canonical renaming, no plan
    cache, no stacking, no lowered VM and no kernel — each query compiles
    over its natural catalog row names (arithmetic forms over the
    library's natural X/Y plane names) and runs through the micro-op
    interpreter (`engine.execute(lowered=False)`) alone on a single bank,
    on the catalog's device. The batched scheduler's VM dispatch must
    produce bit-identical values.
    """
    from repro_torch.core.energy import DEFAULT_ENERGY, program_energy_nj
    from repro_torch.core.timing import program_latency_ns

    def expr_leaves(e: Expr, acc: List[str]) -> List[str]:
        if e.op == "row":
            if e.row not in acc:
                acc.append(e.row)
        else:
            for a in e.args:
                expr_leaves(a, acc)
        return acc

    n_blocks = max(1, math.ceil((catalog.n_bits or ROW_BITS) / ROW_BITS))
    mask = catalog.mask()
    clock = 0.0
    results: List[QueryResult] = []
    for idx, q in enumerate(queries):
        parsed = (parse_any(q.query, catalog.columns, catalog)
                  if isinstance(q.query, str) else q.query)
        if isinstance(parsed, ArithQuery):
            n_bits = catalog.columns[parsed.cols[0]]
            if parsed.op == "read":
                res = arith_compiler.plane_readout_program(n_bits, "X", "S")
                data = {f"X{j}": catalog.get(plane_name(parsed.cols[0],
                                                        j)).words
                        for j in range(n_bits)}
            else:
                res = arith_compiler.ripple_add_program(
                    n_bits, "X", "Y", "S", sub=(parsed.op == "sub"))
                data = {f"X{j}": catalog.get(plane_name(parsed.cols[0],
                                                        j)).words
                        for j in range(n_bits)}
                data.update({f"Y{j}": catalog.get(plane_name(parsed.cols[1],
                                                             j)).words
                             for j in range(n_bits)})
            program, outputs = res.program, res.outputs
            # lowered=False: the reference path runs the micro-op
            # interpreter so batched-VM bit-identity is checked against an
            # independent executor, not the VM against itself
            out = engine.execute(program, data, outputs=outputs,
                                 lowered=False)
            planes = torch.stack([out[o] & mask for o in outputs])
            counts = popcount_words(planes, axis=-1).tolist()
            scalar = sum(int(c) << j for j, c in enumerate(counts))
            n_leaves = len(data)
            value = to_uint32(planes) if q.mode == MATERIALIZE else scalar
        else:
            compiled = compile_expr_fused(parsed, DST)
            program, outputs = compiled.program, [DST]
            leaves = expr_leaves(parsed, [])
            out = engine.execute(program, catalog.row_state(leaves),
                                 outputs=[DST], lowered=False)[DST]
            words = out & mask
            n_leaves = len(leaves)
            scalar = int(popcount_words(words))
            value = to_uint32(words) if q.mode == MATERIALIZE else scalar
        exec_ns = program_latency_ns(program, timing)
        xfer = timing.aap_ns * (n_leaves + len(outputs))
        clock += n_blocks * (xfer + exec_ns)
        results.append(QueryResult(
            index=idx, mode=q.mode, value=value, latency_ns=clock, bank=0,
            cache_hit=False, n_aaps=program.n_aap,
            energy_nj=n_blocks * program_energy_nj(program, DEFAULT_ENERGY),
            tenant=q.tenant, scalar=scalar))
    return BatchReport(results, clock, 1, len(queries))
