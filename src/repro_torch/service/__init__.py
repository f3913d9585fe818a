"""Bulk-bitwise query service: catalog, cost-based planner, scheduler.

The serving layer above the paper's in-DRAM machine, ported from the JAX
package's `repro.service`: the catalog and every plane live on one torch
device ("cuda" by default). Sub-modules:

  catalog    — named bitvectors placed into subarray rows (DramAllocator)
  planner    — the `parse -> canonicalize -> optimize -> cost -> bind`
               front half: query text -> Expr -> fused AAP program,
               memoized in a bounded LRU cache keyed by the structural
               `expr_key` of the winning canonical DAG
  optimizer  — the cost model (AAPs x timing x energy) driving predicate
               reordering, per-plan backend choice, cross-query CSE, and
               the `explain()` report
  scheduler  — batches concurrent queries, runs the batch sharing pass,
               groups by shared plan into stacked bank-group dispatches,
               models latency/energy (shared work charged once)
  service    — the `QueryService` facade (register / submit / query /
               materialize / range_scan / explain), configured by
               `ServiceConfig` (TRA reliability modes, the chip
               cluster with elastic `rescale`, fault tolerance and
               checkpointed `serve_stream`)
  server     — the continuous-serving runtime: `ServingLoop` packs
               in-flight queries into scheduler ticks (double-buffered
               plan/execute pipelining, DRR tenant fairness, SLO
               admission control per `SloConfig`)
  config     — `ServiceConfig` / `SloConfig` construction + policy knobs
  workload   — synthetic multi-tenant §8 query streams (bitmap analytics,
               BitWeaving scans, set algebra) for benchmarks and serving;
               closed-loop batches plus seeded open-loop Poisson traces
"""
from repro_torch.service.catalog import (Catalog, CatalogEntry,
                                         CatalogError, plane_name)
from repro_torch.service.config import (DEFER, OBSERVE, SHED,
                                        ServiceConfig, SloConfig)
from repro_torch.service.optimizer import (CostParams, CseBatch, CseExplain,
                                           ExplainReport, PlanCost,
                                           PlanExplain, QueryOptimizer,
                                           choose_backend, cost_program,
                                           plan_group_cse, reorder_expr)
from repro_torch.service.planner import (ArithQuery, BoundPlan, Plan,
                                         PlanCache, Planner, QueryParseError,
                                         canonicalize, parse_any,
                                         parse_query)
from repro_torch.service.scheduler import (AGGREGATE, MATERIALIZE, POPCOUNT,
                                           BatchReport, Query, QueryResult,
                                           Scheduler, results_bit_identical,
                                           run_queries_unbatched)
from repro_torch.service.server import (Arrival, QueryHandle,
                                        QueryShedError, ServeRecord,
                                        ServeReport, ServingLoop, TickStats)
from repro_torch.service.service import QueryService
from repro_torch.service.workload import (WorkloadSpec, build_service,
                                          poisson_arrivals, query_stream)

__all__ = [
    "Catalog", "CatalogEntry", "CatalogError", "plane_name",
    "DEFER", "OBSERVE", "SHED", "ServiceConfig", "SloConfig",
    "Arrival", "QueryHandle", "QueryShedError", "ServeRecord",
    "ServeReport", "ServingLoop", "TickStats",
    "CostParams", "CseBatch", "CseExplain", "ExplainReport", "PlanCost",
    "PlanExplain", "QueryOptimizer", "choose_backend", "cost_program",
    "plan_group_cse", "reorder_expr",
    "ArithQuery", "BoundPlan", "Plan", "PlanCache", "Planner",
    "QueryParseError", "canonicalize", "parse_any", "parse_query",
    "AGGREGATE", "MATERIALIZE", "POPCOUNT", "BatchReport", "Query",
    "QueryResult", "Scheduler", "results_bit_identical",
    "run_queries_unbatched",
    "QueryService",
    "WorkloadSpec", "build_service", "poisson_arrivals", "query_stream",
]
