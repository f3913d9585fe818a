"""Bulk-bitwise query-serving driver: replay a multi-tenant stream (the
counterpart of `repro.launch.serve_bitwise`, with the same flags plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve_bitwise \
        --tenants 4 --weeks 3 --queries 96 --banks 8
    PYTHONPATH=src python -m repro_torch.launch.serve_bitwise --device cpu

Runs on the card (``--device cuda``, the default) unless asked for the
CPU. Builds the synthetic §8 workload catalog (`service.workload`), serves
the query stream through the batching scheduler, and prints per-batch QPS,
p50/p99 modeled latency, plan-cache hit rate, and energy — the interactive
serving loop the ROADMAP's "heavy traffic" north star grows from.

``--explain`` prints the cost-based optimizer's plan report for the first
batch: per-plan AAP counts (optimized vs as-written), chosen backend, and
the cross-query shared subexpression planes.

``--serve-loop`` switches from closed-loop batch replay to the
continuous-serving runtime: a seeded open-loop Poisson trace
(`poisson_arrivals`) replayed through `ServingLoop` with slot-packing
ticks, double-buffered plan/execute pipelining, and SLO admission
control (``--rate`` offered QPS, ``--slo-p99-us`` target,
``--slo-policy shed|defer|none``). The dashboard streams per-tick
occupancy / queue depth / shed lines while the trace runs.

Telemetry (`repro_torch.obs`): ``--telemetry`` turns on full query-lifecycle
tracing and prints the metrics dashboard after the stream; ``--trace-out
trace.json`` writes the Chrome trace-event timeline (open in Perfetto /
`chrome://tracing`), ``--prom-out metrics.prom`` the Prometheus snapshot.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.obs import Telemetry
from repro_torch.service import (ServiceConfig, SloConfig, WorkloadSpec,
                           build_service, poisson_arrivals, query_stream,
                           results_bit_identical, run_queries_unbatched)


def _dashboard(svc) -> str:
    """Human-readable telemetry summary from the unified stat surface."""
    s = svc.stats()
    lines = [
        "-- telemetry ----------------------------------------------",
        f"queries served      {int(s['queries_served'])} "
        f"in {int(s.get('batches', 0))} batches",
        f"plan cache          {int(s['plan_cache_hits'])} hits / "
        f"{int(s['plan_cache_misses'])} misses "
        f"(rate {s['plan_cache_hit_rate']:.2f}, "
        f"{int(s['plans_cached'])} plans)",
        f"modeled latency     p50 {s.get('modeled_latency_p50_ns', 0.0) / 1e3:.1f}us  "
        f"p99 {s.get('modeled_latency_p99_ns', 0.0) / 1e3:.1f}us",
        f"modeled totals      {s['total_modeled_ns'] / 1e6:.3f} ms, "
        f"{s['total_energy_nj'] / 1e3:.1f} uJ",
        f"reliability         {int(s.get('reliability_replicas', 0))} replicas, "
        f"{int(s.get('ecc_tiebreaks', 0))} tiebreaks, "
        f"{int(s.get('tra_corrected_bits', 0))} corrected bits, "
        f"{int(s['parity_checks'])} parity checks",
        f"fault tolerance     {int(s['failures'])} failures, "
        f"{int(s['replays'])} replays, {int(s['stragglers'])} stragglers, "
        f"{int(s.get('chip_rescales', 0))} rescales",
    ]
    return "\n".join(lines)


def _serve_dashboard(rep) -> str:
    """Post-run summary of a ServingLoop trace replay."""
    lines = [
        "-- serving loop -------------------------------------------",
        f"served {len(rep.served)} / shed {len(rep.shed)} "
        f"(shed_frac {rep.shed_frac:.2f}, "
        f"deferred {rep.deferred_total})",
        f"ticks {len(rep.ticks)}  "
        f"occupancy mean {rep.occupancy_mean:.2f}  "
        f"capacity {rep.capacity}  "
        f"pipelined {rep.pipelined}",
        f"sustained {rep.sustained_qps:.0f} modeled qps "
        f"({rep.wall_qps:.0f} wall qps)",
        f"sojourn p50 {rep.sojourn_percentile_ns(50) / 1e3:.1f}us  "
        f"p99 {rep.sojourn_percentile_ns(99) / 1e3:.1f}us",
    ]
    if rep.slo is not None:
        p99 = rep.sojourn_percentile_ns(99)
        ok = "OK" if p99 <= rep.slo.p99_ns else "BREACH"
        lines.append(f"slo p99 target {rep.slo.p99_ns / 1e3:.1f}us "
                     f"policy={rep.slo.policy} -> {ok}")
    return "\n".join(lines)


def _run_serve_loop(args, svc, spec) -> int:
    slo = None
    if args.slo_policy != "off":
        slo = SloConfig(p99_ns=args.slo_p99_us * 1e3,
                        policy=args.slo_policy)
    arrivals = poisson_arrivals(spec, svc, rate_qps=args.rate,
                                n_arrivals=args.queries)
    print(f"open-loop trace: {len(arrivals)} arrivals at "
          f"{args.rate:.0f} offered qps "
          f"({len({a.query.tenant for a in arrivals})} tenants)")

    def tick_line(t):
        print(f"  tick {t.tick:3d}: {t.n_queries:3d} queries "
              f"in {t.n_groups} groups  "
              f"occ {t.occupancy:.2f}  depth {t.queue_depth:3d}  "
              f"makespan {t.makespan_ns / 1e3:.1f}us")

    loop = svc.serve_loop(depth=args.depth, slo=slo,
                          on_tick=tick_line if args.tick_log else None)
    rep = loop.run_trace(arrivals)
    print(_serve_dashboard(rep))
    if args.verify:
        served = [r for r in rep.records if r.status == "served"]
        ref = run_queries_unbatched(svc.catalog,
                                    [arrivals[r.index].query
                                     for r in served])
        ok = results_bit_identical([r.result for r in served], ref.results)
        print(f"  verify: bit-identical={ok}")
        if not ok:
            return 1
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--weeks", type=int, default=3)
    ap.add_argument("--domain", type=int, default=1 << 12,
                    help="bit domain (users / column length)")
    ap.add_argument("--queries", type=int, default=96)
    ap.add_argument("--banks", type=int, default=8)
    ap.add_argument("--batches", type=int, default=3,
                    help="replay the stream this many times (cache warm-up "
                         "shows up as rising hit rate)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the catalog and every plane live "
                         "on ('cuda' or 'cpu')")
    ap.add_argument("--verify", action="store_true",
                    help="also run the sequential unbatched reference and "
                         "assert bit-identical results")
    ap.add_argument("--explain", action="store_true",
                    help="print the optimizer's per-plan cost breakdown "
                         "(backend choice, AAPs vs unoptimized, shared "
                         "CSE planes) for the first batch")
    ap.add_argument("--telemetry", action="store_true",
                    help="full tracing + metrics dashboard")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the Chrome trace-event JSON here "
                         "(implies --telemetry)")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the Prometheus metrics snapshot here")
    ap.add_argument("--serve-loop", action="store_true",
                    help="continuous-serving mode: replay a seeded "
                         "open-loop Poisson trace through ServingLoop "
                         "(slot-packing ticks, pipelined dispatch, SLO "
                         "admission control)")
    ap.add_argument("--rate", type=float, default=200_000.0,
                    help="serve-loop offered load, modeled queries/sec")
    ap.add_argument("--depth", type=int, default=4,
                    help="serve-loop queue depth per slot "
                         "(tick capacity = slots * depth)")
    ap.add_argument("--slo-p99-us", type=float, default=5e3,
                    help="serve-loop p99 sojourn target, microseconds")
    ap.add_argument("--slo-policy", default="shed",
                    choices=["shed", "defer", "none", "off"],
                    help="admission policy on projected SLO breach "
                         "('off' disables the SLO entirely)")
    ap.add_argument("--tick-log", action="store_true",
                    help="stream a dashboard line per serving tick")
    args = ap.parse_args(argv)

    trace_on = args.telemetry or args.trace_out is not None
    tel = Telemetry(trace=trace_on) if trace_on else None

    spec = WorkloadSpec(n_tenants=args.tenants, n_weeks=args.weeks,
                        domain_bits=args.domain, n_queries=args.queries,
                        seed=args.seed)
    svc = build_service(spec, n_banks=args.banks, telemetry=tel,
                        device=args.device)
    print(f"catalog: {len(svc.catalog)} vectors, "
          f"domain={svc.catalog.n_bits} bits, banks={args.banks}, "
          f"device={svc.device}")

    if args.serve_loop:
        rc = _run_serve_loop(args, svc, spec)
        if trace_on:
            print(_dashboard(svc))
        if args.trace_out:
            path = svc.export_chrome_trace(args.trace_out)
            n_ev = len(svc.telemetry.tracer.events)
            print(f"chrome trace: {n_ev} events -> {path}")
        if args.prom_out:
            with open(args.prom_out, "w") as f:
                f.write(svc.prometheus())
            print(f"prometheus snapshot -> {args.prom_out}")
        return rc

    for batch in range(args.batches):
        queries = query_stream(
            dataclasses.replace(spec, seed=spec.seed + batch), svc)
        if args.explain and batch == 0:
            print(svc.explain(queries))
        t0 = time.perf_counter()
        rep = svc.query_batch(queries)
        wall = time.perf_counter() - t0
        stats = svc.stats()
        print(f"batch {batch}: {len(queries)} queries in "
              f"{rep.makespan_ns / 1e6:.3f} modeled ms "
              f"(wall {wall * 1e3:.0f} ms) "
              f"qps={rep.qps:.0f} "
              f"p50={rep.latency_percentile_ns(50) / 1e3:.1f}us "
              f"p99={rep.latency_percentile_ns(99) / 1e3:.1f}us "
              f"hit_rate={stats['plan_cache_hit_rate']:.2f} "
              f"plans={int(stats['plans_cached'])} "
              f"energy={stats['total_energy_nj'] / 1e3:.1f}uJ")
        if args.verify:
            ref = run_queries_unbatched(svc.catalog, queries)
            ok = results_bit_identical(rep.results, ref.results)
            print(f"  verify: bit-identical={ok} "
                  f"serial_ms={ref.makespan_ns / 1e6:.3f} "
                  f"speedup={ref.makespan_ns / rep.makespan_ns:.1f}x")
            if not ok:
                return 1

    if trace_on:
        print(_dashboard(svc))
    if args.trace_out:
        path = svc.export_chrome_trace(args.trace_out)
        n_ev = len(svc.telemetry.tracer.events)
        print(f"chrome trace: {n_ev} events -> {path}")
    if args.prom_out:
        with open(args.prom_out, "w") as f:
            f.write(svc.prometheus())
        print(f"prometheus snapshot -> {args.prom_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
