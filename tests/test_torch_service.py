"""Port parity: the query service end to end on the CPU.

`build_service(WorkloadSpec())` + `query_stream` served by both packages:
scalars, materialized words, plan-cache counters, plan groups, shared
planes, AAP totals and modeled latencies are identical; modeled energy
agrees within 1e-12 relative (the reference's own two energy bookkeeping
paths differ in the last ulp). Also `explain()`, the serving loop's trace
replay, the port's unbatched oracle, and its stats registry."""
import gc

import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

import repro.service as R
import repro_torch.service as T
from repro.apps.bitmap_index import week_or
from repro.obs import NULL_TELEMETRY as R_NULL
from repro.obs import Telemetry as RTelemetry
from repro_torch.convert import catalog_from_reference
from repro_torch.kernels import LAUNCHES
from repro_torch.obs import NULL_TELEMETRY as T_NULL
from repro_torch.obs import Telemetry as TTelemetry
from repro_torch.obs.trace import validate_chrome_trace

SPEC = dict(n_tenants=4, n_weeks=3, domain_bits=1 << 12, n_queries=96)
REL = 1e-12


def _services(**kw):
    r = R.build_service(R.WorkloadSpec(**SPEC), **kw)
    t = T.build_service(T.WorkloadSpec(**SPEC), device="cpu", **kw)
    return r, t


def _materialize_queries(pkg, svc):
    return [pkg.Query(week_or(1, prefix="t1/"), pkg.MATERIALIZE, "t1"),
            pkg.Query("t2/col + t2/col2", pkg.MATERIALIZE, "t2"),
            pkg.Query(svc.range_scan_query("t3/col", 10, 200),
                      pkg.MATERIALIZE, "t3"),
            pkg.Query("t0/s1 & ~t0/s2", pkg.MATERIALIZE, "t0"),
            pkg.Query("sum(t0/col - t0/col2)", pkg.AGGREGATE, "t0"),
            pkg.Query("t0/col < 77 & t0/male", pkg.POPCOUNT, "t0")]


def _assert_results_equal(rr, tr):
    assert len(rr) == len(tr)
    for a, b in zip(rr, tr):
        assert (b.index, b.mode, b.scalar, b.bank, b.cache_hit, b.n_aaps,
                b.tenant) == (a.index, a.mode, a.scalar, a.bank,
                              a.cache_hit, a.n_aaps, a.tenant)
        assert b.latency_ns == a.latency_ns
        assert b.energy_nj == pytest.approx(a.energy_nj, rel=REL)
        va, vb = np.asarray(a.value), np.asarray(b.value)
        assert vb.dtype == va.dtype and np.array_equal(va, vb)


@pytest.fixture(scope="module")
def served():
    """Both packages serving the same §8 stream once (plus a batch of
    materialize / arithmetic queries)."""
    rsvc, tsvc = _services()
    rrep = rsvc.query_batch(R.query_stream(R.WorkloadSpec(**SPEC), rsvc))
    trep = tsvc.query_batch(T.query_stream(T.WorkloadSpec(**SPEC), tsvc))
    rmat = rsvc.query_batch(_materialize_queries(R, rsvc))
    tmat = tsvc.query_batch(_materialize_queries(T, tsvc))
    return rsvc, tsvc, (rrep, rmat), (trep, tmat)


def test_stream_results_identical(served):
    rsvc, tsvc, rreps, treps = served
    for rrep, trep in zip(rreps, treps):
        _assert_results_equal(rrep.results, trep.results)
        assert (trep.makespan_ns, trep.n_plan_groups, trep.n_cse_planes,
                trep.total_aaps, trep.baseline_aaps) == \
            (rrep.makespan_ns, rrep.n_plan_groups, rrep.n_cse_planes,
             rrep.total_aaps, rrep.baseline_aaps)
    # the optimizer's AAP totals on the 96-query stream (BENCH_optimizer)
    assert (treps[0].total_aaps, treps[0].baseline_aaps) == (2338, 3706)


def test_plan_cache_and_stats_identical(served):
    rsvc, tsvc, _, _ = served
    rs, ts = rsvc.stats(), tsvc.stats()
    assert set(ts) == set(rs)
    for key in rs:
        if key == "total_energy_nj":
            assert ts[key] == pytest.approx(rs[key], rel=REL)
        else:
            assert ts[key] == rs[key], key
    rc, tc = rsvc.planner.cache, tsvc.planner.cache
    assert (tc.hits, tc.misses, tc.compiles, tc.evictions, len(tc)) == \
        (rc.hits, rc.misses, rc.compiles, rc.evictions, len(rc))
    assert tsvc.scheduler.total_modeled_ns == rsvc.scheduler.total_modeled_ns
    assert tsvc.scheduler.total_energy_nj == pytest.approx(
        rsvc.scheduler.total_energy_nj, rel=REL)


def test_service_equals_its_unbatched_oracle(served):
    _, tsvc, _, (trep, tmat) = served
    spec = T.WorkloadSpec(**SPEC)
    for rep, queries in ((trep, T.query_stream(spec, tsvc)),
                         (tmat, _materialize_queries(T, tsvc))):
        oracle = T.run_queries_unbatched(tsvc.catalog, queries)
        assert T.results_bit_identical(rep.results, oracle.results)
        assert [r.scalar for r in rep.results] == \
            [r.scalar for r in oracle.results]


def test_converted_catalog_serves_reference_answers(served):
    rsvc, _, (rrep, _), _ = served
    cat = catalog_from_reference(rsvc.catalog, device="cpu")
    assert cat.names() == rsvc.catalog.names()
    assert cat.columns == rsvc.catalog.columns
    queries = T.query_stream(T.WorkloadSpec(**SPEC),
                             T.build_service(T.WorkloadSpec(**SPEC),
                                             device="cpu"))
    oracle = T.run_queries_unbatched(cat, queries)
    assert [r.scalar for r in oracle.results] == \
        [r.scalar for r in rrep.results]


@pytest.mark.parametrize("optimize", [True, False])
def test_explain_totals_identical(optimize):
    rsvc, tsvc = _services(optimize=optimize)
    rq = R.query_stream(R.WorkloadSpec(**SPEC), rsvc)
    tq = T.query_stream(T.WorkloadSpec(**SPEC), tsvc)
    re_, te = rsvc.explain(rq), tsvc.explain(tq)
    assert (te.total_aaps, te.baseline_aaps, te.n_plan_groups,
            te.makespan_ns) == (re_.total_aaps, re_.baseline_aaps,
                                re_.n_plan_groups, re_.makespan_ns)
    assert [(p.n_aaps, p.n_aaps_unopt, p.shared, p.rewritten,
             p.cache_hit) for p in te.plans] == \
        [(p.n_aaps, p.n_aaps_unopt, p.shared, p.rewritten, p.cache_hit)
         for p in re_.plans]
    assert te.total_aaps == (2338 if optimize else 3706)
    assert "explain" in str(te)


def test_materialize_and_derived_columns_identical():
    rsvc, tsvc = _services()
    for svc in (rsvc, tsvc):
        svc.materialize("t0/both", "t0/s0 & t0/s1", group="t0")
        svc.materialize_column("t0/total", "t0/col + t0/col2", group="t0")
    for q in ("t0/both | t0/s2", "sum(t0/total)", "t0/total < 100",
              "sum(t0/total - t0/col)"):
        a, b = rsvc.query(q), tsvc.query(q)
        assert b.scalar == a.scalar, q
    a = rsvc.range_scan("t0/total", 20, 180, mode=R.MATERIALIZE)
    b = tsvc.range_scan("t0/total", 20, 180, mode=T.MATERIALIZE)
    assert np.array_equal(b.words, a.words) and b.scalar == a.scalar


@pytest.mark.parametrize("policy", ["shed", "defer"])
def test_serving_loop_trace_identical(policy):
    rsvc, tsvc = _services()
    kw = dict(rate_qps=2e6, n_arrivals=48, heavy_frac=0.3,
              priorities={"t0": 0, "t1": 1, "t2": 1, "t3": 2})
    ra = R.poisson_arrivals(R.WorkloadSpec(**SPEC), rsvc, **kw)
    ta = T.poisson_arrivals(T.WorkloadSpec(**SPEC), tsvc, **kw)
    assert [(a.t_ns, a.priority) for a in ta] == \
        [(a.t_ns, a.priority) for a in ra]
    rrep = rsvc.serve_loop(depth=1, capacity=4, slo=R.SloConfig(
        p99_ns=5e4, policy=policy)).run_trace(ra)
    trep = tsvc.serve_loop(depth=1, capacity=4, slo=T.SloConfig(
        p99_ns=5e4, policy=policy)).run_trace(ta)

    def outcome(rep):
        return [(r.index, r.status, r.shed_reason, r.tick, r.complete_ns,
                 None if r.result is None else r.result.scalar)
                for r in rep.records]

    assert outcome(trep) == outcome(rrep)
    assert trep.deferred_total == rrep.deferred_total
    assert [(t.tick, t.n_queries, t.makespan_ns) for t in trep.ticks] == \
        [(t.tick, t.n_queries, t.makespan_ns) for t in rrep.ticks]
    assert trep.served      # the trace exercises admission control
    if policy == "shed":
        assert trep.shed
    else:
        assert trep.deferred_total > 0


def test_stats_registry_matches_legacy():
    """Metering on vs fully off agree on every shared key, to the last bit:
    the port accumulates both energy totals in one order."""
    spec = T.WorkloadSpec(**SPEC)
    on = T.build_service(spec, n_banks=4, device="cpu")
    off = T.build_service(spec, n_banks=4, device="cpu",
                          telemetry=T_NULL)
    for svc in (on, off):
        svc.query_batch(T.query_stream(spec, svc))
        svc.query_batch(_materialize_queries(T, svc))
    s_on, s_off = on.stats(), off.stats()
    for key in s_off:
        assert s_on[key] == s_off[key], key
    assert off.telemetry.metrics.snapshot() == {}
    # the reference's totals agree to the tolerance its own paths allow
    ref = R.build_service(R.WorkloadSpec(**SPEC), n_banks=4,
                          telemetry=R_NULL)
    ref.query_batch(R.query_stream(R.WorkloadSpec(**SPEC), ref))
    ref.query_batch(_materialize_queries(R, ref))
    assert s_off["total_energy_nj"] == pytest.approx(
        ref.stats()["total_energy_nj"], rel=REL)


#: wall-clock spans the port records and the reference does not
PORT_SPANS = ("cse_pass", "place", "gc")


def _without_port_spans(events):
    """The events' names without the port's own spans (their B events and
    the E events that close them), and those spans' names."""
    names, own, stack = [], [], []
    for e in events:
        if e["ph"] == "B":
            stack.append(e["name"] in PORT_SPANS)
            if stack[-1]:
                own.append(e["name"])
                continue
        elif e["ph"] == "E" and stack.pop():
            continue
        names.append(e["name"])
    return names, own


def test_tracing_telemetry_matches_reference():
    rsvc = R.build_service(R.WorkloadSpec(**SPEC),
                           telemetry=RTelemetry(trace=True))
    tsvc = T.build_service(T.WorkloadSpec(**SPEC), device="cpu",
                           telemetry=TTelemetry(trace=True))
    qs = ["t0/s0 & t0/s1", "t1/s0 & t1/s1", week_or(0, prefix="t2/")]
    rsvc.query_batch([R.Query(q) for q in qs])
    thresholds = gc.get_threshold()
    gc.set_threshold(50)     # so that the collector runs inside the batch
    try:
        tsvc.query_batch([T.Query(q) for q in qs])
    finally:
        gc.set_threshold(*thresholds)
    rt, tt = rsvc.export_chrome_trace(), tsvc.export_chrome_trace()
    validate_chrome_trace(tt)
    names, own = _without_port_spans(tt["traceEvents"])
    # the port's own spans: the CSE pass and the modeled placement of the
    # batch, and each pass of Python's collector inside it
    assert own.count("cse_pass") == own.count("place") == 1
    assert own.count("gc") >= 1 and set(own) == set(PORT_SPANS)
    assert sorted(names) == sorted(e["name"] for e in rt["traceEvents"])
    assert "queries_total 3" in tsvc.prometheus()
    assert "queries_total 3" in rsvc.prometheus()


def test_forced_cuda_backend_routes_through_the_wrappers():
    """With no optimizer pinning a backend, every group goes through the
    VM wrapper, which on CPU tensors runs its plain version and launches
    nothing — and the answers stay the reference's. There is no backend
    knob: the device alone picks kernel or plain version."""
    spec = T.WorkloadSpec(**SPEC)
    with pytest.raises(TypeError, match="unknown keyword"):
        T.QueryService(device="cpu", backend="torch")
    assert "backend" not in T.ServiceConfig.__dataclass_fields__
    svc = T.build_service(spec, device="cpu", optimize=False)
    ref = R.build_service(R.WorkloadSpec(**SPEC), optimize=False)
    before = dict(LAUNCHES)
    trep = svc.query_batch(T.query_stream(spec, svc))
    rrep = ref.query_batch(R.query_stream(R.WorkloadSpec(**SPEC), ref))
    assert [r.scalar for r in trep.results] == \
        [r.scalar for r in rrep.results]
    assert dict(LAUNCHES) == before
    assert all(p.backend is None for p in svc.planner.cache._plans.values())
    assert {p.backend for p in svc.explain(
        T.query_stream(spec, svc)).plans} == {"torch"}


def test_device_default_and_unported_modes(tmp_path):
    if torch.cuda.is_available():
        assert T.QueryService().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.QueryService()
        with pytest.raises(RuntimeError):
            T.build_service(T.WorkloadSpec(**SPEC))
    # the deployment modes are ported: n_chips builds a chip cluster on
    # the service's device, max_chips alone is only recorded, and a
    # fault-tolerance policy gets the chip-failure recovery hook
    from repro_torch.dist.fault_tolerance import FaultTolerance

    dist = T.QueryService(T.ServiceConfig(device="cpu", n_chips=2))
    assert dist.cluster.n_chips == 2 and dist.max_chips == 8
    assert {d.type for d in dist.cluster.devices} == {"cpu"}
    assert dist.scheduler.cluster is dist.cluster
    solo = T.QueryService(T.ServiceConfig(device="cpu", max_chips=4))
    assert solo.cluster is None and solo.max_chips == 4
    ft = FaultTolerance()
    guarded = T.QueryService(T.ServiceConfig(device="cpu",
                                             fault_tolerance=ft))
    assert guarded.scheduler.fault_tolerance is ft
    assert ft.on_chip_failure == guarded._recover_chip_failure
    # TRA reliability is ported: a ReliabilityConfig is taken, anything
    # else raises
    from repro_torch.core.errors import ReliabilityConfig

    assert T.QueryService(T.ServiceConfig(
        device="cpu", reliability=ReliabilityConfig(mode="ecc"))
    ).scheduler.reliability.mode == "ecc"
    with pytest.raises(TypeError, match="ReliabilityConfig"):
        T.QueryService(T.ServiceConfig(device="cpu", reliability=object()))
    svc = T.QueryService(T.ServiceConfig(device="cpu"))
    with pytest.raises(ValueError, match="n_chips"):
        svc.rescale(2)
    assert dist.rescale(4).grad_accum == 2 and dist.cluster.n_chips == 4
    vals, rep = svc.serve_stream([], str(tmp_path / "ck"))
    assert vals.shape == (0,) and rep.timeline == ["ckpt@0"]
    assert svc.catalog.device.type == "cpu"
    assert T.choose_backend(
        T.Planner().cache.lookup(
            T.canonicalize(T.parse_query("a & b"))[0])[0].program,
        "cuda") == "cuda"


def test_service_config_consolidation_and_shims():
    """The twin of the reference's `test_server.py` case: the deprecated
    deployment keywords (``reliability``, ``fault_tolerance``,
    ``n_chips``; the port has no ``backend``) warn naming
    `ServiceConfig` before anything else happens, once per call; the
    convenience keywords stay silent; unknown ones raise."""
    import warnings

    from repro.service.config import DEPRECATED_KWARGS as R_DEPRECATED
    from repro_torch.core.errors import ReliabilityConfig
    from repro_torch.service.config import DEPRECATED_KWARGS

    cfg = T.ServiceConfig(n_banks=4, device="cpu",
                          slo=T.SloConfig(p99_ns=1e6))
    svc = T.QueryService(cfg)
    assert svc.config is cfg and svc.n_banks == 4
    assert svc.serve_loop().slo.p99_ns == 1e6
    assert DEPRECATED_KWARGS == {"reliability", "fault_tolerance",
                                 "n_chips"} == R_DEPRECATED - {"backend"}
    rel = ReliabilityConfig(mode="vote")
    with pytest.warns(DeprecationWarning, match="ServiceConfig") as seen:
        svc2 = T.QueryService(n_banks=4, device="cpu", reliability=rel)
    assert len(seen) == 1 and svc2.config.reliability is rel
    # the deployment keywords warn, then configure the deployment
    from repro_torch.dist.fault_tolerance import FaultTolerance

    ft = FaultTolerance()
    for field, value in (("n_chips", 2), ("fault_tolerance", ft)):
        with pytest.warns(DeprecationWarning, match=f"{field}=.*"
                          "ServiceConfig") as seen:
            svc3 = T.QueryService(device="cpu", **{field: value})
        assert len(seen) == 1 and getattr(svc3.config, field) is value
    assert svc3.scheduler.fault_tolerance is ft
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.QueryService(n_banks=4, device="cpu", optimize=False)
    with pytest.raises(TypeError, match="unknown keyword"):
        T.QueryService(bogus=1)
