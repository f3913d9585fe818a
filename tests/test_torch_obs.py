"""The port's spans and counters on the CPU: every span site opens a
`torch.profiler` range of its name while a profiler records, costs one
flag test and allocates nothing with neither a profiler nor a tracer, and
the service counts its CSE pass, its modeled placement, Python's
collector and its VM launches in its own registry."""
import gc
import tracemalloc

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import repro_torch.service as T
from repro_torch.configs import get_config, reduced
from repro_torch.core import lowering
from repro_torch.models import build
from repro_torch.obs import NULL_TELEMETRY, Telemetry, get_telemetry
from repro_torch.obs import set_telemetry
from repro_torch.obs.trace import _NULL_CM, validate_chrome_trace
from repro_torch.optim import constant, sgd, signum
from repro_torch.train import make_train_step, make_train_step_compressed

SPEC = dict(n_tenants=4, n_weeks=3, domain_bits=1 << 12, n_queries=96)
#: three queries sharing ``t0/s0 & t0/s1``: two plan groups, one shared plane
SHARED = ["(t0/s0 & t0/s1) | t0/s2", "(t0/s0 & t0/s1) | t0/s3",
          "(t0/s0 & t0/s1) & ~t0/s2"]
STEP_SPANS = ("step.grads", "step.clip", "step.update")


def _service(telemetry):
    return T.build_service(T.WorkloadSpec(**SPEC), device="cpu",
                           telemetry=telemetry)


def _tiny_step(compressed_group=None):
    bundle = build(reduced(get_config("qwen3_0p6b")), device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    if compressed_group is None:
        opt = sgd(constant(1e-3))
        step = make_train_step(bundle, opt, grad_accum=2)
    else:
        opt = signum(constant(1e-3), group=compressed_group)
        step = make_train_step_compressed(bundle, opt, compressed_group)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 256, (2, 16), generator=g),
             "labels": torch.randint(0, 256, (2, 16), generator=g)}
    return step, params, opt.init(params), batch


def _range_names(prof):
    return {e.name for e in prof.events() if e.is_user_annotation}


def test_profiler_sees_the_query_and_train_spans():
    svc = _service(Telemetry(trace=False))
    step, params, state, batch = _tiny_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.query_batch([T.Query(q) for q in SHARED])
        step(params, state, 0, batch)
    names = _range_names(prof)
    for want in ("batch", "query", "plan", "parse", "plan_cache", "bind",
                 "cse_pass", "cse_group", "cse_dispatch", "group",
                 "dispatch", "readout", "place") + STEP_SPANS:
        assert want in names, want
    # the service's tracer stays off: the ranges are the profiler's alone
    assert svc.telemetry.tracer.events == []


def test_compressed_step_opens_the_same_spans(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        step, params, state, batch = _tiny_step(dist.group.WORLD)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(params, state, 0, batch)
    finally:
        dist.destroy_process_group()
    assert set(STEP_SPANS) <= _range_names(prof)


def test_published_tracing_telemetry_records_the_step_spans():
    tel = Telemetry(trace=True)
    step, params, state, batch = _tiny_step()
    prev = set_telemetry(tel)
    try:
        step(params, state, 0, batch)
    finally:
        set_telemetry(prev)
    begun = [e["name"] for e in tel.tracer.events if e["ph"] == "B"]
    assert [n for n in begun if n.startswith("step.")] == list(STEP_SPANS)
    validate_chrome_trace(tel.export_chrome_trace())


def _traced_growth(fn, n=20000):
    """(bytes kept, peak bytes above the start) of ``fn(n)``."""
    fn(100)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        fn(n)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return after - before, peak - before


@pytest.mark.parametrize("tel", [NULL_TELEMETRY, Telemetry(trace=False)],
                         ids=["null", "metering"])
def test_span_site_is_one_flag_test_and_allocates_nothing(tel):
    assert tel.span("cse_pass") is _NULL_CM
    assert not tel.spans_on()

    def bare(n):                  # the loop with the no-op manager alone
        for _ in range(n):
            with _NULL_CM:
                pass
            with _NULL_CM:
                pass

    def sites(n):
        for _ in range(n):
            with tel.span("cse_pass"):
                pass
            with tel.span("step.update"):
                pass

    # 40,000 sites keep nothing and make no temporary the bare loop does
    # not (one Span a site would raise every run's peak by its size; the
    # best of three runs each is taken against another thread's allocations)
    runs = [_traced_growth(sites) for _ in range(3)]
    assert min(kept for kept, _ in runs) <= 0
    assert min(peak for _, peak in runs) <= \
        max(_traced_growth(bare)[1] for _ in range(3))
    assert tel.tracer.events == []


def test_spans_nest_and_unwind_per_thread():
    tel = Telemetry(trace=True)
    with pytest.raises(RuntimeError):
        with tel.span("outer", k=1):
            tel.begin("inner")           # an exception skips its end
            raise RuntimeError
    evs = [(e["name"], e["ph"]) for e in tel.tracer.events
           if e["ph"] in "BE"]
    assert evs == [("outer", "B"), ("inner", "B"), ("", "E"), ("", "E")]
    validate_chrome_trace(tel.export_chrome_trace())


def test_telemetry_has_no_reset_trace():
    assert not hasattr(Telemetry, "reset_trace")


def test_vm_launches_are_the_groups_and_shared_planes(monkeypatch):
    svc = _service(Telemetry(trace=False))
    calls = []
    real = lowering.VmCall.run

    def counted(self, vm_fn, reduce=None):
        calls.append(self.plane.numel())
        return real(self, vm_fn, reduce)

    monkeypatch.setattr(lowering.VmCall, "run", counted)
    rep = svc.query_batch([T.Query(q) for q in SHARED])
    plans = list(svc.planner.cache._plans.values())
    assert all(p.lowered is not None and p.backend != "interp"
               for p in plans)
    snap = svc.telemetry.metrics.snapshot()
    assert rep.n_cse_planes == 1
    assert snap["vm_launches_total"] == len(calls) == \
        rep.n_plan_groups + rep.n_cse_planes
    # the stacked planes read, at least, plus what the launches wrote
    assert snap["vm_bytes_total"] > 4 * sum(calls)
    assert snap["cse_pass_seconds_total"] > 0
    assert snap["place_seconds_total"] > 0
    # a service without metering counts nothing, and nothing is published
    # outside a batch
    bare = _service(NULL_TELEMETRY)
    bare.query_batch([T.Query(q) for q in SHARED])
    assert bare.telemetry.metrics.snapshot() == {}
    assert get_telemetry() is NULL_TELEMETRY


def test_metering_alone_publishes_the_telemetry_for_the_batch(monkeypatch):
    tel = Telemetry(trace=False)
    svc = _service(tel)
    seen = []
    real = lowering.VmCall.run

    def spy(self, vm_fn, reduce=None):
        seen.append(get_telemetry())
        return real(self, vm_fn, reduce)

    monkeypatch.setattr(lowering.VmCall, "run", spy)
    svc.query_batch([T.Query(q) for q in SHARED])
    assert seen and all(t is tel for t in seen)


def _gc_counts(tel):
    snap = tel.metrics.snapshot()
    return (snap.get('gc_collections_total{generation="2"}', 0),
            snap.get('gc_pause_seconds_total{generation="2"}', 0.0))


def test_collections_are_charged_to_the_published_telemetry():
    tel = Telemetry(trace=False)
    n0, s0 = _gc_counts(tel)
    gc.collect(2)                      # nothing published: not charged
    assert _gc_counts(tel) == (n0, s0)
    prev = set_telemetry(tel)
    try:
        gc.collect(2)
    finally:
        set_telemetry(prev)
    n1, s1 = _gc_counts(tel)
    assert n1 == n0 + 1 and s1 > s0
    gc.collect(2)
    assert _gc_counts(tel) == (n1, s1)


def test_collection_is_a_span_when_tracing_or_profiling():
    tel = Telemetry(trace=True)
    prev = set_telemetry(tel)
    try:
        gc.collect(1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            gc.collect(2)
    finally:
        set_telemetry(prev)
    gcs = [e for e in tel.tracer.events
           if e["ph"] == "B" and e["name"] == "gc"]
    assert [e["args"]["generation"] for e in gcs] == [1, 2]
    validate_chrome_trace(tel.export_chrome_trace())
    assert "gc" in _range_names(prof)
