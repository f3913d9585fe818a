"""Port parity: fault tolerance, checkpointing and the chaos suite on the
CPU.

The cases of tests/test_fault_tolerance.py and tests/test_chaos.py,
ported: the straggler EMA, checkpoint damage fallback, the async-save
race `ResilientRunner._restore` must never lose, scheduler replay,
exhausted replays, stragglers, a chip kill with rescale-down (chips on
``["cpu"] * C``), `serve_stream` recovery, resume and its refusal of
materialize. Every recovered run is held to a never-failed run and to
the JAX package's single-process service. A checkpoint written by either
package (int64, uint32, float32 and bfloat16 leaves in nested dicts and
lists) restores in the other, and a stream served by the JAX package's
`serve_stream` resumes in the port's.
"""
import json
import os
import shutil
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.service as R
from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro_torch import service as T
from repro_torch.checkpoint import Checkpointer, load_checkpoint
from repro_torch.dist.fault_tolerance import (ChipFailure, FaultTolerance,
                                              ResilientRunner, RunReport,
                                              SimulatedFailure,
                                              StragglerMonitor)

QUERIES = [("a & b", "popcount"), ("a | c & ~d", "popcount"),
           ("(a ^ b) | (c & d)", "popcount"), ("~a & d", "materialize")]


def _queries(pkg, qs=QUERIES):
    return [pkg.Query(q, mode) for q, mode in qs]


def _service(pkg=T, n_chips=None, **kw):
    rng = np.random.default_rng(2)
    if pkg is T:
        svc = T.QueryService(T.ServiceConfig(
            n_banks=8, device="cpu", n_chips=n_chips,
            max_chips=8 if n_chips else None, **kw))
    else:
        svc = R.QueryService(R.ServiceConfig(
            n_banks=8, n_chips=n_chips, max_chips=8 if n_chips else None,
            **kw))
    for n in "abcd":
        svc.register_bits(n, rng.integers(0, 2, 700).astype(bool),
                          group="t0")
    return svc


# ---------------------------------------------------------------------------
# StragglerMonitor
# ---------------------------------------------------------------------------


def test_straggler_warmup_boundary_exactly_n_equals_warmup():
    m = StragglerMonitor(alpha=0.5, threshold=2.0, warmup=3)
    assert not m.observe(0, 1.0)
    assert not m.observe(1, 100.0)      # n == 2 <= warmup: never flagged
    assert not m.observe(2, 100.0)      # n == 3 == warmup: still seeding
    assert m.observe(3, 10 * m.ema)     # n == 4 > warmup: flagged


def test_straggler_outliers_do_not_update_ema():
    m = StragglerMonitor(alpha=0.5, threshold=2.0, warmup=1)
    m.observe(0, 1.0)
    m.observe(1, 1.0)
    ema = m.ema
    assert m.observe(2, 50.0)
    assert m.ema == ema
    assert m.observe(3, 50.0)


def test_straggler_alpha_one_tracks_last_observation():
    m = StragglerMonitor(alpha=1.0, threshold=3.0, warmup=1)
    m.observe(0, 2.0)
    assert not m.observe(1, 4.0)
    assert m.ema == 4.0
    assert not m.observe(2, 11.9)
    assert m.ema == 11.9


def test_straggler_first_observation_never_flags():
    m = StragglerMonitor(warmup=0)
    assert not m.observe(0, 1e9)


def test_straggler_monitor_matches_reference_on_a_random_trace():
    from repro.dist.fault_tolerance import StragglerMonitor as RMonitor

    rng = np.random.default_rng(0)
    times = rng.lognormal(0.0, 1.0, 200)
    t, r = StragglerMonitor(), RMonitor()
    assert [t.observe(i, x) for i, x in enumerate(times)] == \
        [r.observe(i, x) for i, x in enumerate(times)]
    assert t.ema == r.ema


# ---------------------------------------------------------------------------
# Checkpointer: damage fallback, layout, and both packages' files
# ---------------------------------------------------------------------------


def _save_steps(d, steps):
    ck = Checkpointer(d, keep=len(steps) + 1, async_save=False)
    for s in steps:
        ck.save(s, {"x": np.full(4, s, np.int64)})
    return ck


def _corrupt(d, step, how):
    path = os.path.join(d, f"step_{step:08d}")
    if how == "truncate_leaf":
        with open(os.path.join(path, "leaf_00000.bin"), "wb") as f:
            f.write(b"\x00")
    elif how == "missing_leaf":
        os.remove(os.path.join(path, "leaf_00000.bin"))
    elif how == "bad_manifest":
        with open(os.path.join(path, "manifest.json"), "w") as f:
            f.write("{")


@pytest.mark.parametrize("how", ["truncate_leaf", "missing_leaf",
                                 "bad_manifest"])
def test_restore_falls_back_to_next_older_intact_step(tmp_path, how):
    d = str(tmp_path)
    ck = _save_steps(d, [1, 2])
    _corrupt(d, 2, how)
    step, tree, _ = ck.restore({"x": np.zeros(4, np.int64)})
    assert step == 1
    assert int(tree["x"][0]) == 1 and tree["x"].dtype == torch.int64


def test_restore_explicit_step_still_raises_on_damage(tmp_path):
    ck = _save_steps(str(tmp_path), [1, 2])
    _corrupt(str(tmp_path), 2, "truncate_leaf")
    with pytest.raises((OSError, ValueError, KeyError)):
        ck.restore({"x": np.zeros(4, np.int64)}, step=2)


def test_restore_all_damaged_raises_filenotfound(tmp_path):
    ck = _save_steps(str(tmp_path), [1])
    _corrupt(str(tmp_path), 1, "missing_leaf")
    with pytest.raises(FileNotFoundError):
        ck.restore({"x": np.zeros(4, np.int64)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({})


def test_all_steps_skips_tmp_dirs_and_keep_collects(tmp_path):
    d = str(tmp_path)
    ck = _save_steps(d, [1])
    tmp = os.path.join(d, "step_00000002.tmp-deadbeef")
    shutil.copytree(os.path.join(d, "step_00000001"), tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": 2, "extra": {}, "leaves": []}, f)
    assert ck.all_steps() == [1]
    assert ck.latest_step() == 1
    ck = Checkpointer(d, keep=2, async_save=True)
    for s in (3, 4, 5):
        ck.save(s, {"x": np.full(2, s, np.int64)})
    ck.wait()
    assert ck.all_steps() == [4, 5]


def _mixed_tree():
    rng = np.random.default_rng(3)
    return {"values": rng.integers(-2**40, 2**40, 5).astype(np.int64),
            "done": np.int64(7),
            "words": rng.integers(0, 1 << 32, (2, 3), dtype=np.uint32),
            "layers": [{"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "b": rng.standard_normal(4).astype(np.float32)}
                       for _ in range(2)],
            "bf16": rng.standard_normal((4, 2)).astype(np.float32)}


def _as_port(tree):
    out = dict(tree)
    out["bf16"] = torch.from_numpy(tree["bf16"]).to(torch.bfloat16)
    out["layers"] = [{k: torch.from_numpy(v) for k, v in layer.items()}
                     for layer in tree["layers"]]
    return out


def _as_ref(tree):
    out = dict(tree)
    out["bf16"] = tree["bf16"].astype(ml_dtypes.bfloat16)
    return out


def _leaves_equal(port_tree, ref_tree):
    """Same structure, dtypes and bits (bf16 compared as 16-bit words)."""
    assert sorted(port_tree) == sorted(ref_tree)
    for k in ref_tree:
        if k == "layers":
            for a, b in zip(port_tree[k], ref_tree[k]):
                _leaves_equal(a, b)
            continue
        p, r = port_tree[k], np.asarray(ref_tree[k])
        if isinstance(p, torch.Tensor) and p.dtype == torch.bfloat16:
            assert r.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(p.view(torch.int16).numpy(),
                                          r.view(np.int16))
            continue
        p = np.asarray(p)
        assert p.dtype == r.dtype and p.shape == r.shape, k
        np.testing.assert_array_equal(p, r, err_msg=k)


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    """The port writes the reference's files byte for byte, so the
    reference restores them exactly as it restores its own (through
    `jnp.asarray`, whose dtype rules apply to both)."""
    tree = _mixed_tree()
    ck = Checkpointer(str(tmp_path / "port"), async_save=True)
    ck.save(3, _as_port(tree), extra={"who": "port"})
    ck.wait()
    RCheckpointer(str(tmp_path / "ref"), async_save=False).save(
        3, _as_ref(tree), extra={"who": "port"})
    dirs = [tmp_path / d / "step_00000003" for d in ("port", "ref")]
    manifests = [json.loads((d / "manifest.json").read_text())
                 for d in dirs]
    assert manifests[0] == manifests[1]
    assert [e["name"] for e in manifests[0]["leaves"]] == [
        "bf16", "done", "layers/0/b", "layers/0/w", "layers/1/b",
        "layers/1/w", "values", "words"]
    assert manifests[0]["leaves"][0]["dtype"] == "bfloat16"
    for e in manifests[0]["leaves"]:
        assert (dirs[0] / e["file"]).read_bytes() == \
            (dirs[1] / e["file"]).read_bytes(), e["name"]
    step, got, extra = RCheckpointer(str(tmp_path / "port")).restore(
        _as_ref(tree))
    _, want, _ = RCheckpointer(str(tmp_path / "ref")).restore(_as_ref(tree))
    assert step == 3 and extra == {"who": "port"}
    got_leaves = jax.tree_util.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == 8
    for a, b in zip(got_leaves, want_leaves):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    tree = _mixed_tree()
    rck = RCheckpointer(str(tmp_path), async_save=False)
    rck.save(4, _as_ref(tree), extra={"who": "ref"})
    step, got, extra = load_checkpoint(str(tmp_path), _as_port(tree))
    assert step == 4 and extra == {"who": "ref"}
    assert isinstance(got["layers"], list)
    _leaves_equal(got, _as_ref(tree))
    # devices= places every leaf (one device, or a tree of them)
    _, placed, _ = Checkpointer(str(tmp_path)).restore(
        _as_port(tree), devices="cpu")
    assert placed["bf16"].device.type == "cpu"
    with pytest.raises(ValueError, match="leaves"):
        Checkpointer(str(tmp_path)).restore({"x": np.zeros(1)}, step=4)


# ---------------------------------------------------------------------------
# ResilientRunner vs the async save race
# ---------------------------------------------------------------------------


class _SlowCheckpointer(Checkpointer):
    """Async writes stalled long enough to expose restore/save races."""

    def __init__(self, directory, delay=0.15):
        super().__init__(directory, async_save=True)
        self.delay = delay

    def _write(self, step, leaves, extra):
        time.sleep(self.delay)
        super()._write(step, leaves, extra)


def _counting_step_fn(log):
    def step_fn(state, step, batch):
        log.append(step)
        return {"n": np.int64(int(state["n"]) + 1)}, {}
    return step_fn


def test_restore_after_failure_waits_for_inflight_save(tmp_path):
    log = []
    ck = _SlowCheckpointer(str(tmp_path))
    runner = ResilientRunner(_counting_step_fn(log), lambda s: None,
                             ck, ckpt_every=2, max_restores=4)
    fails = {"armed": True}

    def inject(step):
        if step == 2 and fails["armed"]:
            fails["armed"] = False
            raise SimulatedFailure("crash during in-flight save")

    state, rep = runner.run({"n": np.int64(0)}, 4, failure_injector=inject)
    assert int(state["n"]) == 4
    assert rep.failures == 1
    assert "restore@2" in rep.timeline
    assert log == [0, 1, 2, 3]


def test_fresh_runner_resumes_over_partially_written_dir(tmp_path):
    d = str(tmp_path)
    log = []
    ck = Checkpointer(d, async_save=False)
    runner = ResilientRunner(_counting_step_fn(log), lambda s: None, ck,
                             ckpt_every=2)
    runner.run({"n": np.int64(0)}, 2)
    tmp = os.path.join(d, "step_00000004.tmp-cafe")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": 4, "extra": {}, "leaves": []}, f)
    shutil.copytree(os.path.join(d, "step_00000002"),
                    os.path.join(d, "step_00000003"))
    os.remove(os.path.join(d, "step_00000003", "leaf_00000.bin"))
    log2 = []
    runner2 = ResilientRunner(_counting_step_fn(log2), lambda s: None,
                              Checkpointer(d), ckpt_every=2)
    state, rep = runner2.run({"n": np.int64(0)}, 4)
    assert rep.timeline[0] == "resume@2"
    assert log2 == [2, 3]
    assert int(state["n"]) == 4


def test_runner_reraises_after_max_restores(tmp_path):
    runner = ResilientRunner(_counting_step_fn([]), lambda s: None,
                             Checkpointer(str(tmp_path)), max_restores=1)

    def inject(step):
        raise SimulatedFailure("permanent")

    with pytest.raises(SimulatedFailure):
        runner.run({"n": np.int64(0)}, 2, failure_injector=inject)


# ---------------------------------------------------------------------------
# policy objects
# ---------------------------------------------------------------------------


def test_chip_failure_records_chip_and_is_simulated():
    e = ChipFailure(3)
    assert e.chip == 3 and "chip 3" in str(e)
    assert isinstance(e, SimulatedFailure)
    assert str(ChipFailure(1, "custom")) == "custom"


def test_fault_tolerance_defaults():
    ft = FaultTolerance()
    assert ft.max_replays == 2
    assert ft.timeline == [] and ft.stragglers == []
    assert ft.failures == ft.replays == ft.groups_dispatched == 0
    assert isinstance(ft.monitor, StragglerMonitor)
    assert RunReport().timeline == []


# ---------------------------------------------------------------------------
# chaos against the serving stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clean():
    """The never-failed run, held to the reference's service."""
    rep = _service().query_batch(_queries(T))
    ref = _service(R).query_batch(_queries(R))
    assert R.results_bit_identical(ref.results, rep.results)
    return rep


@pytest.mark.parametrize("n_chips", [None, 2])
def test_failed_group_replayed_bit_identical(clean, n_chips):
    ft = FaultTolerance(max_replays=2)
    armed = {"live": True}

    def inject(g):
        if g == 1 and armed["live"]:
            armed["live"] = False
            raise SimulatedFailure("transient kernel fault")

    ft.failure_injector = inject
    svc = _service(n_chips=n_chips, fault_tolerance=ft)
    rep = svc.query_batch(_queries(T))
    assert T.results_bit_identical(clean.results, rep.results)
    assert ft.failures == 1 and ft.replays == 1
    assert ft.timeline == ["failure@group1:SimulatedFailure",
                           "replay@group1"]
    s = svc.stats()
    assert (s["failures"], s["replays"], s["chip_rescales"]) == (1, 1, 0)
    assert svc.n_chips == n_chips      # a plain fault keeps the topology


def test_replays_exhausted_reraises():
    ft = FaultTolerance(max_replays=1)

    def inject(g):
        raise SimulatedFailure("permanent fault")

    ft.failure_injector = inject
    svc = _service(fault_tolerance=ft)
    with pytest.raises(SimulatedFailure):
        svc.query_batch(_queries(T)[:1])
    assert ft.failures == 2
    assert ft.replays == 1


def test_straggling_group_flagged_on_timeline():
    ft = FaultTolerance(monitor=StragglerMonitor(alpha=1.0, threshold=3.0,
                                                 warmup=2))

    def inject(g):
        if g == 5:
            time.sleep(0.5)

    ft.failure_injector = inject
    svc = _service(fault_tolerance=ft)
    for _ in range(6):
        svc.query_batch(_queries(T)[:1])
    assert 5 in ft.stragglers
    assert "straggler@group5" in ft.timeline
    assert ft.failures == 0
    assert svc.stats()["stragglers"] == len(ft.stragglers)


def test_chip_kill_rescales_and_recovers_bit_identical(clean):
    ft = FaultTolerance(max_replays=2)
    armed = {"live": True}

    def inject(g):
        if g == 2 and armed["live"]:
            armed["live"] = False
            raise ChipFailure(3)

    ft.failure_injector = inject
    svc = _service(n_chips=4, fault_tolerance=ft)
    rep = svc.query_batch(_queries(T))
    assert T.results_bit_identical(clean.results, rep.results)
    # 4 chips over a 64-slot grid: 3 doesn't divide, recovery lands on 2
    assert svc.n_chips == 2 and svc.cluster.n_chips == 2
    assert "failure@group2:ChipFailure" in ft.timeline
    assert "rescale@4->2" in ft.timeline
    assert "replay@group2" in ft.timeline
    assert svc.stats()["chip_rescales"] == 1
    rep2 = svc.query_batch(_queries(T))
    assert T.results_bit_identical(clean.results, rep2.results)
    assert svc.catalog.verify_parity()


def test_chip_kill_on_the_last_chip_raises():
    ft = FaultTolerance(max_replays=2)

    def inject(g):
        raise ChipFailure(0)

    ft.failure_injector = inject
    svc = _service(n_chips=1, fault_tolerance=ft)
    with pytest.raises(RuntimeError, match="no valid smaller layout"):
        svc.query_batch(_queries(T)[:1])


_BATCHES = [[("a & b", "popcount"), ("c | d", "popcount")],
            [("a ^ b", "popcount")], [("~a & d", "popcount")],
            [("a & b & c", "popcount")]]


def test_serve_stream_failure_recovers_and_resumes(tmp_path):
    batches = [_queries(T, b) for b in _BATCHES]
    base = _service()
    expect = [base.query(q.query).value for b in batches for q in b]
    ck_dir = str(tmp_path / "ck")
    armed = {"live": True}

    def inject(step):
        if step == 2 and armed["live"]:
            armed["live"] = False
            raise SimulatedFailure("mid-stream crash")

    vals, rep = _service().serve_stream(batches, ck_dir, ckpt_every=1,
                                        failure_injector=inject)
    assert list(vals) == expect and vals.dtype == np.int64
    assert rep.failures == 1 and rep.restores == 1
    assert "restore@2" in rep.timeline
    vals2, rep2 = _service().serve_stream(batches, ck_dir)
    assert list(vals2) == expect
    assert rep2.steps_run == 0
    assert rep2.timeline[0] == f"resume@{len(batches)}"


def test_serve_stream_resumes_a_stream_of_the_reference(tmp_path):
    """The reference's `serve_stream` writes the checkpoints; a fresh port
    service resumes from them with nothing left to run."""
    ck_dir = str(tmp_path / "ck")
    want, _ = _service(R).serve_stream(
        [_queries(R, b) for b in _BATCHES], ck_dir, ckpt_every=1)
    got, rep = _service().serve_stream([_queries(T, b) for b in _BATCHES],
                                       ck_dir)
    assert list(got) == list(want) and rep.steps_run == 0


def test_serve_stream_rejects_materialize(tmp_path):
    with pytest.raises(ValueError, match="materialize"):
        _service().serve_stream([[T.Query("a & b", mode="materialize")]],
                                str(tmp_path / "ck"))


def test_chip_kill_mid_stream_preserves_every_result(tmp_path):
    batches = [_queries(T, b) for b in
               [[("a & b", "popcount"), ("c | d", "popcount")],
                [("a ^ b", "popcount")],
                [("(a ^ b) | (c & d)", "popcount")]]]
    base = _service()
    expect = [base.query(q.query).value for b in batches for q in b]
    ft = FaultTolerance(max_replays=2)
    armed = {"live": True}

    def inject(g):
        if g == 1 and armed["live"]:
            armed["live"] = False
            raise ChipFailure(1)

    ft.failure_injector = inject
    svc = _service(n_chips=2, fault_tolerance=ft)
    vals, _ = svc.serve_stream(batches, str(tmp_path / "ck"))
    assert list(vals) == expect
    assert svc.n_chips == 1
    assert "rescale@2->1" in ft.timeline


# ---------------------------------------------------------------------------
# the serving loop under faults, and the stream's telemetry
# ---------------------------------------------------------------------------

_EXPRS = ["a & b", "a | c", "(a ^ b) | (c & d)", "~a & d", "a & b & c"]


def _loop_service(pkg, **kw):
    rng = np.random.default_rng(5)
    cfg = (T.ServiceConfig(n_banks=4, device="cpu", **kw) if pkg is T
           else R.ServiceConfig(n_banks=4, **kw))
    svc = pkg.QueryService(cfg)
    for n in "abcd":
        svc.register_bits(n, rng.integers(0, 2, 640).astype(bool),
                          group="t")
    return svc


def _arrivals(pkg, n=12):
    return [pkg.Arrival(t_ns=0.0, query=pkg.Query(_EXPRS[i % len(_EXPRS)],
                                                  tenant=f"t{i % 3}"))
            for i in range(n)]


@pytest.mark.parametrize("kill", [False, True])
def test_loop_failure_mid_trace_recovers_bit_identical(kill):
    """A transient fault mid-tick is replayed; a chip killed mid-trace on
    a 2-chip cluster shrinks it to one, and the trace still serves the
    never-failed results (equal to the reference's loop)."""
    kw = dict(n_chips=2, max_chips=4) if kill else {}
    clean = _loop_service(T, **kw).serve_loop(depth=2).run_trace(
        _arrivals(T))
    ref = _loop_service(R).serve_loop(depth=2).run_trace(_arrivals(R))
    assert R.results_bit_identical(ref.results(), clean.results())
    ft = FaultTolerance(max_replays=2)
    armed = {"live": True}

    def inject(g):
        if armed["live"]:
            armed["live"] = False
            raise ChipFailure(1) if kill else SimulatedFailure("mid-tick")

    ft.failure_injector = inject
    svc = _loop_service(T, fault_tolerance=ft, **kw)
    rep = svc.serve_loop(depth=2).run_trace(_arrivals(T))
    assert ft.failures == 1 and ft.replays == 1
    assert T.results_bit_identical(rep.results(), clean.results())
    if kill:
        assert svc.n_chips == 1 and "rescale@2->1" in ft.timeline
        assert svc.serve_loop(depth=2).slots == svc.cluster.slots == 16


def test_serve_stream_trace_and_counters_consistent(tmp_path):
    from repro_torch.obs import Telemetry
    from repro_torch.obs.trace import validate_chrome_trace

    tel = Telemetry()
    svc = _service(telemetry=tel)
    stream = _queries(T, [(e, "popcount") for e in _EXPRS] * 3)
    batches = [stream[:8], stream[8:]]
    armed = {"live": True}

    def inject(step):
        if step == 1 and armed["live"]:
            armed["live"] = False
            raise SimulatedFailure("mid-stream crash")

    values, rep = svc.serve_stream(batches, str(tmp_path / "ckpt"),
                                   ckpt_every=1, failure_injector=inject)
    assert len(values) == len(stream)
    m = tel.metrics
    assert m.counter("checkpoints_total").value == rep.checkpoints == 2
    assert m.counter("stream_failures_total").value == 1
    assert m.counter("stream_restores_total").value == 1
    # the injector fails a step before its batch runs: two batches served
    assert m.counter("batches_total").value == len(batches)
    assert m.counter("queries_total").value == len(stream)
    payload = svc.export_chrome_trace(tmp_path / "trace.json")
    loaded = json.loads(payload.read_text())
    validate_chrome_trace(loaded)
    instants = [e["name"] for e in loaded["traceEvents"] if e["ph"] == "i"]
    assert instants.count("checkpoint") == 2
    assert instants.count("stream_failure") == 1
    assert instants.count("stream_restore") == 1
