"""Port parity: the chip cluster (`core.cluster`), its sharding rules and
the distributed query service, on the CPU.

The port's chips are ``["cpu"] * C`` for C in 1, 2, 4 and 8; every case
is held to the JAX package: sharded execution to its single-chip
`engine.execute` (the micro-op interpreter), slot contents to its
`bankgroup.shard_words`, `resolve_spec` to its `PartitionSpec`s, the
modeled schedule and `plan_rescale` to its pure-Python models, and the
distributed service to its single-process service and unbatched oracle.
The cases of tests/test_cluster.py and tests/test_property_cluster.py,
ported; the random programs are those of tests/test_torch_vm.py, built
in both packages.

One subprocess forces eight host devices and runs the JAX package's
distributed `QueryService` at 2 and 4 chips (``max_chips=8``), through a
`rescale` and a chip-kill chaos run; the port's service is held to its
values and words bit for bit, its modeled latency and energy to 1e-12
relative, its `stats()` chip keys and its fault-tolerance timeline
exactly.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, strategies as st

from test_torch_vm import _programs

import repro.service as R
from repro.core import bankgroup as rbg
from repro.core import cluster as rcl
from repro.core import compiler as rcomp
from repro.core import engine as reng
from repro.core import lowering as rlow
from repro.dist import elastic as relastic
from repro.dist import sharding as rsharding
from repro.core.arith_compiler import ripple_add_program as r_ripple_add
from repro_torch import service as T
from repro_torch.core import compiler as tcomp
from repro_torch.core import engine as teng
from repro_torch.core import lowering as tlow
from repro_torch.core.arith_compiler import ripple_add_program as t_ripple_add
from repro_torch.core.bitplane import as_words, tail_mask, to_uint32
from repro_torch.core.cluster import (ChipCluster, ClusterError,
                                      cluster_latency_ns,
                                      cluster_throughput_gbps, get_cluster,
                                      tree_psum)
from repro_torch.dist import elastic as telastic
from repro_torch.dist import sharding as tsharding
from repro_torch.dist.fault_tolerance import (ChipFailure, FaultTolerance,
                                              StragglerMonitor)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHIPS = [1, 2, 4, 8]
REL = 1e-12


def _cpu_cluster(n_chips, n_banks=8, max_chips=None):
    return ChipCluster.create(n_chips, n_banks=n_banks, max_chips=max_chips,
                              devices=["cpu"] * n_chips)


def _data(rng, n_words, rows=("D0", "D1")):
    return {r: rng.integers(0, 1 << 32, n_words, dtype=np.uint32)
            for r in rows}


def _assert_rows_equal(want, got):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(to_uint32(got[k]),
                                      np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# rules, layout and construction
# ---------------------------------------------------------------------------


def test_rule_tables_equal_the_reference():
    for name in ("CLUSTER_RULES", "DEFAULT_RULES", "DP_RULES", "SP_RULES",
                 "DECODE_SP_RULES"):
        assert getattr(tsharding, name) == getattr(rsharding, name), name
    assert tsharding.CLUSTER_RULES == {"chip": ("chip",), "bank": ()}


def test_resolve_spec_matches_reference_partition_spec():
    """On the one host device as a real mesh, and on larger meshes the
    reference reads through the same two attributes."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("chip", "model"))
    for shape, names in (((1, 16, 4), ("chip", "bank", None)),
                         ((4, 6), ("batch", "heads")),
                         ((3,), ("mlp",))):
        want = rsharding.resolve_spec(shape, names, mesh,
                                      rsharding.DEFAULT_RULES)
        got = tsharding.resolve_spec(shape, names, {"chip": 1, "model": 1},
                                     tsharding.DEFAULT_RULES)
        assert got == tuple(want), (shape, names)
    rng = np.random.default_rng(0)
    logical = list(tsharding.DEFAULT_RULES) + [None, "unknown"]
    for _ in range(200):
        axes = {"pod": int(rng.choice([1, 2])), "data": int(rng.choice(
            [1, 2, 4])), "model": int(rng.choice([1, 2, 3, 8])),
            "chip": int(rng.choice([1, 2, 4]))}
        fake = types.SimpleNamespace(axis_names=tuple(axes),
                                     devices=np.empty(tuple(axes.values())))
        ndim = int(rng.integers(1, 5))
        shape = tuple(int(d) for d in rng.choice([1, 2, 3, 4, 6, 8, 12, 24],
                                                 ndim))
        names = tuple(logical[int(i)] for i in rng.integers(0, len(logical),
                                                            ndim))
        rules = [tsharding.DEFAULT_RULES, tsharding.SP_RULES,
                 tsharding.DECODE_SP_RULES,
                 tsharding.DP_RULES][int(rng.integers(4))]
        want = rsharding.resolve_spec(shape, names, fake, rules)
        assert tsharding.resolve_spec(shape, names, axes, rules) == \
            tuple(want), (shape, names, axes)


def test_spec_resolves_through_dist_rules():
    for c in CHIPS:
        cl = _cpu_cluster(c, n_banks=2)
        assert cl.spec(3) == ("chip", None, None)
        assert cl.spec(4) == ("chip", None, None, None)
    ref = rcl.ChipCluster.create(1, n_banks=2)
    assert _cpu_cluster(1, n_banks=2).spec(3) == tuple(ref.spec(3))


def test_create_validates_device_count_and_devices():
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ClusterError, match="devices=\\['cpu'\\]"):
        ChipCluster.create(n_cards + 1)
    with pytest.raises(ClusterError, match=">= 1"):
        ChipCluster.create(0, devices=["cpu"])
    with pytest.raises(ClusterError, match="need 3 devices"):
        ChipCluster.create(3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ChipCluster.create(1, devices=["cuda"])
    cl = ChipCluster.create(2, devices=["cpu"] * 4)
    assert cl.devices == (torch.device("cpu"),) * 2


def test_chips_must_divide_placement():
    with pytest.raises(ClusterError, match="divide"):
        ChipCluster(devices=None, n_chips=2, n_banks=2, max_chips=3)
    with pytest.raises(rcl.ClusterError, match="divide"):
        rcl.ChipCluster(mesh=None, n_chips=2, n_banks=2, max_chips=3)


@pytest.mark.parametrize("n_chips", [1, 2, 3, 4, 5, 8])
def test_default_placement_granularity(n_chips):
    cl = _cpu_cluster(n_chips, n_banks=2)
    want = n_chips * int(np.ceil(8 / n_chips))
    assert cl.max_chips == want and cl.sweeps == want // n_chips
    assert cl.local_banks == 2 * cl.sweeps and cl.slots == 2 * want
    if n_chips == 1:
        ref = rcl.ChipCluster.create(1, n_banks=2)
        assert (cl.max_chips, cl.sweeps, cl.local_banks, cl.slots) == \
            (ref.max_chips, ref.sweeps, ref.local_banks, ref.slots)


@pytest.mark.parametrize("n_chips", CHIPS)
def test_slot_contents_match_reference_shard_words(n_chips):
    rng = np.random.default_rng(n_chips)
    cl = _cpu_cluster(n_chips, n_banks=3, max_chips=8)      # 24 slots
    for n_words in (1, 5, 24, 25, 40):
        x = rng.integers(0, 1 << 32, (2, n_words), dtype=np.uint32)
        want = np.asarray(rbg.shard_words(x, cl.slots))     # (slots, 2, w)
        shards = cl.shard_words(x)
        assert len(shards) == n_chips
        for i, s in enumerate(shards):
            assert s.shape == (cl.local_banks, 2, cl.local_words(n_words))
            np.testing.assert_array_equal(
                to_uint32(s), want[i * cl.local_banks:
                                   (i + 1) * cl.local_banks])
        back = cl.unshard_words(shards, n_words)
        np.testing.assert_array_equal(to_uint32(back), x)
        # a tensor is split on its own device, a host array on chip 0's
        t = cl.shard_words(as_words(x, "cpu"))
        assert all(torch.equal(a, b) for a, b in zip(t, shards))


# ---------------------------------------------------------------------------
# sharded execution == the reference's single-chip oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chips", CHIPS)
def test_sharded_execute_matches_reference(n_chips):
    rng = np.random.default_rng(2 + n_chips)
    data = _data(rng, 29)   # uneven: exercises zero-padding on every layout
    want = reng.execute(rcomp.op_program("xor", ["D0", "D1"], "D2"), data,
                        lowered=False)
    cl = _cpu_cluster(n_chips, n_banks=2, max_chips=max(n_chips * 2, 8))
    prog = tcomp.op_program("xor", ["D0", "D1"], "D2")
    _assert_rows_equal(want, cl.execute(prog, data))
    got = cl.execute(prog, data, outputs=["D2"])
    np.testing.assert_array_equal(to_uint32(got["D2"]),
                                  np.asarray(want["D2"]))


@pytest.mark.parametrize("n_chips", [2, 4])
@pytest.mark.parametrize("backend", [None, "torch", "cuda"])
def test_sharded_arith_matches_reference(n_chips, backend):
    rng = np.random.default_rng(3)
    rows = [f"X{j}" for j in range(8)] + [f"Y{j}" for j in range(8)]
    data = _data(rng, 7, rows=rows)
    rres, tres = r_ripple_add(8), t_ripple_add(8)
    want = reng.execute(rres.program, data, outputs=list(rres.outputs),
                        lowered=False)
    cl = _cpu_cluster(n_chips, n_banks=2, max_chips=4)
    got = cl.execute(tres.program, data, outputs=list(tres.outputs),
                     backend=backend)
    _assert_rows_equal(want, got)


@pytest.mark.parametrize("n_chips", CHIPS)
def test_popcounts_tree_psum(n_chips):
    rng = np.random.default_rng(4)
    n_words, n_bits = 11, 11 * 32 - 9
    data = _data(rng, n_words)
    cl = _cpu_cluster(n_chips, n_banks=3, max_chips=8)
    lp = tlow.lower(tcomp.op_program("xor", ["D0", "D1"], "D2"))
    sharded = {k: cl.shard_words(v) for k, v in data.items()}
    mask = cl.shard_words(tail_mask(n_bits))
    counts = cl.popcounts(lp, sharded, ["D2"], mask)
    flat = np.asarray(reng.execute(rcomp.op_program("xor", ["D0", "D1"],
                                                    "D2"),
                                   data, outputs=["D2"])["D2"])
    flat = flat & tail_mask(n_bits)
    expect = int(np.unpackbits(flat.view(np.uint8)).sum())
    assert counts.shape == (1,) and counts.dtype == np.int32
    assert int(counts[0]) == expect
    # the reference's own cluster on its one device: same dtype and count
    rc = rcl.ChipCluster.create(1, n_banks=3, max_chips=8)
    rlp = rlow.lower(rcomp.op_program("xor", ["D0", "D1"], "D2"))
    rsh = {k: rc.shard_words(jax.numpy.asarray(v)) for k, v in data.items()}
    want = rc.popcounts(rlp, rsh, ["D2"],
                        rc.shard_words(jax.numpy.asarray(tail_mask(n_bits))))
    assert counts.dtype == want.dtype and np.array_equal(counts, want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_tree_psum_all_reduces(n):
    xs = [torch.full((2, 3), i + 1, dtype=torch.int32) for i in range(n)]
    out = tree_psum(xs)
    assert len(out) == n
    for o in out:
        assert o.dtype == torch.int32
        assert torch.equal(o, torch.full((2, 3), n * (n + 1) // 2,
                                         dtype=torch.int32))


def test_engine_execute_rejects_interpreter_with_chips():
    rng = np.random.default_rng(5)
    prog = tcomp.op_program("xor", ["D0", "D1"], "D2")
    with pytest.raises(ValueError, match="lowered"):
        teng.execute(prog, _data(rng, 9), n_chips=2, lowered=False,
                     device="cpu")
    with pytest.raises(ValueError, match="row_words"):
        teng.execute(prog, _data(rng, 9), n_chips=2, row_words=9,
                     device="cpu")
    with pytest.raises(ValueError, match="lowered"):
        reng.execute(rcomp.op_program("xor", ["D0", "D1"], "D2"),
                     _data(rng, 9), n_chips=2, lowered=False)


@pytest.mark.parametrize("n_chips", [2, 4, 8])
def test_engine_execute_n_chips_param(n_chips):
    """`engine.execute(n_chips=C)` is the one-shot chips x banks dispatch:
    ``["cpu"] * C`` for rows on the host."""
    rng = np.random.default_rng(5)
    data = _data(rng, 9)
    want = reng.execute(rcomp.op_program("xor", ["D0", "D1"], "D2"), data,
                        outputs=["D2"], lowered=False)
    out = teng.execute(tcomp.op_program("xor", ["D0", "D1"], "D2"), data,
                       outputs=["D2"], n_banks=2, n_chips=n_chips,
                       device="cpu")
    np.testing.assert_array_equal(to_uint32(out["D2"]),
                                  np.asarray(want["D2"]))
    cl = get_cluster(n_chips, 2, device="cpu")
    assert cl is get_cluster(n_chips, 2, device="cpu")
    assert cl.devices == (torch.device("cpu"),) * n_chips


def test_modeled_schedule_matches_reference():
    tprog = tcomp.op_program("xor", ["D0", "D1"], "D2")
    rprog = rcomp.op_program("xor", ["D0", "D1"], "D2")
    total = []
    for blocks in (1, 7, 512):
        for c in CHIPS:
            for banks in (1, 4, 8):
                got = cluster_latency_ns(blocks, c, banks, tprog)
                want = rcl.cluster_latency_ns(blocks, c, banks, rprog)
                for f in ("n_blocks", "n_chips", "n_banks"):
                    assert getattr(got, f) == getattr(want, f)
                for f in ("compute_ns", "reduce_ns", "total_ns"):
                    assert getattr(got, f) == pytest.approx(
                        getattr(want, f), rel=REL)
                assert cluster_throughput_gbps(blocks, c, banks, tprog) == \
                    pytest.approx(rcl.cluster_throughput_gbps(
                        blocks, c, banks, rprog), rel=REL)
                if blocks == 512 and banks == 8:
                    total.append(got.total_ns)
    assert all(a > b for a, b in zip(total, total[1:])), total
    assert total[0] / total[-1] >= 4.0


def test_plan_rescale_matches_reference():
    for g in (8, 16, 24, 64):
        for old in (1, 2, 3, 4, 8):
            for new in (1, 2, 3, 4, 8):
                for acc in (1, 2):
                    try:
                        want = relastic.plan_rescale(g, old, new, acc)
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            telastic.plan_rescale(g, old, new, acc)
                        assert str(got.value) == str(e)
                        continue
                    got = telastic.plan_rescale(g, old, new, acc)
                    assert _plans_equal(got, want)
                    assert got.effective_batch == want.effective_batch == g


def _plans_equal(a, b) -> bool:
    return (a.global_batch, a.per_shard_batch, a.grad_accum,
            a.new_mesh_shards) == (b.global_batch, b.per_shard_batch,
                                   b.grad_accum, b.new_mesh_shards)


# ---------------------------------------------------------------------------
# property: random programs on random layouts
# ---------------------------------------------------------------------------


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=12, deadline=None)
def test_sharded_random_programs_match_oracle(seed):
    rprog, tprog = _programs(seed % 100_000)
    rng = np.random.default_rng(seed)
    n_words = int(rng.integers(1, 40))      # rarely divides the slot grid
    n_data = int(rng.integers(1, 5))
    data = {f"D{i}": rng.integers(0, 1 << 32, n_words, dtype=np.uint32)
            for i in range(n_data)}
    n_chips = int(rng.choice(CHIPS))
    n_banks = int(rng.integers(1, 4))
    max_chips = n_chips * int(rng.integers(1, 4))
    cl = _cpu_cluster(n_chips, n_banks=n_banks, max_chips=max_chips)
    want = reng.execute(rprog, data, lowered=False)
    _assert_rows_equal(want, cl.execute(tprog, data))


# ---------------------------------------------------------------------------
# the distributed service deployment
# ---------------------------------------------------------------------------

N_BITS = 700    # uneven domain: 22 words, tail mask in play


def _service_data():
    rng = np.random.default_rng(7)
    bits = {f"t{t}/{d}": (rng.integers(0, 2, N_BITS), f"t{t}")
            for t in range(2) for d in ("mon", "tue")}
    cols = {c: rng.integers(0, 100, N_BITS) for c in ("age", "spend")}
    return bits, cols


def _build(pkg, data=None, **kw):
    bits, cols = data or _service_data()
    if pkg is T:
        svc = T.QueryService(T.ServiceConfig(n_banks=4, device="cpu", **kw))
    else:
        svc = R.QueryService(R.ServiceConfig(n_banks=4, **kw))
    for name, (b, group) in bits.items():
        svc.register_bits(name, b, group=group)
    for name, values in cols.items():
        svc.register_column(name, values, 7, group="cols")
    return svc


def _queries(pkg):
    return [pkg.Query("t0/mon & t0/tue"),
            pkg.Query("t1/mon | t1/tue ^ t0/mon"),
            pkg.Query("age < 30 & t0/mon"),
            pkg.Query("sum(age)"),
            pkg.Query("age + spend"),
            pkg.Query("t0/mon | t1/tue", mode=pkg.MATERIALIZE),
            pkg.Query("age + spend", mode=pkg.MATERIALIZE)]


def _assert_reports_equal(want, got):
    assert (got.n_chips, got.n_banks, got.n_plan_groups) == \
        (want.n_chips, want.n_banks, want.n_plan_groups)
    assert got.makespan_ns == pytest.approx(want.makespan_ns, rel=REL)
    assert len(got.results) == len(want.results)
    for a, b in zip(want.results, got.results):
        assert (b.index, b.mode, b.scalar, b.bank, b.chip, b.n_aaps) == \
            (a.index, a.mode, a.scalar, a.bank, a.chip, a.n_aaps)
        assert b.latency_ns == pytest.approx(a.latency_ns, rel=REL)
        assert b.energy_nj == pytest.approx(a.energy_nj, rel=REL)
        va, vb = np.asarray(a.value), np.asarray(b.value)
        assert vb.dtype == va.dtype and np.array_equal(va, vb)


@pytest.mark.parametrize("n_chips", CHIPS)
def test_service_distributed_bit_identical(n_chips):
    data = _service_data()
    base = _build(T, data)
    dist = _build(T, data, n_chips=n_chips)
    r0 = base.query_batch(_queries(T))
    r1 = dist.query_batch(_queries(T))
    assert T.results_bit_identical(r0.results, r1.results)
    ru = T.run_queries_unbatched(base.catalog, _queries(T))
    assert T.results_bit_identical(r1.results, ru.results)
    assert r1.n_chips == n_chips and dist.stats()["n_chips"] == n_chips
    # the reference's single-process service serves the same values
    ref = _build(R, data).query_batch(_queries(R))
    assert R.results_bit_identical(ref.results, r1.results)
    if n_chips == 1:    # the reference's one-chip deployment, in-process
        _assert_reports_equal(
            _build(R, data, n_chips=1).query_batch(_queries(R)), r1)


def test_service_records_chip_placement():
    svc = _build(T, n_chips=2)
    for name in svc.catalog.names():
        pl = svc.catalog.placement(name)
        assert pl is not None and pl.n_chips == 2
        assert pl.slots == pl.n_chips * pl.local_banks == 32
        assert pl.local_words == 1 and pl.chip_of_slot(17) == 1
        assert len(svc.catalog.shards(name)) == 2
    pls = {svc.catalog.placement(n) for n in ("t0/mon", "t0/tue")}
    assert len(pls) == 1
    assert svc.catalog.placement("t0/mon") != \
        svc.catalog.placement("age.b0")
    mask = svc.catalog.mask_shards()
    np.testing.assert_array_equal(
        to_uint32(svc.cluster.unshard_words(mask, 22)),
        tail_mask(N_BITS))


def test_multichip_service_faster_modeled():
    data = _service_data()
    r0 = _build(T, data).query_batch(_queries(T))
    r1 = _build(T, data, n_chips=2).query_batch(_queries(T))
    assert r1.makespan_ns < r0.makespan_ns


def test_rescale_requires_distributed_and_preservable_layout():
    svc = _build(T)
    with pytest.raises(ValueError, match="n_chips"):
        svc.rescale(2)
    svc = _build(T, n_chips=1, max_chips=8)
    with pytest.raises(ValueError, match="not preservable"):
        svc.rescale(3)
    assert svc.n_chips == 1


def test_reliability_refused_with_a_cluster():
    from repro_torch.core.errors import ReliabilityConfig

    with pytest.raises(ValueError, match="chip granularity"):
        T.QueryService(T.ServiceConfig(
            device="cpu", n_chips=2,
            reliability=ReliabilityConfig(mode="vote")))


def test_rescale_preserves_catalog_and_results():
    svc = _build(T, n_chips=1, max_chips=4)
    svc.materialize("both", "t0/mon & t0/tue", group="t0")
    r_before = svc.query_batch(_queries(T))
    before = {n: to_uint32(svc.catalog.get(n).words)
              for n in svc.catalog.names()}
    for chips in (2, 4, 1):
        plan = svc.rescale(chips)
        assert plan.new_mesh_shards == chips
        assert plan.grad_accum == svc.cluster.sweeps
        assert sorted(svc.catalog.names()) == sorted(before)
        for n, words in before.items():
            np.testing.assert_array_equal(
                to_uint32(svc.catalog.get(n).words), words)
            gathered = svc.cluster.unshard_words(svc.catalog.shards(n),
                                                 words.shape[0])
            np.testing.assert_array_equal(to_uint32(gathered), words)
            assert svc.catalog.placement(n).n_chips == chips
        r_after = svc.query_batch(_queries(T))
        assert T.results_bit_identical(r_before.results, r_after.results)
        assert svc.stats()["n_chips"] == chips
        assert svc.stats()["chip_sweeps"] == 4 // chips


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=6, deadline=None)
def test_rescale_chain_preserves_every_vector(seed):
    rng = np.random.default_rng(seed)
    n_bits = int(rng.integers(40, 400))
    svc = T.QueryService(T.ServiceConfig(
        n_banks=int(rng.integers(1, 4)), device="cpu", n_chips=1,
        max_chips=8))
    names = [f"v{i}" for i in range(int(rng.integers(2, 6)))]
    for n in names:
        svc.register_bits(n, rng.integers(0, 2, n_bits),
                          group=f"g{int(rng.integers(2))}")
    before = {n: to_uint32(svc.catalog.get(n).words) for n in names}
    q = [T.Query(f"{names[0]} & {names[-1]}"), T.Query(names[0])]
    r0 = svc.query_batch(list(q))
    for chips in (2, 4, 8, 1, 2):
        svc.rescale(chips)
        for n in names:
            gathered = svc.cluster.unshard_words(svc.catalog.shards(n),
                                                 before[n].shape[0])
            np.testing.assert_array_equal(to_uint32(gathered), before[n])
        r = svc.query_batch(list(q))
        assert T.results_bit_identical(r0.results, r.results), chips
    ru = T.run_queries_unbatched(svc.catalog, list(q))
    assert T.results_bit_identical(r0.results, ru.results)


def test_tracing_spans_and_psum_hops():
    from repro_torch.obs import Telemetry

    svc = _build(T, n_chips=4, telemetry=Telemetry(trace=True))
    svc.query_batch(_queries(T))
    events = svc.telemetry.tracer.events
    names = {e["name"] for e in events}
    assert {"cluster.popcounts", "cluster.run_lowered", "psum_hop"} <= names
    hops = [e for e in events if e["name"] == "cluster.popcounts"]
    assert all(e["args"]["psum_hops"] == 2 for e in hops)
    assert all(e["args"]["backend"] == "torch" for e in hops)


# ---------------------------------------------------------------------------
# one subprocess: the reference's distributed service on 8 forced devices
# ---------------------------------------------------------------------------

_STAT_KEYS = ("n_chips", "chip_sweeps", "chip_rescales", "replays",
              "failures", "stragglers", "queries_served", "batches",
              "plan_cache_hits", "plan_cache_misses")

_REF_RUN = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import numpy as np
import repro.service as R
from repro.dist.fault_tolerance import (ChipFailure, FaultTolerance,
                                        StragglerMonitor)
from test_torch_cluster import (_STAT_KEYS, _build, _chaos_build,
                                _chaos_queries, _queries, _report_json,
                                _service_data)

data = _service_data()
out = {{}}
svc = _build(R, data, n_chips=2, max_chips=8)
out["c2"] = _report_json(svc.query_batch(_queries(R)))
plan = svc.rescale(4)
out["c2_rescale4"] = _report_json(svc.query_batch(_queries(R)))
out["c2_rescale4_plan"] = [plan.per_shard_batch, plan.grad_accum]
out["c2_stats"] = {{k: svc.stats()[k] for k in _STAT_KEYS}}
svc = _build(R, data, n_chips=4, max_chips=8)
out["c4"] = _report_json(svc.query_batch(_queries(R)))
ft = FaultTolerance(max_replays=2, monitor=StragglerMonitor(threshold=1e9))
armed = {{"live": True}}
def inject(g):
    if g == 2 and armed["live"]:
        armed["live"] = False
        raise ChipFailure(3)
ft.failure_injector = inject
svc = _chaos_build(R, n_chips=4, fault_tolerance=ft)
out["chaos"] = _report_json(svc.query_batch(_chaos_queries(R)))
out["chaos_again"] = _report_json(svc.query_batch(_chaos_queries(R)))
out["chaos_timeline"] = list(ft.timeline)
out["chaos_stats"] = {{k: svc.stats()[k] for k in _STAT_KEYS}}
print("REF_JSON " + json.dumps(out))
"""


def _report_json(rep):
    return {"makespan_ns": rep.makespan_ns, "n_chips": rep.n_chips,
            "n_plan_groups": rep.n_plan_groups,
            "results": [{"value": np.asarray(r.value).tolist(),
                         "scalar": int(r.scalar),
                         "latency_ns": r.latency_ns,
                         "energy_nj": r.energy_nj, "bank": r.bank,
                         "chip": r.chip, "n_aaps": r.n_aaps}
                        for r in rep.results]}


def _chaos_build(pkg, **kw):
    rng = np.random.default_rng(2)
    if pkg is T:
        svc = T.QueryService(T.ServiceConfig(n_banks=8, device="cpu",
                                             max_chips=8, **kw))
    else:
        svc = R.QueryService(R.ServiceConfig(n_banks=8, max_chips=8, **kw))
    for n in "abcd":
        svc.register_bits(n, rng.integers(0, 2, 700).astype(bool),
                          group="t0")
    return svc


def _chaos_queries(pkg):
    return [pkg.Query("a & b"), pkg.Query("a | c & ~d"),
            pkg.Query("(a ^ b) | (c & d)"),
            pkg.Query("~a & d", mode=pkg.MATERIALIZE)]


def _assert_json_equal(want, got):
    assert (got["n_chips"], got["n_plan_groups"]) == \
        (want["n_chips"], want["n_plan_groups"])
    assert got["makespan_ns"] == pytest.approx(want["makespan_ns"], rel=REL)
    assert len(got["results"]) == len(want["results"])
    for a, b in zip(want["results"], got["results"]):
        assert (b["value"], b["scalar"], b["bank"], b["chip"],
                b["n_aaps"]) == (a["value"], a["scalar"], a["bank"],
                                 a["chip"], a["n_aaps"])
        assert b["latency_ns"] == pytest.approx(a["latency_ns"], rel=REL)
        assert b["energy_nj"] == pytest.approx(a["energy_nj"], rel=REL)


@pytest.fixture(scope="module")
def reference_distributed():
    code = _REF_RUN.format(src=os.path.join(REPO, "src"),
                           tests=os.path.join(REPO, "tests"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=REPO)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("REF_JSON ")]
    assert lines, r.stderr[-3000:]
    return json.loads(lines[-1][len("REF_JSON "):])


def test_distributed_service_matches_reference_subprocess(
        reference_distributed):
    ref = reference_distributed
    data = _service_data()
    svc = _build(T, data, n_chips=2, max_chips=8)
    _assert_json_equal(ref["c2"], _report_json(svc.query_batch(_queries(T))))
    plan = svc.rescale(4)
    assert [plan.per_shard_batch, plan.grad_accum] == ref["c2_rescale4_plan"]
    _assert_json_equal(ref["c2_rescale4"],
                       _report_json(svc.query_batch(_queries(T))))
    assert {k: svc.stats()[k] for k in _STAT_KEYS} == ref["c2_stats"]
    svc = _build(T, data, n_chips=4, max_chips=8)
    _assert_json_equal(ref["c4"], _report_json(svc.query_batch(_queries(T))))

    ft = FaultTolerance(max_replays=2,
                        monitor=StragglerMonitor(threshold=1e9))
    armed = {"live": True}

    def inject(g):
        if g == 2 and armed["live"]:
            armed["live"] = False
            raise ChipFailure(3)

    ft.failure_injector = inject
    svc = _chaos_build(T, n_chips=4, fault_tolerance=ft)
    _assert_json_equal(ref["chaos"],
                       _report_json(svc.query_batch(_chaos_queries(T))))
    _assert_json_equal(ref["chaos_again"],
                       _report_json(svc.query_batch(_chaos_queries(T))))
    assert ft.timeline == ref["chaos_timeline"] == [
        "failure@group2:ChipFailure", "rescale@4->2", "replay@group2"]
    assert {k: svc.stats()[k] for k in _STAT_KEYS} == ref["chaos_stats"]
    assert svc.n_chips == 2
