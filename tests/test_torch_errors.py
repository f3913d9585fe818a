"""Port parity: TRA reliability — the majority kernel's wrapper, the error
model, fault-injected and mitigated execution, the catalog's parity planes
and the service's vote / ECC modes, on the CPU.

Inputs are drawn with numpy from fixed seeds. The majority wrapper is held
to the JAX package's `repro.kernels.ops.majority` (its Pallas kernel in
interpret mode, small blocks) for thresholds in ``1..k``, and to the
reference's oracle `repro.kernels.ref.majority_k` for thresholds past
either edge (the reference kernel compares only the low
``ceil(log2(k+1))`` bits of the threshold). The port does not reproduce
`jax.random`'s bits: where both packages must see the same faults, the
port's draw is replaced (`monkeypatch`) by the reference's `error_planes`
under the same key chain, ``PRNGKey(seed)`` folded with each element of
the port's key tuple. The port's own draw is tested for its flip rate per
class against a binomial bound, for zeros off the TRA commands, and for
determinism per key."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.service as R
import repro_torch.service as T
from repro.core import compiler as rcomp
from repro.core import errors as rerr
from repro.core import lowering as rlow
from repro.kernels import ops as rkops
from repro.kernels import ref as rref
from repro_torch.core import compiler as tcomp
from repro_torch.core import errors as terr
from repro_torch.core import lowering as tlow
from repro_torch.core.bitplane import as_words, to_uint32
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ops as tkops
from repro_torch.kernels.majority import majority_kernel
from repro_torch.ops.popcount import popcount_u32

BLOCKS = dict(block_rows=8, block_cols=128)
KS = [1, 2, 3, 4, 5, 7, 15, 31]
REL = 1e-12


def _words(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


# ---------------------------------------------------------------------------
# the majority kernel's wrapper
# ---------------------------------------------------------------------------


def _thresholds(k):
    return {"default": None, "one": 1, "k": k, "zero": 0, "k+1": k + 1,
            "negative": -3}


@pytest.mark.parametrize("case", ["default", "one", "k", "zero", "k+1",
                                  "negative"])
@pytest.mark.parametrize("k", KS)
def test_majority_kernel_matches_reference(k, case):
    threshold = _thresholds(k)[case]
    rng = np.random.default_rng(100 * k + len(case))
    planes = _words(rng, k, 3, 100)          # ragged: 100 % 128 != 0
    got = majority_kernel(as_words(planes), threshold)
    assert got.shape == (3, 100) and got.dtype == torch.int32
    oracle = np.asarray(rref.majority_k(planes, threshold))
    np.testing.assert_array_equal(to_uint32(got), oracle)
    if threshold is None or 1 <= threshold <= k:
        want = np.asarray(rkops.majority(planes, threshold, **BLOCKS))
        np.testing.assert_array_equal(to_uint32(got), want)
    if case == "zero":
        assert (to_uint32(got) == 0xFFFFFFFF).all()
    if case == "k+1":
        assert (to_uint32(got) == 0).all()


@pytest.mark.parametrize("k", [3, 5])
def test_majority_wrapper_takes_flat_planes(k):
    rng = np.random.default_rng(k)
    planes = _words(rng, k, 77)
    got = tkops.majority(as_words(planes))
    assert got.shape == (77,)
    np.testing.assert_array_equal(
        to_uint32(got), np.asarray(rkops.majority(planes, **BLOCKS)))


def test_majority_rejects_bad_operands():
    with pytest.raises(ValueError, match="int32"):
        majority_kernel(torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        majority_kernel(torch.zeros((3, 1, 4), dtype=torch.int64))


# ---------------------------------------------------------------------------
# the error model
# ---------------------------------------------------------------------------


def _expr(seed):
    r = np.random.default_rng(seed)
    leaves = [f"D{i}" for i in range(5)]

    def build(E):
        e = E.of(leaves[0])
        for _ in range(6):
            a = E.of(leaves[int(r.integers(5))])
            op = ["and", "or", "xor", "maj3"][int(r.integers(4))]
            e = E("maj3", (e, a, E.of(leaves[int(r.integers(5))]))) \
                if op == "maj3" else E(op, (e, a))
        return e

    state = r.bit_generator.state
    re = build(rcomp.Expr)
    r.bit_generator.state = state
    te = build(tcomp.Expr)
    return re, te


def _lowered(seed):
    re, te = _expr(seed)
    rlp = rlow.lower(rcomp.compile_expr_fused(re, "OUT").program)
    tlp = tlow.lower(tcomp.compile_expr_fused(te, "OUT").program)
    assert np.array_equal(np.asarray(rlp.table), tlp.table)
    return rlp, tlp


MODELS = [dict(p_flip=1e-3), dict(p_flip=0.2, row_sigma=1.5),
          dict(p_flip=0.05, temperature_c=85.0, temp_coeff=0.05,
               pattern_scale=(0.1, 0.7, 1.0, 0.2))]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kw", range(len(MODELS)))
def test_flip_probs_and_row_factors_match_reference(seed, kw):
    _, tlp = _lowered(seed)
    rm, tm = rerr.TRAErrorModel(**MODELS[kw]), terr.TRAErrorModel(
        **MODELS[kw])
    np.testing.assert_array_equal(tm.row_factors(tlp.table),
                                  rm.row_factors(tlp.table))
    got, want = tm.flip_probs(tlp.table), rm.flip_probs(tlp.table)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_model_validates_like_the_reference():
    for bad in (dict(p_flip=1.5), dict(p_flip=-0.1),
                dict(pattern_scale=(1.0, 1.0))):
        with pytest.raises(ValueError):
            terr.TRAErrorModel(**bad)
    with pytest.raises(ValueError, match="mode"):
        terr.ReliabilityConfig(mode="tmr")
    with pytest.raises(ValueError, match="odd"):
        terr.ReliabilityConfig(mode="vote", k=4)


@pytest.mark.parametrize("p_flip", [0.02, 0.4, 1.0])
def test_error_planes_flip_each_class_at_its_rate(p_flip):
    """Empirical flips per (command, class) against a 6-sigma binomial
    bound; the 1.0 case draws past half the bits (the complement path)."""
    _, tlp = _lowered(3)
    model = terr.TRAErrorModel(p_flip=p_flip, row_sigma=0.3)
    batch, words = (3,), 40
    gen = terr.fault_generator((11, 2, 0), torch.device("cpu"))
    e = terr.error_planes(tlp.table, gen, batch, words, model)
    assert e.shape == (tlp.n_cmds, 4) + batch + (words,)
    assert e.dtype == torch.int32
    flips = popcount_u32(e).sum(dim=(2, 3)).numpy()
    n = 3 * words * 32
    p = model.flip_probs(tlp.table).astype(np.float64)
    tra = (tlp.table[:, 0] & tlow.KIND_TRA) != 0
    assert tra.any() and (~tra).any()
    assert (flips[~tra] == 0).all()
    sigma = np.sqrt(n * p * (1 - p))
    assert (np.abs(flips - n * p) <= 6 * sigma + 1).all()
    assert flips[tra].sum() > 0


def test_error_planes_deterministic_per_key_and_zero_at_rate0():
    _, tlp = _lowered(1)
    model = terr.TRAErrorModel(p_flip=0.05)
    cpu = torch.device("cpu")

    def draw(key):
        return terr.error_planes(tlp.table, terr.fault_generator(key, cpu),
                                 (2,), 17, model)

    assert torch.equal(draw((5, 0, 1)), draw((5, 0, 1)))
    assert not torch.equal(draw((5, 0, 1)), draw((5, 0, 2)))
    assert not torch.equal(draw((5, 0, 1)), draw((6, 0, 1)))
    zero = terr.error_planes(tlp.table, None, (2,), 17,
                             terr.TRAErrorModel(p_flip=0.0), cpu)
    assert zero.shape == (tlp.n_cmds, 4, 2, 17) and not zero.any()


def test_fault_planes_default_to_the_card():
    """With neither a device nor a generator, both fault-plane builders
    put their planes on ``"cuda"`` (raising without a card), as every
    other entry point does; a generator's device is kept."""
    _, tlp = _lowered(1)
    model = terr.TRAErrorModel(p_flip=0.05)
    gen = terr.fault_generator((1,), torch.device("cpu"))
    assert terr.error_planes(tlp.table, gen, (2,), 17,
                             model).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        terr.error_planes(tlp.table, None, (2,), 17,
                          terr.TRAErrorModel(p_flip=0.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        terr.single_fault_planes(tlp.table, (2,), 9, 0, 4, 31)


@pytest.mark.parametrize("cmd", [0, 1, 2, 3, 4])
def test_single_fault_planes_match_reference(cmd):
    rlp, tlp = _lowered(2)
    cmd = cmd % tlp.n_cmds
    want = np.asarray(rerr.single_fault_planes(rlp.table, (2,), 9, cmd, 4,
                                               31))
    got = terr.single_fault_planes(tlp.table, (2,), 9, cmd, 4, 31,
                                   device="cpu")
    np.testing.assert_array_equal(to_uint32(got), want)


# ---------------------------------------------------------------------------
# injected / voted / ECC execution with the reference's fault planes
# ---------------------------------------------------------------------------


def _reference_key(key):
    k = jax.random.PRNGKey(int(key[0]))
    for x in key[1:]:
        k = jax.random.fold_in(k, int(x))
    return k


@pytest.fixture
def reference_draws(monkeypatch):
    """Make the port draw the reference's fault planes: its generator
    becomes the key tuple itself, and `error_planes` maps that tuple onto
    the reference's key chain."""
    monkeypatch.setattr(terr, "fault_generator", lambda key, device: key)

    def planes(table, key, batch, row_words, model, device=None):
        rm = rerr.TRAErrorModel(**dataclasses.asdict(model))
        return as_words(np.asarray(rerr.error_planes(
            table, _reference_key(key), batch, row_words, rm)), device)

    monkeypatch.setattr(terr, "error_planes", planes)


def _data(seed, batch=(), words=40):
    rng = np.random.default_rng(seed)
    return {f"D{i}": _words(rng, *batch, words) for i in range(5)}


def _assert_dicts_equal(want, got, names):
    for o in names:
        np.testing.assert_array_equal(to_uint32(got[o]), np.asarray(want[o]))


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("seed", range(3))
def test_execute_injected_matches_reference(reference_draws, seed, batch):
    rlp, tlp = _lowered(seed)
    data = _data(seed, batch)
    kw = dict(p_flip=0.05)
    want = rerr.execute_injected(rlp, data, ["OUT"], backend="scan",
                                 model=rerr.TRAErrorModel(**kw),
                                 key=jax.random.PRNGKey(seed))
    got = terr.execute_injected(tlp, data, ["OUT"], backend="torch",
                                model=terr.TRAErrorModel(**kw), key=(seed,), device="cpu")
    _assert_dicts_equal(want, got, ["OUT"])
    clean = tlow.execute_lowered(tlp, data, outputs=["OUT"], backend="torch")
    assert not torch.equal(got["OUT"], clean["OUT"])


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("seed", range(3))
def test_execute_voted_matches_reference(reference_draws, seed, k):
    rlp, tlp = _lowered(seed)
    data = _data(seed + 10, (2,))
    r_stats, t_stats = {}, {}
    want = rerr.execute_voted(rlp, data, ["OUT"], backend="scan",
                              model=rerr.TRAErrorModel(p_flip=0.03),
                              key=jax.random.PRNGKey(seed), k=k,
                              stats_out=r_stats)
    before = LAUNCHES["majority"]
    got = terr.execute_voted(tlp, data, ["OUT"], backend="torch",
                             model=terr.TRAErrorModel(p_flip=0.03),
                             key=(seed,), k=k, stats_out=t_stats,
                             device="cpu")
    assert LAUNCHES["majority"] == before      # the CPU runs the plain vote
    _assert_dicts_equal(want, got, ["OUT"])
    assert t_stats == r_stats
    assert t_stats["corrected_bits"] > 0


@pytest.mark.parametrize("p_flip", [0.0, 1e-7, 0.2])
def test_execute_ecc_matches_reference(reference_draws, p_flip):
    """Rate 0 and 1e-7 agree on two replicas; 0.2 needs the tie-break."""
    rlp, tlp = _lowered(5)
    data = _data(7, (2,))
    r_stats, t_stats = {}, {}
    want, r_n = rerr.execute_ecc(rlp, data, ["OUT"], backend="scan",
                                 model=rerr.TRAErrorModel(p_flip=p_flip),
                                 key=jax.random.PRNGKey(3),
                                 stats_out=r_stats)
    got, t_n = terr.execute_ecc(tlp, data, ["OUT"], backend="torch",
                                model=terr.TRAErrorModel(p_flip=p_flip),
                                key=(3,), stats_out=t_stats, device="cpu")
    _assert_dicts_equal(want, got, ["OUT"])
    assert (t_n, t_stats) == (r_n, r_stats)
    assert t_n == (3 if p_flip == 0.2 else 2)


def test_vote_outputs_match_reference():
    rng = np.random.default_rng(4)
    reps = [{"A": _words(rng, 3, 50), "B": _words(rng, 50)}
            for _ in range(5)]
    want = rerr.vote_outputs(reps, ["A", "B"])
    got = terr.vote_outputs([{k: as_words(v) for k, v in r.items()}
                             for r in reps], ["A", "B"])
    _assert_dicts_equal(want, got, ["A", "B"])


def test_vote_corrects_faults_confined_to_one_replica():
    """A one-bit fault in one replica of three changes nothing."""
    _, tlp = _lowered(0)
    data = _data(3, (2,))
    clean = tlow.execute_lowered(tlp, data, outputs=["OUT"],
                                 backend="torch")["OUT"]
    tra = [i for i in range(tlp.n_cmds)
           if tlp.table[i, 0] & tlow.KIND_TRA]
    faulty = tlow.execute_lowered(
        tlp, data, outputs=["OUT"], backend="torch",
        errors=terr.single_fault_planes(tlp.table, (2,), 40, tra[-1], 7,
                                        3, device="cpu"))["OUT"]
    assert not torch.equal(faulty, clean)
    voted = terr.vote_outputs([{"OUT": clean}, {"OUT": faulty},
                               {"OUT": clean}], ["OUT"])
    assert torch.equal(voted["OUT"], clean)


# ---------------------------------------------------------------------------
# catalog parity planes
# ---------------------------------------------------------------------------


def _catalogs():
    rng = np.random.default_rng(1)
    r, t = R.Catalog(), T.Catalog(device="cpu")
    for name, group in (("u", "g0"), ("v", "g0"), ("w", None)):
        bits = rng.integers(0, 2, 100).astype(bool)
        r.register_bits(name, bits, group=group)
        t.register_bits(name, torch.from_numpy(bits), group=group)
    return r, t


def test_catalog_parity_planes_match_reference():
    r, t = _catalogs()
    for g in ("g0", None):
        np.testing.assert_array_equal(to_uint32(t.parity_plane(g)),
                                      np.asarray(r.parity_plane(g)))
    assert t.verify_parity() and r.verify_parity()
    with pytest.raises(T.CatalogError):
        t.parity_plane("nope")


def test_catalog_parity_detects_corruption():
    _, t = _catalogs()
    entry = t.get("v")
    entry.words = entry.words ^ (1 << 9)       # flip one stored bit
    assert not t.verify_parity()
    _, t = _catalogs()
    t.get("w").words[0] ^= 1                   # in place, too
    assert not t.verify_parity()


# ---------------------------------------------------------------------------
# the service's reliability modes
# ---------------------------------------------------------------------------

QUERIES = ["a & b", "a | c & ~d", "(a ^ b) | (c & d)"]


def _service(pkg, rel=None, **kw):
    rng = np.random.default_rng(7)
    if pkg is T:
        kw["device"] = "cpu"
    svc = pkg.QueryService(n_banks=4, reliability=rel, **kw)
    for n in "abcd":
        svc.register_bits(n, rng.integers(0, 2, 300).astype(bool),
                          group="t0")
    return svc


def _rel(pkg, mode, p_flip, seed=0, k=3):
    errs = rerr if pkg is R else terr
    return errs.ReliabilityConfig(mode=mode, k=k, seed=seed,
                                  model=errs.TRAErrorModel(p_flip=p_flip))


@pytest.fixture(scope="module")
def clean():
    svc = _service(T)
    return svc, [svc.query(q) for q in QUERIES]


@pytest.mark.parametrize("mode", ["vote", "ecc"])
def test_mitigated_modes_bit_identical_at_rate0(mode, clean):
    _, want = clean
    svc = _service(T, _rel(T, mode, 0.0))
    assert [svc.query(q).value for q in QUERIES] == [r.value for r in want]
    if mode == "ecc":
        assert svc.scheduler.parity_checks == len(QUERIES)
        assert svc.stats()["parity_checks"] == len(QUERIES)
        assert svc.stats()["reliability_replicas"] == 2 * len(QUERIES)
        assert svc.stats()["ecc_tiebreaks"] == 0


def test_vote_corrects_low_rate_faults(clean):
    _, want = clean
    svc = _service(T, _rel(T, "vote", 1e-4, seed=7))
    assert [svc.query(q).value for q in QUERIES] == [r.value for r in want]


def test_vote_charges_latency_and_energy_like_the_reference(clean):
    base, _ = clean
    svc = _service(T, _rel(T, "vote", 0.0))
    ref = _service(R, _rel(R, "vote", 0.0))
    for q in QUERIES:
        c, v, r = base.query(q), svc.query(q), ref.query(q)
        assert v.latency_ns > c.latency_ns
        assert v.energy_nj == pytest.approx(3 * c.energy_nj, rel=REL)
        assert v.latency_ns == r.latency_ns
        assert v.energy_nj == pytest.approx(r.energy_nj, rel=REL)
        assert (v.value, v.n_aaps, v.bank) == (r.value, r.n_aaps, r.bank)


def test_ecc_detects_corrupted_catalog():
    svc = _service(T, _rel(T, "ecc", 0.0))
    entry = svc.catalog.get("b")
    entry.words = entry.words ^ 1
    with pytest.raises(RuntimeError, match="parity"):
        svc.query("a & b")


def test_parity_counter_without_metering():
    from repro_torch.obs import NULL_TELEMETRY

    svc = _service(T, _rel(T, "ecc", 0.0), telemetry=NULL_TELEMETRY)
    svc.query("a & b")
    svc.query_batch([T.Query(q) for q in QUERIES])
    assert svc.stats()["parity_checks"] == 2 == svc.scheduler.parity_checks


SPEC = dict(n_tenants=2, n_weeks=2, domain_bits=1 << 11, n_queries=24)


@pytest.mark.parametrize("mode,p_flip", [("vote", 0.02), ("ecc", 0.02),
                                         ("ecc", 0.0)])
def test_stream_under_mitigation_matches_reference(reference_draws, mode,
                                                   p_flip):
    """The §8 stream (boolean, scan and arithmetic plans) under vote and
    ECC with the reference's fault planes: results, modeled ns, nJ, AAPs
    and the reliability counters equal the reference service's."""
    ref = R.build_service(R.WorkloadSpec(**SPEC),
                          reliability=_rel(R, mode, p_flip, seed=3))
    svc = T.build_service(T.WorkloadSpec(**SPEC), device="cpu",
                          reliability=_rel(T, mode, p_flip, seed=3))
    rq = R.query_stream(R.WorkloadSpec(**SPEC), ref)
    tq = T.query_stream(T.WorkloadSpec(**SPEC), svc)
    rq += [R.Query("t1/col + t1/col2", R.MATERIALIZE, "t1")]
    tq += [T.Query("t1/col + t1/col2", T.MATERIALIZE, "t1")]
    rrep, trep = ref.query_batch(rq), svc.query_batch(tq)
    assert trep.n_plan_groups == rrep.n_plan_groups
    assert trep.makespan_ns == rrep.makespan_ns
    assert (trep.total_aaps, trep.n_cse_planes) == (rrep.total_aaps, 0)
    for a, b in zip(rrep.results, trep.results):
        assert (b.scalar, b.bank, b.n_aaps, b.latency_ns) == \
            (a.scalar, a.bank, a.n_aaps, a.latency_ns)
        assert b.energy_nj == pytest.approx(a.energy_nj, rel=REL)
        assert np.array_equal(np.asarray(a.value), np.asarray(b.value))
    rs, ts = ref.stats(), svc.stats()
    for key in ("parity_checks", "reliability_replicas", "ecc_tiebreaks",
                "tra_corrected_bits", "batches"):
        assert ts[key] == rs[key], key
    assert ts["total_energy_nj"] == pytest.approx(rs["total_energy_nj"],
                                                  rel=REL)
    if p_flip:
        assert ts["tra_corrected_bits"] > 0
    if mode == "ecc":
        assert ts["parity_checks"] == 1
        assert (ts["ecc_tiebreaks"] > 0) == (p_flip > 0)


def test_stream_under_own_draws_equals_clean_and_is_deterministic():
    """The port's own draws: a vote over faults at 1e-5 serves the clean
    answers, and the same seed corrects the same bits twice."""
    clean = T.build_service(T.WorkloadSpec(**SPEC), device="cpu")
    want = [r.scalar for r in clean.query_batch(
        T.query_stream(T.WorkloadSpec(**SPEC), clean)).results]
    runs = []
    for _ in range(2):
        svc = T.build_service(T.WorkloadSpec(**SPEC), device="cpu",
                              reliability=_rel(T, "vote", 1e-5, seed=5))
        rep = svc.query_batch(T.query_stream(T.WorkloadSpec(**SPEC), svc))
        assert [r.scalar for r in rep.results] == want
        runs.append(svc.stats()["tra_corrected_bits"])
    assert runs[0] == runs[1] > 0


def test_reliability_config_type_is_checked():
    with pytest.raises(TypeError, match="ReliabilityConfig"):
        T.QueryService(T.ServiceConfig(device="cpu", reliability=object()))
    svc = T.QueryService(T.ServiceConfig(
        device="cpu", reliability=terr.ReliabilityConfig(mode="vote")))
    assert svc.scheduler.reliability.mode == "vote"
