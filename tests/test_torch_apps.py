"""Port parity: the paper's §8 applications on the CPU.

§8.1 bitmap indices on a database drawn by the JAX package and carried
across with `convert.user_database_from_reference`; §8.2 BitWeaving scans;
§8.3 `BitSet` and the set algebra through the service; and every cost
model function. Inputs are drawn with numpy from fixed seeds (or by the
reference from a fixed key). Words and counts must match bit for bit
(counts as values: the reference's are int32, the port's int64); modeled
ns and speedups to 1e-12 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import bitmap_index as rbi
from repro.apps import bitset as rbs
from repro.apps import bitweaving as rbw
from repro.apps import cost as rcost
from repro.ops import predicate as rpred
from repro.ops.setops import BitSet as RBitSet
from repro_torch import convert
from repro_torch.apps import DEFAULT_APP_SYSTEM, AppSystem
from repro_torch.apps import bitmap_index as tbi
from repro_torch.apps import bitset as tbs
from repro_torch.apps import bitweaving as tbw
from repro_torch.core.bitplane import to_uint32
from repro_torch.ops.setops import BitSet as TBitSet

REL = 1e-12


# ---------------------------------------------------------------------------
# §8.1 bitmap indices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m_users,n_weeks", [(1000, 1), (4099, 3),
                                             (3000, 4)])
def test_weekly_active_query_matches_reference(m_users, n_weeks):
    rdb = rbi.UserDatabase.synthetic(jax.random.PRNGKey(m_users), m_users,
                                     n_weeks)
    tdb = convert.user_database_from_reference(rdb, device="cpu")
    assert tdb.m_users == m_users and tdb.daily.device.type == "cpu"
    np.testing.assert_array_equal(to_uint32(tdb.daily), np.asarray(rdb.daily))
    r_every, r_male, r_ops = rbi.weekly_active_query(rdb)
    t_every, t_male, t_ops = tbi.weekly_active_query(tdb)
    assert t_ops == r_ops
    assert int(t_every) == int(r_every)
    assert t_male.tolist() == np.asarray(r_male).tolist()
    # the same answers served by the port's query service
    s_every, s_male, stats = tbi.weekly_active_query_service(tdb)
    assert s_every == int(r_every)
    assert s_male.tolist() == t_male.tolist()
    assert stats["queries_served"] == n_weeks + 1


def test_weekly_active_query_service_matches_reference_service():
    rdb = rbi.UserDatabase.synthetic(jax.random.PRNGKey(3), 2048 + 17, 2)
    tdb = convert.user_database_from_reference(rdb, device="cpu")
    r_every, r_male, r_stats = rbi.weekly_active_query_service(rdb)
    t_every, t_male, t_stats = tbi.weekly_active_query_service(tdb)
    assert t_every == r_every
    assert t_male.tolist() == np.asarray(r_male).tolist()
    assert set(t_stats) == set(r_stats)
    for key in r_stats:
        if key == "total_energy_nj":
            assert t_stats[key] == pytest.approx(r_stats[key], rel=REL)
        else:
            assert t_stats[key] == r_stats[key], key


def test_synthetic_database_is_seeded_and_masked():
    """The port draws its own bits (not the reference's `jax.random`):
    same generator seed, same database; no bit past m_users is set."""
    a = tbi.UserDatabase.synthetic(1000, 2, generator=torch.Generator()
                                   .manual_seed(5), device="cpu")
    b = tbi.UserDatabase.synthetic(1000, 2, generator=torch.Generator()
                                   .manual_seed(5), device="cpu")
    assert a.daily.shape == (2, 7, 32) and a.male.shape == (32,)
    assert torch.equal(a.daily, b.daily) and torch.equal(a.male, b.male)
    tail = to_uint32(a.daily)[..., -1] >> np.uint32(1000 - 31 * 32)
    assert not tail.any()
    density = np.unpackbits(to_uint32(a.daily).view(np.uint8)).mean()
    assert 0.2 < density < 0.4


@pytest.mark.parametrize("m_users,n_weeks", [(1 << 20, 4), (1 << 24, 4),
                                             (7777, 1)])
def test_bitmap_query_time_model_matches_reference(m_users, n_weeks):
    for use_buddy in (False, True):
        assert tbi.query_time_ns(m_users, n_weeks, use_buddy) == \
            pytest.approx(rbi.query_time_ns(m_users, n_weeks, use_buddy),
                          rel=REL)
    assert tbi.speedup(m_users, n_weeks) == pytest.approx(
        rbi.speedup(m_users, n_weeks), rel=REL)


# ---------------------------------------------------------------------------
# §8.2 BitWeaving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,n_bits,c1,c2", [(1000, 4, 3, 11),
                                            (32 * 50 + 7, 12, 500, 2500),
                                            (999, 32, 1 << 29, 3 << 30),
                                            (64, 8, 200, 100)])
def test_scan_query_matches_reference(n, n_bits, c1, c2):
    rng = np.random.default_rng(n + n_bits)
    vals = rng.integers(0, 1 << n_bits, n, dtype=np.uint64).astype(np.uint32)
    r_count, r_bv = rbw.scan_query(jnp.asarray(vals), n_bits, c1, c2)
    t_count, t_bv = tbw.scan_query(vals, n_bits, c1, c2, device="cpu")
    assert int(t_count) == int(r_count) == int(((vals >= c1)
                                                & (vals <= c2)).sum())
    assert t_bv.n_bits == r_bv.n_bits == n
    np.testing.assert_array_equal(to_uint32(t_bv.words),
                                  np.asarray(r_bv.words))


def test_vertical_column_from_reference_scans_alike():
    vals = np.random.default_rng(1).integers(0, 1 << 10, 1000,
                                             dtype=np.uint32)
    rcol = rpred.VerticalColumn.encode(jnp.asarray(vals), 10)
    tcol = convert.vertical_column_from_reference(rcol, device="cpu")
    assert (tcol.n_bits, tcol.n_values) == (10, 1000)
    np.testing.assert_array_equal(to_uint32(tcol.scan(100, 700).words),
                                  np.asarray(rcol.scan(100, 700).words))


@pytest.mark.parametrize("c1,c2,n_bits", [(0, 0, 1), (5, 9, 4), (500, 2500, 12),
                                          (1 << 30, 3 << 30, 32)])
def test_buddy_ops_per_plane_matches_reference(c1, c2, n_bits):
    assert tbw.buddy_ops_per_plane(c1, c2, n_bits) == \
        rbw.buddy_ops_per_plane(c1, c2, n_bits)


@pytest.mark.parametrize("r_rows", [1 << 10, 1 << 20, 1 << 25])
@pytest.mark.parametrize("n_bits", [1, 12, 32])
def test_scan_time_model_matches_reference(r_rows, n_bits):
    c1, c2 = (1 << n_bits) // 4, 3 * (1 << n_bits) // 4
    for use_buddy in (False, True):
        assert tbw.scan_time_ns(r_rows, n_bits, c1, c2, use_buddy) == \
            pytest.approx(rbw.scan_time_ns(r_rows, n_bits, c1, c2,
                                           use_buddy), rel=REL)
    assert tbw.speedup(r_rows, n_bits) == pytest.approx(
        rbw.speedup(r_rows, n_bits), rel=REL)


def test_speedup_grid_matches_reference():
    want, got = rbw.speedup_grid(), tbw.speedup_grid()
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=REL), key


# ---------------------------------------------------------------------------
# §8.3 bitvector sets
# ---------------------------------------------------------------------------


def _sets(seed, k=3, domain=1 << 10, size=100):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, domain, size) for _ in range(k)], domain


@pytest.mark.parametrize("banks", [1, 3])
@pytest.mark.parametrize("op", ["union", "intersection", "difference"])
def test_bitset_merges_match_reference(op, banks):
    elems, domain = _sets(banks + len(op), size=300)
    rsets = [RBitSet.from_elements(jnp.asarray(e), domain) for e in elems]
    tsets = [TBitSet.from_elements(e, domain, device="cpu") for e in elems]
    want = getattr(rsets[0], op)(*rsets[1:], banks=banks)
    got = getattr(tsets[0], op)(*tsets[1:], banks=banks)
    np.testing.assert_array_equal(to_uint32(got.bits.words),
                                  np.asarray(want.bits.words))
    assert int(got.cardinality()) == int(want.cardinality())
    assert got.to_elements().tolist() == np.asarray(
        want.to_elements()).tolist()


def test_bitset_insert_contains_match_reference():
    elems, domain = _sets(9, k=1, size=40)
    r = RBitSet.from_elements(jnp.asarray(elems[0]), domain)
    t = TBitSet.from_elements(elems[0], domain, device="cpu")
    for e in (31, 63, 0, 1023, 500):     # bit 31 of a word is negative
        r, t = r.insert(e), t.insert(e)
    np.testing.assert_array_equal(to_uint32(t.bits.words),
                                  np.asarray(r.bits.words))
    for e in range(0, domain, 7):
        assert int(t.contains(e)) == int(r.contains(e))
    assert int(t.contains(31)) == 1
    empty = TBitSet.empty(domain, device="cpu")
    assert int(empty.cardinality()) == 0 and empty.domain == domain


def test_bitset_from_elements_is_duplicate_safe():
    t = TBitSet.from_elements([5, 5, 5, 31, 31, 0], 64, device="cpu")
    r = RBitSet.from_elements(jnp.asarray([5, 5, 5, 31, 31, 0]), 64)
    np.testing.assert_array_equal(to_uint32(t.bits.words),
                                  np.asarray(r.bits.words))
    assert t.to_elements().tolist() == [0, 5, 31]


@pytest.mark.parametrize("op", ["union", "intersection", "difference"])
def test_setop_via_service_matches_reference(op):
    elems, domain = _sets(len(op), k=4, domain=(1 << 12) + 5, size=900)
    r_res, r_q, r_ref = rbs.setop_via_service(elems, domain, op)
    t_res, t_q, t_ref = tbs.setop_via_service(elems, domain, op,
                                              device="cpu")
    np.testing.assert_array_equal(to_uint32(t_res.bits.words),
                                  np.asarray(r_res.bits.words))
    np.testing.assert_array_equal(to_uint32(t_ref.bits.words),
                                  np.asarray(r_ref.bits.words))
    assert torch.equal(t_res.bits.words, t_ref.bits.words)
    assert (t_q.scalar, t_q.n_aaps) == (r_q.scalar, r_q.n_aaps)
    with pytest.raises(ValueError, match="unknown set op"):
        tbs.setop_via_service(elems, domain, "xor", device="cpu")


@pytest.mark.parametrize("k_sets", [2, 15])
def test_figure12_grid_matches_reference(k_sets):
    want = rbs.figure12_grid(k_sets)
    got = tbs.figure12_grid(k_sets)
    assert set(got) == set(want)
    for m in want:
        for field in ("rbtree_ns", "bitset_ns", "buddy_ns",
                      "buddy_vs_rbtree", "buddy_vs_bitset"):
            assert getattr(got[m], field) == pytest.approx(
                getattr(want[m], field), rel=REL), (m, field)


@pytest.mark.parametrize("domain", [1 << 10, 1 << 19, (1 << 21) + 3])
def test_setop_cost_functions_match_reference(domain):
    assert tbs.rbtree_setop_ns(15, 1024) == pytest.approx(
        rbs.rbtree_setop_ns(15, 1024), rel=REL)
    assert tbs.bitset_setop_ns(15, domain) == pytest.approx(
        rbs.bitset_setop_ns(15, domain), rel=REL)
    assert tbs.buddy_setop_ns(15, domain) == pytest.approx(
        rbs.buddy_setop_ns(15, domain), rel=REL)


# ---------------------------------------------------------------------------
# the shared cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["and", "or", "xor", "not", "copy", "nand"])
@pytest.mark.parametrize("n_bits", [1024, 1 << 20, (1 << 24) + 1])
def test_app_system_matches_reference(op, n_bits):
    t, r = DEFAULT_APP_SYSTEM, rcost.DEFAULT_APP_SYSTEM
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for dependent in (True, False):
        assert t.buddy_op_ns(op, n_bits, dependent) == pytest.approx(
            r.buddy_op_ns(op, n_bits, dependent), rel=REL)
    if op != "copy":
        assert t.cpu_bitwise_ns(op, n_bits) == pytest.approx(
            r.cpu_bitwise_ns(op, n_bits), rel=REL)
    for streaming in (False, True):
        for resident in (False, True):
            assert t.cpu_bitcount_ns(n_bits, streaming, resident) == \
                pytest.approx(r.cpu_bitcount_ns(n_bits, streaming,
                                                resident), rel=REL)
    assert AppSystem(banks=4).buddy_op_ns(op, n_bits) == pytest.approx(
        rcost.AppSystem(banks=4).buddy_op_ns(op, n_bits), rel=REL)

