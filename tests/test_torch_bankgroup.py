"""Port parity: bank-parallel execution (`core.bankgroup`) on the CPU.

Mirrors `tests/test_bankgroup.py` at ``W = 96`` words (not a multiple of
every bank count, so most bank counts pad). Operands are drawn with numpy
from fixed seeds and go through the JAX package's `repro.core.bankgroup`
and the port's; rows, counts and shards must match bit for bit, modeled
ns and GB/s to 1e-12 relative. Banked counts are held to numpy popcounts
of the reference's banked rows (the reference's own fused counts equal
those in its suite)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bankgroup as rbg
from repro.core import compiler as rcomp
from repro.core import engine as reng
from repro_torch.core import bankgroup as tbg
from repro_torch.core import compiler as tcomp
from repro_torch.core import engine as teng
from repro_torch.core.bitplane import as_words, to_uint32

W = 96
BANKS = [1, 2, 3, 5, 7, 8]
REL = 1e-12


def _rows(n, seed, shape=(W,)):
    rng = np.random.default_rng(seed)
    return {f"D{i}": rng.integers(0, 1 << 32, shape, dtype=np.uint32)
            for i in range(n)}


def _cpu(data):
    return {k: as_words(v, "cpu") for k, v in data.items()}


def _popcount(x):
    return int(np.unpackbits(np.asarray(x, np.uint32).view(np.uint8)).sum())


@pytest.mark.parametrize("banks", BANKS)
def test_shard_roundtrip_matches_reference(banks):
    x = np.random.default_rng(banks).integers(0, 1 << 32, (2, W),
                                              dtype=np.uint32)
    want = np.asarray(rbg.shard_words(x, banks))
    got = tbg.shard_words(x, banks, device="cpu")
    assert got.is_contiguous()
    np.testing.assert_array_equal(to_uint32(got), want)
    np.testing.assert_array_equal(to_uint32(tbg.unshard_words(got, W)), x)


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("op", ["and", "xor", "nand", "andnot", "not"])
def test_banked_matches_reference(op, banks):
    srcs = ["D0"] if op == "not" else ["D0", "D1"]
    data = _rows(len(srcs), 3 * banks + len(op))
    want = rbg.execute_banked(rcomp.op_program(op, srcs, "D2"), data, banks,
                              outputs=["D2"])["D2"]
    got = tbg.execute_banked(tcomp.op_program(op, srcs, "D2"), _cpu(data),
                             banks, outputs=["D2"])["D2"]
    assert got.shape == (W,)
    np.testing.assert_array_equal(to_uint32(got), np.asarray(want))


def _fused(pkg):
    a, b, c = (pkg.Expr.of(f"D{i}") for i in range(3))
    return pkg.compile_expr_fused((a & b) | (b & c) | (c & a) ^ ~a,
                                  "OUT").program


@pytest.mark.parametrize("banks", BANKS)
def test_banked_fused_expression_matches_reference(banks):
    data = _rows(3, 40 + banks)
    want = rbg.execute_banked(_fused(rcomp), data, banks,
                              outputs=["OUT"])["OUT"]
    got = tbg.execute_banked(_fused(tcomp), _cpu(data), banks,
                             outputs=["OUT"])["OUT"]
    np.testing.assert_array_equal(to_uint32(got), np.asarray(want))
    single = teng.execute(_fused(tcomp), _cpu(data), outputs=["OUT"])["OUT"]
    assert torch.equal(got, single)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("banks", BANKS)
def test_banked_popcount_reduce(banks, with_mask):
    """nand drives every pad word to ones: the base mask must keep them
    out of the count, with and without a caller's mask."""
    data = _rows(2, 60 + banks)
    mask = np.random.default_rng(banks).integers(0, 1 << 32, W,
                                                 dtype=np.uint32)
    rows = np.asarray(rbg.execute_banked(
        rcomp.op_program("nand", ["D0", "D1"], "D2"), data, banks,
        outputs=["D2"])["D2"])
    want = _popcount(rows & mask if with_mask else rows)
    got = tbg.execute_banked(tcomp.op_program("nand", ["D0", "D1"], "D2"),
                             _cpu(data), banks, outputs=["D2"],
                             reduce="popcount",
                             mask=mask if with_mask else None)["D2"]
    assert int(got) == want
    agg = tbg.execute_banked(tcomp.op_program("nand", ["D0", "D1"], "D2"),
                             _cpu(data), banks, outputs=["D2"],
                             reduce="aggregate",
                             mask=mask if with_mask else None)
    assert float(agg) == float(want)


def test_banked_reduce_needs_the_lowered_vm():
    with pytest.raises(ValueError, match="lowered"):
        tbg.execute_banked(tcomp.op_program("and", ["D0", "D1"], "D2"),
                           _cpu(_rows(2, 1)), 2, reduce="popcount",
                           lowered=False)


@pytest.mark.parametrize("banks", BANKS)
def test_engine_execute_n_banks_matches_reference(banks):
    data = _rows(2, 80 + banks)
    want = reng.execute(rcomp.op_program("xor", ["D0", "D1"], "D2"), data,
                        outputs=["D2"], n_banks=banks)["D2"]
    got = teng.execute(tcomp.op_program("xor", ["D0", "D1"], "D2"),
                       _cpu(data), outputs=["D2"], n_banks=banks)["D2"]
    np.testing.assert_array_equal(to_uint32(got), np.asarray(want))


@pytest.mark.parametrize("banks", [2, 3, 8])
def test_banked_interpreter_matches_reference(banks):
    data = _rows(3, 90 + banks)
    want = rbg.execute_banked(_fused(rcomp), data, banks, outputs=["OUT"],
                              lowered=False)["OUT"]
    got = tbg.execute_banked(_fused(tcomp), _cpu(data), banks,
                             outputs=["OUT"], lowered=False)["OUT"]
    np.testing.assert_array_equal(to_uint32(got), np.asarray(want))


@pytest.mark.parametrize("lowered", [True, False])
def test_batched_rows_match_reference(lowered):
    """(2, W) operand rows: the bank axis leads, the batch axis follows,
    and the built-in (B, W) rows broadcast per bank."""
    data = _rows(3, 99, shape=(2, W))
    want = rbg.execute_banked(_fused(rcomp), data, 3, outputs=["OUT"],
                              lowered=lowered)["OUT"]
    got = tbg.execute_banked(_fused(tcomp), _cpu(data), 3, outputs=["OUT"],
                             lowered=lowered)["OUT"]
    assert got.shape == (2, W)
    np.testing.assert_array_equal(to_uint32(got), np.asarray(want))


@pytest.mark.parametrize("lowered", [True, False])
def test_bankgroup_state_isolation_matches_reference(lowered):
    """Each bank computes on its slice only; sources stay as they were."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, (4, 8), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (4, 8), dtype=np.uint32)
    rgrp = rbg.BankGroup.create(4, 8, {"D0": a, "D1": b})
    tgrp = tbg.BankGroup.create(4, 8, {"D0": as_words(a), "D1": as_words(b)})
    rout = rgrp.run(rcomp.op_program("and", ["D0", "D1"], "D2"),
                    lowered=lowered)
    tout = tgrp.run(tcomp.op_program("and", ["D0", "D1"], "D2"),
                    lowered=lowered)
    np.testing.assert_array_equal(to_uint32(tout.read("D2")), a & b)
    np.testing.assert_array_equal(to_uint32(tout.read("D2")),
                                  np.asarray(rout.read("D2")))
    np.testing.assert_array_equal(to_uint32(tout.read("D0")), a)
    np.testing.assert_array_equal(to_uint32(tout.gather("D2")),
                                  np.asarray(rout.gather("D2")))


def test_bankgroup_from_flat_and_gather_match_reference():
    data = _rows(2, 7)
    rgrp = rbg.BankGroup.from_flat(5, data)
    tgrp = tbg.BankGroup.from_flat(5, _cpu(data))
    assert (tgrp.n_banks, tgrp.row_words) == (rgrp.n_banks, rgrp.row_words)
    prog = "xnor"
    rout = rgrp.run(rcomp.op_program(prog, ["D0", "D1"], "D2"))
    tout = tgrp.run(tcomp.op_program(prog, ["D0", "D1"], "D2"))
    np.testing.assert_array_equal(to_uint32(tout.gather("D2", W)),
                                  np.asarray(rout.gather("D2", W)))


def test_bankgroup_rejects_unsharded_rows():
    with pytest.raises(ValueError, match="shard"):
        tbg.BankGroup.create(4, 8, {"D0": np.zeros((2, 8), np.uint32)},
                             device="cpu")


@pytest.mark.parametrize("banks", [1, 2, 4, 8, 64])
@pytest.mark.parametrize("op", ["xor", "and", "maj3"])
def test_pipeline_schedule_matches_reference(op, banks):
    srcs = ["D0", "D1", "D2"] if op == "maj3" else ["D0", "D1"]
    rprog = rcomp.op_program(op, srcs, "D3")
    tprog = tcomp.op_program(op, srcs, "D3")
    want = rbg.pipeline_latency_ns(64, banks, rprog)
    got = tbg.pipeline_latency_ns(64, banks, tprog)
    assert (got.n_blocks, got.n_banks) == (want.n_blocks, want.n_banks)
    for field in ("copy_ns", "compute_ns", "total_ns", "serial_ns"):
        assert getattr(got, field) == pytest.approx(getattr(want, field),
                                                    rel=REL), field
    assert tbg.banked_throughput_gbps(256, banks, tprog) == pytest.approx(
        rbg.banked_throughput_gbps(256, banks, rprog), rel=REL)
    x = tbg.pipeline_latency_ns(8, banks, tprog, xfer_ns_per_block=3.5)
    y = rbg.pipeline_latency_ns(8, banks, rprog, xfer_ns_per_block=3.5)
    assert x.total_ns == pytest.approx(y.total_ns, rel=REL)


@pytest.mark.parametrize("n_blocks,n_banks", [(0, 3), (7, 3), (64, 8),
                                              (5, 8)])
def test_partition_blocks_matches_reference(n_blocks, n_banks):
    assert tbg.partition_blocks(n_blocks, n_banks) == \
        rbg.partition_blocks(n_blocks, n_banks)


def test_banked_ops_keep_pad_words_out():
    """bitwise_not / nand over 97 words at 8 banks: the 7 pad words turn
    to ones inside the banks and must not reach the result."""
    from repro_torch import ops as tops

    a = np.random.default_rng(97).integers(0, 1 << 32, 97, dtype=np.uint32)
    got = tops.bitwise_not(a, banks=8, device="cpu")
    assert got.shape == (97,)
    np.testing.assert_array_equal(to_uint32(got), ~a)
    np.testing.assert_array_equal(
        to_uint32(tops.bitwise_nand(a, a, banks=8, device="cpu")), ~a)
    assert np.asarray(jnp.asarray(rbg.shard_words(a, 8))).shape == (8, 13)
