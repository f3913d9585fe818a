"""Port parity: the fused bitwise, popcount and BitWeaving-scan kernels'
wrappers and the direct ops over them, on the CPU.

Inputs are drawn with numpy from fixed seeds and go through the JAX
package's `repro.kernels.ops` (its Pallas kernels in interpret mode, with
small ``block_rows=8, block_cols=128`` blocks as `tests/test_kernels.py`
runs them) and through the port's wrappers, which run their plain
versions for CPU tensors. Words must match bit for bit. Popcounts are
compared as values: the reference returns int32, the port int64. Also
the direct ops (`repro_torch.ops`) with ``banks=``, and the device rules
of the port's entry points."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rkops
from repro.kernels import ref as rref
from repro.ops import bitwise as rbw
from repro.ops import predicate as rpred
import repro_torch.ops as tops
from repro_torch.apps.bitmap_index import UserDatabase
from repro_torch.convert import catalog_from_reference
from repro_torch.core import bankgroup as tbg
from repro_torch.core import compiler as tcomp
from repro_torch.core import engine as teng
from repro_torch.core import errors as terr
from repro_torch.core import lowering as tlow
from repro_torch.core.errors import ReliabilityConfig
from repro_torch.core.bitplane import as_words, to_uint32
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bitweaving import bitweaving_scan_kernel
from repro_torch.kernels.bitwise import banked_bitwise_kernel, bitwise_kernel
from repro_torch.kernels.popcount import popcount_kernel
from repro_torch.ops.transpose import to_vertical
from repro_torch.service import Catalog, QueryService

OPS = ["and", "or", "xor", "nand", "nor", "xnor", "andnot", "not", "maj3"]
ARITY = {"not": 1, "maj3": 3}
SHAPES = [(1, 128), (3, 100), (9, 300)]
BLOCKS = dict(block_rows=8, block_cols=128)


def _words(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def _operands(op, shape, seed):
    rng = np.random.default_rng(seed)
    return [_words(rng, *shape) for _ in range(ARITY.get(op, 2))]


def _np_popcount(x):
    return int(np.unpackbits(np.asarray(x, np.uint32).view(np.uint8)).sum())


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")


# ---------------------------------------------------------------------------
# kernel wrappers against the reference's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", OPS)
def test_bitwise_kernel_matches_reference(op, shape):
    args = _operands(op, shape, 7 * len(op) + shape[0])
    want = np.asarray(rkops.bitwise(op, *args, **BLOCKS))
    got = bitwise_kernel(op, *(as_words(a) for a in args))
    assert got.shape == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(to_uint32(got), want)
    np.testing.assert_array_equal(
        to_uint32(tkops.bitwise(op, *(as_words(a) for a in args))), want)


@pytest.mark.parametrize("op", OPS)
def test_bitwise_1d_matches_reference(op):
    args = _operands(op, (301,), 11)
    want = np.asarray(rkops.bitwise(op, *args))
    got = tkops.bitwise(op, *(as_words(a) for a in args))
    assert got.shape == (301,)
    np.testing.assert_array_equal(to_uint32(got), want)


@pytest.mark.parametrize("banks", [1, 3, 8])
@pytest.mark.parametrize("op", OPS)
def test_bitwise_banked_matches_reference(op, banks):
    """1-D operands of 97 words: every bank count but 1 pads, and
    not / nand / nor / xnor drive the pad words to ones."""
    args = _operands(op, (97,), 13 + banks)
    want = np.asarray(rkops.bitwise_banked(op, *args, n_banks=banks))
    got = tkops.bitwise_banked(op, *(as_words(a) for a in args),
                               n_banks=banks)
    assert got.shape == (97,)
    np.testing.assert_array_equal(to_uint32(got), want)
    np.testing.assert_array_equal(want, np.asarray(rref.bitwise(op, *args)))


@pytest.mark.parametrize("banks", [2, 5])
def test_bitwise_banked_2d_matches_reference(banks):
    args = _operands("maj3", (3, 50), 17)
    want = np.asarray(rkops.bitwise_banked("maj3", *args, n_banks=banks))
    got = tkops.bitwise_banked("maj3", *(as_words(a) for a in args),
                               n_banks=banks)
    np.testing.assert_array_equal(to_uint32(got), want)


def test_banked_kernel_is_elementwise_over_banks():
    a, b = _operands("xor", (4, 2, 33), 19)
    got = banked_bitwise_kernel("xor", as_words(a), as_words(b))
    np.testing.assert_array_equal(to_uint32(got), a ^ b)


@pytest.mark.parametrize("shape", [(8, 128), (1, 1), (5, 300), (13, 300)])
def test_popcount_matches_reference(shape):
    x = _words(np.random.default_rng(shape[0] * shape[1]), *shape)
    want = int(rkops.popcount(x, **BLOCKS))
    got = popcount_kernel(as_words(x))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want == _np_popcount(x)
    assert int(tkops.popcount(as_words(x).reshape(-1))) == want


@pytest.mark.parametrize("fill", [0, 0xFFFFFFFF])
def test_popcount_extremes(fill):
    x = np.full((8, 128), fill, np.uint32)
    assert int(tkops.popcount(as_words(x))) == int(rkops.popcount(x)) \
        == (8 * 128 * 32 if fill else 0)


SCAN_CASES = {
    "inside": lambda n: (3 * (1 << n) // 16, 11 * (1 << n) // 16),
    "lo_above_hi": lambda n: (((1 << n) - 1), 0),
    "hi_past_range": lambda n: ((1 << n) // 3, (1 << n) + 5),
    "extra_planes": lambda n: ((1 << n) // 5, (1 << n) // 2),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
@pytest.mark.parametrize("n_bits", [1, 7, 12, 32])
def test_bitweaving_scan_matches_reference(n_bits, case):
    rng = np.random.default_rng(n_bits * 100 + len(case))
    b = n_bits + (3 if case == "extra_planes" else 0)
    planes = _words(rng, b, 96)
    lo, hi = SCAN_CASES[case](n_bits)
    want = np.asarray(rkops.bitweaving_scan(planes, lo, hi, n_bits,
                                            block_cols=128))
    got = bitweaving_scan_kernel(as_words(planes), lo, hi, n_bits)
    np.testing.assert_array_equal(to_uint32(got), want)
    np.testing.assert_array_equal(
        to_uint32(tref.bitweaving_scan(as_words(planes), lo, hi, n_bits)),
        np.asarray(rref.bitweaving_scan(jnp.asarray(planes), lo, hi,
                                        n_bits)))


def test_cpu_wrappers_run_plain_versions_without_launching():
    before = dict(LAUNCHES)
    a, b = (as_words(x) for x in _operands("and", (2, 40), 23))
    tkops.bitwise("and", a, b)
    tkops.bitwise_banked("nand", a, b, n_banks=3)
    tkops.popcount(a)
    tkops.bitweaving_scan(a, 1, 2, 2)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("bad", ["op", "arity", "shape", "dtype", "ndim"])
def test_bitwise_kernel_rejects_bad_operands(bad):
    a, b = (as_words(x) for x in _operands("and", (2, 40), 29))
    args = {"op": ("nope", a, b), "arity": ("and", a),
            "shape": ("and", a, b[:, :39]),
            "dtype": ("and", a, b.to(torch.int64)),
            "ndim": ("and", a[0], b[0])}[bad]
    with pytest.raises(ValueError):
        bitwise_kernel(*args)


def test_scan_kernel_rejects_too_few_planes():
    with pytest.raises(ValueError):
        bitweaving_scan_kernel(as_words(np.zeros((3, 4), np.uint32)), 0, 1, 4)


# ---------------------------------------------------------------------------
# the direct ops (`repro_torch.ops`)
# ---------------------------------------------------------------------------

OP_FUNCS = {"and": "bitwise_and", "or": "bitwise_or", "xor": "bitwise_xor",
            "not": "bitwise_not", "nand": "bitwise_nand",
            "nor": "bitwise_nor", "xnor": "bitwise_xnor", "maj3": "majority3",
            "andnot": "andnot"}


@pytest.mark.parametrize("banks", [1, 3])
@pytest.mark.parametrize("op", OPS)
def test_direct_ops_match_reference(op, banks):
    args = _operands(op, (1001,), 31 + banks)
    name = OP_FUNCS[op]
    want = np.asarray(getattr(rbw, name)(*args, banks=banks))
    got = getattr(tops, name)(*args, banks=banks, device="cpu")
    assert got.device.type == "cpu" and got.shape == (1001,)
    np.testing.assert_array_equal(to_uint32(got), want)
    # tensors keep their device with no device= given
    again = getattr(tops, name)(*(as_words(a) for a in args), banks=banks)
    assert torch.equal(again, got)


@pytest.mark.parametrize("n,n_bits,lo,hi", [(1000, 7, 20, 90),
                                            (32 * 40 + 3, 12, 500, 2500),
                                            (77, 32, 1 << 30, 3 << 30),
                                            (65, 5, 9, 1 << 9)])
def test_between_scan_and_column_scan_match_reference(n, n_bits, lo, hi):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1 << n_bits, n, dtype=np.uint64).astype(np.uint32)
    rcol = rpred.VerticalColumn.encode(jnp.asarray(vals), n_bits)
    tcol = tops.VerticalColumn.encode(vals, n_bits, device="cpu")
    np.testing.assert_array_equal(
        to_uint32(tops.between_scan(tcol.planes, lo, hi, n_bits)),
        np.asarray(rpred.between_scan(rcol.planes, lo, hi, n_bits)))
    want = rcol.scan(lo, hi)
    got = tcol.scan(lo, hi)
    assert got.n_bits == want.n_bits == n
    np.testing.assert_array_equal(to_uint32(got.words),
                                  np.asarray(want.words))
    count = tops.scan_count(vals, n_bits, lo, hi, device="cpu")
    assert int(count) == int(rpred.scan_count(jnp.asarray(vals), n_bits, lo,
                                              hi))
    # bits of the bounds at or above n_bits are never read
    lo_n, hi_n = lo % (1 << n_bits), hi % (1 << n_bits)
    assert int(count) == int(((vals >= lo_n) & (vals <= hi_n)).sum())


# ---------------------------------------------------------------------------
# device rules of the entry points
# ---------------------------------------------------------------------------


def _reference_catalog():
    import repro.service as R

    svc = R.QueryService(R.ServiceConfig(n_banks=2))
    svc.register("a", np.arange(4, dtype=np.uint32), 128, group="g")
    return svc.catalog


_HOST_ROWS = {"D0": np.ones(8, np.uint32), "D1": np.arange(8, dtype=np.uint32)}
_XOR = tcomp.op_program("xor", ["D0", "D1"], "D2")
_FAULTS = terr.TRAErrorModel(p_flip=0.1)

ENTRY_POINTS = {
    "bitwise_and": lambda **kw: tops.bitwise_and(
        np.ones(8, np.uint32), np.ones(8, np.uint32), **kw),
    "majority3": lambda **kw: tops.majority3(*[np.ones(8, np.uint32)] * 3,
                                             banks=2, **kw),
    "scan_count": lambda **kw: tops.scan_count(np.arange(40), 6, 3, 9, **kw),
    "BitSet": lambda **kw: tops.BitSet.from_elements([1, 5], 64, **kw),
    "BitSet.empty": lambda **kw: tops.BitSet.empty(64, **kw),
    "to_vertical": lambda **kw: to_vertical(np.arange(64), 6, **kw),
    "from_vertical": lambda **kw: tops.from_vertical(
        np.arange(12, dtype=np.uint32).reshape(6, 2), 6, **kw),
    "VerticalColumn.encode": lambda **kw: tops.VerticalColumn.encode(
        np.arange(40), 6, **kw),
    "UserDatabase.synthetic": lambda **kw: UserDatabase.synthetic(
        100, 1, **kw),
    "engine.execute": lambda **kw: teng.execute(_XOR, _HOST_ROWS, **kw),
    "engine.execute_n_banks": lambda **kw: teng.execute(
        _XOR, _HOST_ROWS, n_banks=3, **kw),
    "execute_banked": lambda **kw: tbg.execute_banked(
        _XOR, _HOST_ROWS, 3, reduce="popcount", **kw),
    "shard_words": lambda **kw: tbg.shard_words(np.ones(8, np.uint32), 3,
                                                **kw),
    "BankGroup.create": lambda **kw: tbg.BankGroup.create(3, 8, **kw),
    "BankGroup.from_flat": lambda **kw: tbg.BankGroup.from_flat(
        3, _HOST_ROWS, **kw),
    "execute_injected": lambda **kw: terr.execute_injected(
        tlow.lower(_XOR), _HOST_ROWS, ["D2"], model=_FAULTS, **kw),
    "execute_voted": lambda **kw: terr.execute_voted(
        tlow.lower(_XOR), _HOST_ROWS, ["D2"], model=_FAULTS, **kw),
    "execute_ecc": lambda **kw: terr.execute_ecc(
        tlow.lower(_XOR), _HOST_ROWS, ["D2"], model=_FAULTS, **kw),
    "QueryService": QueryService,
    "QueryService(reliability=)": lambda **kw: QueryService(
        reliability=ReliabilityConfig(mode="vote"), **kw),
    "Catalog": Catalog,
    "catalog_from_reference": lambda **kw: catalog_from_reference(
        _reference_catalog(), **kw),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_asked(no_card, entry):
    """Without a card the default device raises instead of running on the
    CPU; ``device="cpu"`` runs the plain versions."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()
    ENTRY_POINTS[entry](device="cpu")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_use_kernel_must_agree_with_the_device(use_kernel):
    a = as_words(np.arange(64, dtype=np.uint32))
    if use_kernel:
        with pytest.raises(ValueError, match="use_kernel"):
            tops.bitwise_xor(a, a, use_kernel=True)
        with pytest.raises(ValueError, match="use_kernel"):
            tops.between_scan(a.reshape(2, 32), 1, 2, 2, use_kernel=True)
    else:
        assert torch.equal(tops.bitwise_xor(a, a, use_kernel=False),
                           torch.zeros_like(a))


def test_operands_on_different_devices_raise():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        tops.bitwise_and(a, torch.zeros(8, dtype=torch.int32,
                                        device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tops.bitwise_and(a, a, device="meta")
