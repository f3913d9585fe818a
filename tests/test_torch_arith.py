"""Port parity: bit-serial arithmetic and the inverse bit transpose, on the
CPU.

Inputs are drawn with numpy from fixed seeds and go through the JAX
package (`repro.kernels.ops` with its Pallas kernels in interpret mode and
small blocks, and `repro.ops`) and through the port, whose wrappers run
their plain versions for CPU tensors. Planes, values, predicate words and
sums must match bit for bit: the add / sub / lt kernels' wrappers at 1, 7,
8 and 32 bits, ragged widths and several rows; the untranspose with fewer
than 32 planes, ragged group counts and the round trip through the bit
transpose; the ten `ops` functions and `from_vertical` at a few thousand
values (one count not a multiple of 32), `lt_const` past both bounds and
the in-DRAM twins at 1, 3 and 8 banks."""
import numpy as np
import pytest
import torch

import repro.ops as R
import repro_torch.ops as T
from repro.kernels import ops as rkops
from repro_torch.core.bitplane import as_words, to_uint32
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ops as tkops
from repro_torch.kernels.arith import bitserial_add_kernel
from repro_torch.kernels.bittranspose import bit_untranspose_kernel

BLOCKS = dict(block_rows=8, block_cols=128)
WIDTHS = [1, 7, 8, 32]
SHAPES = [(100,), (3, 100)]      # flat planes, and 3 rows of a ragged width


def _words(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


# ---------------------------------------------------------------------------
# kernel wrappers against the reference's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sub", [False, True])
@pytest.mark.parametrize("n_bits", WIDTHS)
def test_bitserial_add_matches_reference(n_bits, sub, shape):
    rng = np.random.default_rng(n_bits * 10 + sub + len(shape))
    a, b = _words(rng, n_bits, *shape), _words(rng, n_bits, *shape)
    want = np.asarray(rkops.bitserial_add(a, b, sub, **BLOCKS))
    got = tkops.bitserial_add(as_words(a), as_words(b), sub=sub)
    assert got.shape == a.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(to_uint32(got), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_bits", WIDTHS)
def test_bitserial_lt_matches_reference(n_bits, shape):
    rng = np.random.default_rng(n_bits + 5 * len(shape))
    a, b = _words(rng, n_bits, *shape), _words(rng, n_bits, *shape)
    b[:, ..., :7] = a[:, ..., :7]                 # some equal lanes too
    want = np.asarray(rkops.bitserial_lt(a, b, **BLOCKS))
    got = tkops.bitserial_lt(as_words(a), as_words(b))
    assert got.shape == shape
    np.testing.assert_array_equal(to_uint32(got), want)


@pytest.mark.parametrize("groups", [1, 37, 130])
@pytest.mark.parametrize("n_bits", [1, 5, 13, 32])
def test_bit_untranspose_matches_reference(n_bits, groups):
    rng = np.random.default_rng(n_bits * 1000 + groups)
    planes = _words(rng, n_bits, groups)
    want = np.asarray(rkops.bit_untranspose(planes, n_bits,
                                            block_groups=128))
    got = tkops.bit_untranspose(as_words(planes), n_bits)
    assert got.shape == (32 * groups,)
    np.testing.assert_array_equal(to_uint32(got), want)
    # the round trip through the bit transpose
    values = rng.integers(0, 1 << n_bits, 32 * groups, dtype=np.uint32)
    back = tkops.bit_untranspose(
        tkops.bit_transpose(as_words(values), n_bits), n_bits)
    np.testing.assert_array_equal(to_uint32(back), values)
    # the first n_bits of 32 planes: the planes above are never read
    wide = _words(rng, 32, groups)
    np.testing.assert_array_equal(
        to_uint32(tkops.bit_untranspose(as_words(wide), n_bits)),
        np.asarray(rkops.bit_untranspose(wide[:n_bits], n_bits,
                                         block_groups=128)))


def test_kernel_wrappers_reject_bad_operands():
    with pytest.raises(ValueError, match=r"b <= 32"):
        bit_untranspose_kernel(torch.zeros((33, 3), dtype=torch.int32))
    z = torch.zeros((4, 1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        bitserial_add_kernel(z, torch.zeros((4, 1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="n_bits"):
        tkops.bit_untranspose(torch.zeros((3, 2), dtype=torch.int32), 4)


# ---------------------------------------------------------------------------
# ops/arith and ops/transpose against repro.ops
# ---------------------------------------------------------------------------


def _columns(n, n_bits, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << n_bits, n, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << n_bits, n, dtype=np.uint64).astype(np.uint32)
    b[:40] = a[:40]
    ra, rb = R.VerticalColumn.encode(a, n_bits), R.VerticalColumn.encode(
        b, n_bits)
    ta = T.VerticalColumn.encode(a, n_bits, device="cpu")
    tb = T.VerticalColumn.encode(b, n_bits, device="cpu")
    np.testing.assert_array_equal(to_uint32(ta.planes), np.asarray(ra.planes))
    return a, b, ra, rb, ta, tb


def _same_column(r, t):
    assert (t.n_bits, t.n_values) == (r.n_bits, r.n_values)
    np.testing.assert_array_equal(to_uint32(t.planes), np.asarray(r.planes))


def _same_bits(r, t):
    assert t.n_bits == r.n_bits
    np.testing.assert_array_equal(to_uint32(t.words), np.asarray(r.words))


@pytest.mark.parametrize("n", [3001, 2048])
@pytest.mark.parametrize("n_bits", WIDTHS)
def test_arith_ops_match_reference(n_bits, n):
    a, b, ra, rb, ta, tb = _columns(n, n_bits, n_bits * 7 + n)
    mod = 1 << n_bits
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    for r_fn, t_fn, want in ((R.add_columns, T.add_columns,
                              (a64 + b64) % mod),
                             (R.sub_columns, T.sub_columns,
                              (a64 - b64) % mod)):
        rc, tc = r_fn(ra, rb), t_fn(ta, tb)
        _same_column(rc, tc)
        # from_vertical: padding lanes hold garbage after arithmetic, the
        # logical lanes equal numpy
        values = T.from_vertical(tc.planes, n_bits)
        np.testing.assert_array_equal(
            to_uint32(values),
            np.asarray(R.from_vertical(rc.planes, n_bits, use_kernel=True)))
        np.testing.assert_array_equal(to_uint32(values)[:n], want)
    _same_bits(R.lt_columns(ra, rb), T.lt_columns(ta, tb))
    assert int(T.lt_columns(ta, tb).popcount()) == int((a < b).sum())
    for k in (-5, 0, 1, mod // 3, mod - 1, mod, mod + 9):
        _same_bits(R.lt_const(ra, k), T.lt_const(ta, k))
        assert int(T.lt_const(ta, k).popcount()) == int((a < k).sum())
    assert T.sum_column(ta) == R.sum_column(ra) == int(a64.sum())


@pytest.mark.parametrize("n_banks", [1, 3, 8])
def test_dram_twins_match_reference(n_banks):
    n_bits = 8
    a, b, ra, rb, ta, tb = _columns(3001, n_bits, 11)
    _same_column(R.add_columns_dram(ra, rb, n_banks=n_banks),
                 T.add_columns_dram(ta, tb, n_banks=n_banks))
    _same_column(R.sub_columns_dram(ra, rb, n_banks=n_banks),
                 T.sub_columns_dram(ta, tb, n_banks=n_banks))
    _same_bits(R.lt_columns_dram(ra, rb, n_banks=n_banks),
               T.lt_columns_dram(ta, tb, n_banks=n_banks))
    for k in (0, 77, 256):
        _same_bits(R.lt_const_dram(ra, k, n_banks=n_banks),
                   T.lt_const_dram(ta, k, n_banks=n_banks))
    assert T.sum_column_dram(ta, n_banks=n_banks) == \
        R.sum_column_dram(ra, n_banks=n_banks)


@pytest.mark.parametrize("backend", ["interp", "torch"])
def test_dram_twins_equal_the_fast_path(backend):
    """Every backend of the in-DRAM path agrees with the fast path over
    the logical lanes."""
    a, b, _, _, ta, tb = _columns(1000, 7, 3)
    mask = T.lt_const(ta, 1 << 7).words        # all logical lanes
    for fast, dram in ((T.add_columns, T.add_columns_dram),
                       (T.sub_columns, T.sub_columns_dram)):
        assert torch.equal(fast(ta, tb).planes & mask,
                           dram(ta, tb, backend=backend).planes & mask)
    assert torch.equal(T.lt_columns(ta, tb).words,
                       T.lt_columns_dram(ta, tb, backend=backend).words)
    assert torch.equal(T.lt_const(ta, 50).words,
                       T.lt_const_dram(ta, 50, backend=backend).words)
    assert T.sum_column(ta) == T.sum_column_dram(ta, backend=backend)


def test_cpu_path_launches_nothing_and_backend_names_are_the_ports():
    _, _, _, _, ta, tb = _columns(500, 5, 2)
    before = dict(LAUNCHES)
    T.add_columns(ta, tb)
    T.lt_columns(ta, tb)
    T.from_vertical(ta.planes, 5)
    assert dict(LAUNCHES) == before
    for name in ("pallas", "scan"):
        with pytest.raises(ValueError, match="unknown backend"):
            T.add_columns_dram(ta, tb, backend=name)
    with pytest.raises(ValueError, match="use_kernel"):
        T.add_columns(ta, tb, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel"):
        T.lt_const(ta, 3, use_kernel=True)
    with pytest.raises(ValueError, match="width mismatch"):
        T.lt_columns(ta, T.VerticalColumn.encode(np.arange(500), 9,
                                                 device="cpu"))
