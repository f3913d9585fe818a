"""Port parity: the BitWeaving-V bit transpose and column encoding.

`to_vertical` and `VerticalColumn.encode` (through the bit-transpose
wrapper, which runs its plain version for CPU tensors) against the JAX
package's `kernels.ref.bit_transpose` and `VerticalColumn.encode`, bit
for bit — including a column long enough that the reference takes its
Pallas kernel (interpret mode on the CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.ops import predicate as rpred
from repro_torch.core.bitplane import as_words, to_uint32
from repro_torch.kernels import LAUNCHES, ref as tref
from repro_torch.kernels.bittranspose import bit_transpose_kernel
from repro_torch.ops import predicate as tpred
from repro_torch.ops.transpose import to_vertical


@pytest.mark.parametrize("n,n_bits", [(32, 1), (64, 8), (320, 5),
                                      (1024, 13), (96, 32), (32 * 37, 31)])
def test_to_vertical_matches_reference(n, n_bits):
    rng = np.random.default_rng(n + n_bits)
    values = rng.integers(0, 1 << n_bits, n, dtype=np.uint64) \
        .astype(np.uint32)
    want = np.asarray(rref.bit_transpose(jnp.asarray(values), n_bits))
    got = to_vertical(values, n_bits, device="cpu")
    assert got.shape == (n_bits, n // 32) and got.dtype == torch.int32
    np.testing.assert_array_equal(to_uint32(got), want)
    np.testing.assert_array_equal(
        to_uint32(tref.bit_transpose(as_words(values), n_bits)), want)


@pytest.mark.parametrize("n,n_bits", [(1, 3), (31, 8), (33, 8), (1000, 7),
                                      (65536 + 5, 8)])
def test_vertical_column_encode_matches_reference(n, n_bits):
    rng = np.random.default_rng(n)
    values = rng.integers(0, 1 << n_bits, n, dtype=np.uint32)
    want = rpred.VerticalColumn.encode(jnp.asarray(values), n_bits)
    got = tpred.VerticalColumn.encode(values, n_bits, device="cpu")
    assert (got.n_bits, got.n_values) == (want.n_bits, want.n_values)
    np.testing.assert_array_equal(to_uint32(got.planes),
                                  np.asarray(want.planes))


def test_cpu_wrapper_runs_plain_version_without_launching():
    before = dict(LAUNCHES)
    values = as_words(np.arange(64, dtype=np.uint32))
    assert torch.equal(bit_transpose_kernel(values, 6),
                       tref.bit_transpose(values, 6))
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError):
        bit_transpose_kernel(values[:40], 6)
    assert bit_transpose_kernel(values, 0).shape == (0, 2)


@pytest.mark.parametrize("lo,hi", [(0, 255), (37, 201), (200, 200)])
def test_range_scan_expr_matches_reference_structure(lo, hi):
    from repro.core.compiler import expr_key as rkey
    from repro_torch.core.compiler import expr_key as tkey

    r = rpred.range_scan_expr(8, lo, hi, plane_prefix="c.b")
    t = tpred.range_scan_expr(8, lo, hi, plane_prefix="c.b")
    assert repr(tkey(t)) == repr(rkey(r))
