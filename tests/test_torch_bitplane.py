"""Port parity: packed words, tail masks and popcounts (`repro_torch.core.
bitplane`, `repro_torch.ops.popcount`) against the JAX package, bit for
bit, over random lengths including ones that are not multiples of 32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as rbp
from repro.ops import popcount as rpc
from repro_torch.core import bitplane as tbp
from repro_torch.ops import popcount as tpc

LENGTHS = [1, 5, 31, 32, 33, 63, 64, 65, 100, 257, 1000, 4097]
EDGE_WORDS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x55555555,
                       0xAAAAAAAA, 0x0F0F0F0F, 0xF0F0F0F0, 0x80000001],
                      dtype=np.uint32)


@pytest.mark.parametrize("n", LENGTHS)
def test_pack_unpack_and_tail_mask_match_reference(n):
    rng = np.random.default_rng(n)
    bits = rng.random((3, n)) < 0.5
    want = np.asarray(rbp.pack_bits(jnp.asarray(bits)))
    got = tbp.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(tbp.to_uint32(got), want)
    np.testing.assert_array_equal(
        tbp.unpack_bits(got, n).numpy(),
        np.asarray(rbp.unpack_bits(jnp.asarray(want), n)))
    np.testing.assert_array_equal(tbp.tail_mask(n), rbp.tail_mask(n))
    assert tbp.n_words(n) == rbp.n_words(n) == got.shape[-1]


@pytest.mark.parametrize("seed", range(4))
def test_popcounts_match_reference(seed):
    rng = np.random.default_rng(seed)
    w = np.concatenate([EDGE_WORDS,
                        rng.integers(0, 1 << 32, 500, dtype=np.uint32)])
    w = w.reshape(6, -1)
    t = tbp.as_words(w)
    np.testing.assert_array_equal(
        tpc.popcount_u32(t).numpy(),
        np.asarray(rpc.popcount_u32(jnp.asarray(w))).astype(np.int32))
    assert int(tpc.popcount_words(t)) == int(rpc.popcount_words(
        jnp.asarray(w)))
    for axis in (0, 1, -1):
        np.testing.assert_array_equal(
            tpc.popcount_words(t, axis=axis).numpy(),
            np.asarray(rpc.popcount_words(jnp.asarray(w), axis=axis)))


def test_word_boundary_round_trips():
    w = EDGE_WORDS
    t = tbp.as_words(w)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tbp.to_uint32(t), w)
    # uint32 tensors are re-viewed, int32 tensors pass through unchanged
    u = torch.from_numpy(w.copy()).view(torch.uint32)
    assert torch.equal(tbp.as_words(u), t)
    assert tbp.as_words(t) is t
    # host arrays are copied, never aliased
    src = w.copy()
    t2 = tbp.as_words(src)
    src[0] = 7
    assert int(t2[0]) == 0
    np.testing.assert_array_equal(tbp.to_uint32(tbp.as_words([0xFFFFFFFF])),
                                  [0xFFFFFFFF])
    with pytest.raises(TypeError):
        tbp.as_words(torch.zeros(3, dtype=torch.float32))
    with pytest.raises(TypeError):
        tbp.as_words(np.zeros(3, dtype=np.float64))
    assert [tbp.i32(x) for x in (0, 5, 0x7FFFFFFF, 0x80000000,
                                 0xFFFFFFFF)] == \
        [0, 5, 0x7FFFFFFF, -(1 << 31), -1]


@pytest.mark.parametrize("n", [7, 64, 333])
def test_bitvector_ops_match_reference(n):
    rng = np.random.default_rng(n)
    a, b, c = (rng.random(n) < 0.5 for _ in range(3))
    ra, rb, rc = (rbp.BitVector.from_bits(jnp.asarray(x)) for x in (a, b, c))
    ta, tb, tc = (tbp.BitVector.from_bits(torch.from_numpy(x))
                  for x in (a, b, c))
    pairs = [(ra & rb, ta & tb), (ra | rb, ta | tb), (ra ^ rb, ta ^ tb),
             (~ra, ~ta), (ra.majority(rb, rc), ta.majority(tb, tc)),
             (rbp.BitVector.ones(n), tbp.BitVector.ones(n)),
             (rbp.BitVector.zeros(n, (2,)), tbp.BitVector.zeros(n, (2,)))]
    for r, t in pairs:
        assert r.n_bits == t.n_bits
        np.testing.assert_array_equal(tbp.to_uint32(t.words),
                                      np.asarray(r.words))
        assert int(t.popcount()) == int(r.popcount())
        np.testing.assert_array_equal(t.to_bits().numpy(),
                                      np.asarray(r.to_bits()))
