"""Port parity: the §8.4 applications and the bitmap data filter on the CPU.

Masked initialization, the XOR keystream and cipher, DNA matching (exact
and within k mismatches, reads of 16 and 40 bases), Bloom filters and the
corpus bitmap filter, each held to the JAX package on inputs drawn with
numpy from fixed seeds (or by the reference from a fixed key and carried
across with `convert`). Words, slots, match positions, counts and sampled
ids must match bit for bit. The samplers draw from a `torch.Generator`,
whose bits are not `jax.random`'s: their pure step (`gumbel_top_k`) is fed
the reference's own Gumbel draw, and a generator-drawn sample is checked
for membership and uniqueness."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch import convert
from repro_torch.core.bitplane import as_words, to_uint32

# the packages export functions under some of these modules' names
rbf, rbloom, rcrypto, rdna, rmask, tbf, tbloom, tcrypto, tdna, tmask = (
    importlib.import_module(f"{pkg}.{mod}")
    for pkg in ("repro", "repro_torch")
    for mod in ("data.bitmap_filter", "ops.bloom", "ops.crypto", "ops.dna",
                "ops.masked_init"))


def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


# ---------------------------------------------------------------------------
# §8.4.1 masked initialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("record_bits,offset,width,n_records",
                         [(32, 24, 8, 64), (32, 8, 16, 33), (24, 3, 5, 50),
                          (96, 40, 30, 7)])
def test_field_mask_and_masked_ops_match_reference(record_bits, offset,
                                                   width, n_records):
    want = np.asarray(rmask.field_mask(record_bits, offset, width, n_records))
    mask = tmask.field_mask(record_bits, offset, width, n_records,
                            device="cpu")
    np.testing.assert_array_equal(to_uint32(mask), want)
    n = want.shape[0]
    data, value = _u32(n, n_records), _u32(n, n_records + 1)
    np.testing.assert_array_equal(
        to_uint32(tmask.masked_init(data, mask, value)),
        np.asarray(rmask.masked_init(jnp.asarray(data), jnp.asarray(want),
                                     jnp.asarray(value))))
    for bit in (0, 1):
        np.testing.assert_array_equal(
            to_uint32(tmask.masked_fill_constant(as_words(data), mask, bit)),
            np.asarray(rmask.masked_fill_constant(jnp.asarray(data),
                                                  jnp.asarray(want), bit)))


def test_masked_init_host_operands_follow_device():
    data, value = _u32(40, 3), _u32(40, 4)
    mask = _u32(40, 5)
    got = tmask.masked_init(data, mask, value, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(to_uint32(got),
                                  (data & ~mask) | (value & mask))


# ---------------------------------------------------------------------------
# §8.4.2 XOR cipher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", [0, 1, 0x7FFFFFFF, 0xDEADBEEF, 2**32 - 1])
@pytest.mark.parametrize("shape", [(4096,), (7, 33)])
def test_keystream_matches_reference(key, shape):
    want = np.asarray(rcrypto.keystream(key, shape))
    got = tcrypto.keystream(key, shape, device="cpu")
    assert tuple(got.shape) == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(to_uint32(got), want)


def test_xor_encrypt_decrypt_match_reference():
    pt = _u32(1000, 7)
    for key in (0xDEADBEEF, 12345):
        ct = tcrypto.xor_encrypt(pt, key, device="cpu")
        np.testing.assert_array_equal(
            to_uint32(ct), np.asarray(rcrypto.xor_encrypt(jnp.asarray(pt),
                                                          key)))
        np.testing.assert_array_equal(
            to_uint32(tcrypto.xor_decrypt(ct, key)), pt)
        assert not np.array_equal(
            to_uint32(tcrypto.xor_decrypt(ct, key + 1)), pt)


# ---------------------------------------------------------------------------
# §8.4.3 DNA matching
# ---------------------------------------------------------------------------


def _seq(n, seed):
    return "".join(np.random.default_rng(seed).choice(list("ACGT"), n))


def _oracle(genome, read, max_mismatch=0):
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    g = np.asarray([code[c] for c in genome])
    r = np.asarray([code[c] for c in read])
    L = len(r)
    return np.asarray([(g[i:i + L] != r).sum() <= max_mismatch
                       for i in range(len(g) - L + 1)])


def test_dna_encode_matches_reference():
    genome = _seq(1000, 0)
    r_lo, r_hi, r_n = rdna.encode(genome)
    t_lo, t_hi, t_n = tdna.encode(genome, device="cpu")
    assert t_n == r_n
    np.testing.assert_array_equal(to_uint32(t_lo), np.asarray(r_lo))
    np.testing.assert_array_equal(to_uint32(t_hi), np.asarray(r_hi))


@pytest.mark.parametrize("k", [0, 1, 15, 31, 32, 33, 39, 64, 70, 150])
def test_dna_shift_down_matches_reference(k):
    w = _u32(7, k)
    np.testing.assert_array_equal(
        to_uint32(tdna.shift_down(as_words(w), k)),
        np.asarray(rdna.shift_down(jnp.asarray(w), k)))


@pytest.mark.parametrize("base", range(4))
def test_dna_base_equality_matches_reference(base):
    lo, hi = _u32(9, base), _u32(9, base + 10)
    np.testing.assert_array_equal(
        to_uint32(tdna.base_equality(as_words(lo), as_words(hi), base)),
        np.asarray(rdna.base_equality(jnp.asarray(lo), jnp.asarray(hi),
                                      base)))


def _reference_starts(genome, read, max_mismatch=None):
    """The reference's match bits (exact, or within ``max_mismatch``):
    its own `find_*` where its final mask broadcasts, else the same steps
    (`encode`, `base_equality`, `shift_down`, the AND chain or
    `ref.majority_k`) with the valid starts kept in numpy."""
    n, L = len(genome), len(read)
    if -(-n // 32) == -(-(n - L + 1) // 32):
        bv = (rdna.find_matches(genome, read) if max_mismatch is None else
              rdna.find_matches_with_mismatches(genome, read, max_mismatch))
        return np.asarray(bv.words), bv.n_bits
    lo, hi, _ = rdna.encode(genome)
    planes = [rdna.shift_down(rdna.base_equality(lo, hi, "ACGT".index(c)),
                              j) for j, c in enumerate(read)]
    if max_mismatch is None:
        acc = planes[0]
        for p in planes[1:]:
            acc = acc & p
    else:
        acc = rref.majority_k(jnp.stack(planes), threshold=L - max_mismatch)
    bits = np.unpackbits(np.asarray(acc).view(np.uint8), bitorder="little")
    bits[n - L + 1:] = 0
    return np.packbits(bits, bitorder="little").view(np.uint32), n - L + 1


#: reads of 16 bases (the reference's `find_*` itself) and of 40, longer
#: than a word: every such read leaves its last start in an earlier word
#: than the genome's end, where the reference's final mask fails to
#: broadcast, so those are held to the reference's steps
@pytest.mark.parametrize("n,L,at", [(3000, 16, 1500), (4128, 16, 4100),
                                    (3016, 40, 777), (4128, 40, 4000)])
def test_dna_matches_match_reference(n, L, at):
    genome = _seq(n, n)
    read = genome[at:at + L]
    mutated = list(read)
    for j in (5, L - 3):
        mutated[j] = "A" if read[j] != "A" else "C"
    mutated = "".join(mutated)
    for r in (read, mutated):
        for t in (None, 1, 2, 3):
            want, n_bits = _reference_starts(genome, r, t)
            got = (tdna.find_matches(genome, r, device="cpu") if t is None
                   else tdna.find_matches_with_mismatches(genome, r, t,
                                                          device="cpu"))
            assert got.n_bits == n_bits
            np.testing.assert_array_equal(to_uint32(got.words), want)
            np.testing.assert_array_equal(got.to_bits().numpy(),
                                          _oracle(genome, r, t or 0))
    assert tdna.find_matches(genome, read, device="cpu").to_bits()[at]
    assert not tdna.find_matches(genome, mutated, device="cpu").to_bits()[at]
    assert tdna.find_matches_with_mismatches(
        genome, mutated, 2, device="cpu").to_bits()[at]


@pytest.mark.parametrize("n,L", [(100, 16), (1000, 40), (40, 40), (30, 40)])
def test_dna_matches_where_the_reference_mask_fails(n, L):
    """Start positions spanning fewer words than the genome: the port masks
    the genome's words past the last start (the reference raises)."""
    genome = _seq(n, n + L)
    read = genome[n - L:] if L <= n else genome + "A" * (L - n)
    got = tdna.find_matches(genome, read, device="cpu")
    assert got.words.shape[-1] == -(-n // 32)
    want = _oracle(genome, read) if L <= n else np.zeros(0, bool)
    np.testing.assert_array_equal(got.to_bits().numpy(), want)
    got = tdna.find_matches_with_mismatches(genome, read, 3, device="cpu")
    want = _oracle(genome, read, 3) if L <= n else np.zeros(0, bool)
    np.testing.assert_array_equal(got.to_bits().numpy(), want)
    assert int(got.popcount()) == int(want.sum())


# ---------------------------------------------------------------------------
# §8.4.4 Bloom filters
# ---------------------------------------------------------------------------


def _keys(n, seed):
    """Keys over the whole uint32 range, half of them at or above 2**31."""
    return _u32(n, seed)


@pytest.mark.parametrize("m_bits,k", [(1 << 12, 4), (1 << 16, 7),
                                      (100_003, 3), (3 << 30, 4)])
def test_bloom_slots_match_reference(m_bits, k):
    keys = _keys(2000, m_bits)
    want = np.asarray(rbloom._hashes(jnp.asarray(keys), k, m_bits))
    got = tbloom._hashes(as_words(keys), k, m_bits)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64)
                                  & 0xFFFFFFFF)
    assert int(got.min()) >= 0 and int(got.max()) < m_bits


@pytest.mark.parametrize("m_bits,k", [(1 << 12, 4), (1 << 14, 5),
                                      (10_000, 3)])
def test_bloom_insert_query_merge_match_reference(m_bits, k):
    keys = [_keys(300, s) for s in range(4)]
    probe = _keys(5000, 99)
    refs = [rbloom.BloomFilter.create(m_bits, k).insert(jnp.asarray(x))
            for x in keys]
    gots = [tbloom.BloomFilter.create(m_bits, k, device="cpu").insert(x)
            for x in keys]
    for r, t, x in zip(refs, gots, keys):
        assert t.bits.n_bits == r.bits.n_bits and t.k == r.k
        np.testing.assert_array_equal(to_uint32(t.bits.words),
                                      np.asarray(r.bits.words))
        assert bool(t.query(x).all())
        np.testing.assert_array_equal(t.query(probe).numpy(),
                                      np.asarray(r.query(jnp.asarray(probe))))
    r_m, t_m = refs[0].merge(*refs[1:]), gots[0].merge(*gots[1:])
    np.testing.assert_array_equal(to_uint32(t_m.bits.words),
                                  np.asarray(r_m.bits.words))
    np.testing.assert_array_equal(t_m.query(probe).numpy(),
                                  np.asarray(r_m.query(jnp.asarray(probe))))
    assert float(t_m.fill_ratio()) == pytest.approx(
        float(r_m.fill_ratio()), rel=1e-6)
    assert bool(t_m.query(np.concatenate(keys)).all())


def test_bloom_merge_rejects_another_shape():
    a = tbloom.BloomFilter.create(1 << 10, 4, device="cpu")
    with pytest.raises(ValueError):
        a.merge(tbloom.BloomFilter.create(1 << 10, 3, device="cpu"))


# ---------------------------------------------------------------------------
# bitmap data filter (§8.1 / §8.2 as a data stage)
# ---------------------------------------------------------------------------

FILTERS = (
    dict(require=("lang_en",), exclude=("toxic",),
         ranges={"n_tokens": (128, 2048)}),
    dict(require=("lang_en", "quality_hi", "dedup_canonical")),
    dict(exclude=("toxic", "quality_hi")),
    dict(ranges={"n_tokens": (0, 100)}),
    dict(),
)


@pytest.mark.parametrize("n_docs", [10_000, 4096, 77])
def test_bitmap_filter_matches_reference(n_docs):
    rcat = rbf.CorpusCatalog.synthetic(jax.random.PRNGKey(n_docs), n_docs)
    tcat = convert.corpus_catalog_from_reference(rcat, device="cpu")
    assert tcat.device.type == "cpu" and tcat.n_docs == n_docs
    for spec in FILTERS:
        r_bits, r_n = rbf.build_filter(rcat, **spec)
        t_bits, t_n = tbf.build_filter(tcat, **spec)
        assert t_n == r_n, spec
        np.testing.assert_array_equal(to_uint32(t_bits), np.asarray(r_bits))
        np.testing.assert_array_equal(
            to_uint32(tbf._mask_tail(t_bits, n_docs)),
            np.asarray(rbf._mask_tail(r_bits, n_docs)))
        np.testing.assert_array_equal(
            tbf.eligible_indices(t_bits, n_docs),
            rbf.eligible_indices(r_bits, n_docs))


@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_step_on_reference_gumbel_draw(seed):
    n_docs, batch = 5000, 64
    rcat = rbf.CorpusCatalog.synthetic(jax.random.PRNGKey(seed), n_docs)
    bits, _ = rbf.build_filter(rcat, **FILTERS[0])
    key = jax.random.PRNGKey(100 + seed)
    want = np.asarray(rbf.sample_eligible(key, bits, n_docs, batch))
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (n_docs,))))
    t_bits = tbf.unpack_bits(as_words(np.asarray(bits)), n_docs)
    got = tbf.gumbel_top_k(t_bits, g, batch)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_eligible_draws_unique_eligible_ids():
    gen = torch.Generator().manual_seed(3)
    cat = tbf.CorpusCatalog.synthetic(gen, 10_000)
    bits, n_ok = tbf.build_filter(cat, **FILTERS[0])
    assert 0 < n_ok < 10_000
    eligible = set(tbf.eligible_indices(bits, cat.n_docs).tolist())
    assert len(eligible) == n_ok
    ids = tbf.sample_eligible(gen, bits, cat.n_docs, 256)
    assert ids.shape == (256,) and ids.dtype == torch.int32
    assert len(set(ids.tolist())) == 256
    assert set(ids.tolist()) <= eligible
    again = tbf.sample_eligible(torch.Generator().manual_seed(4), bits,
                                cat.n_docs, 256)
    assert set(again.tolist()) <= eligible
    assert again.tolist() != ids.tolist()
