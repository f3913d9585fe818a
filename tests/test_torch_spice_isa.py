"""Port parity: the TRA charge-sharing model (§3, Table 1) and the `bop`
dispatch (§6.2) on the CPU.

Float results of the model are held to the reference's to 1e-5 relative
(both compute in float32; they may sum in another order); Table 1's
sensed values, failures and the Monte-Carlo failure counts bit for bit.
`monte_carlo_tra`'s evaluation is fed the reference's own `jax.random`
draws (its lines that draw values and clipped capacitances, repeated
here), since the port draws from a `torch.Generator`; the port's own draw
is checked for what it must show. `BuddyDevice.bop`'s path, PSM count,
latency and value must equal the reference's on a sequence that takes
both the Buddy and the CPU path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import isa as risa
from repro.core import spice as rspice
from repro_torch.core import isa as tisa
from repro_torch.core import spice as tspice
from repro_torch.core.bitplane import to_uint32

REL = 1e-5


def test_eq1_matches_reference():
    for k in range(4):
        assert tspice.eq1_deviation(k) == rspice.eq1_deviation(k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deviation_sense_latency_match_reference(seed):
    rng = np.random.default_rng(seed)
    vals = (rng.random((257, 3)) < 0.5).astype(np.float32)
    caps = (22.0 * (1 + 0.2 * rng.standard_normal((257, 3)))
            ).astype(np.float32)
    r_d = rspice.bitline_deviation(jnp.asarray(vals), jnp.asarray(caps))
    t_d = tspice.bitline_deviation(torch.from_numpy(vals),
                                   torch.from_numpy(caps))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(r_d), rtol=REL,
                               atol=1e-7)
    r_s = rspice.sense(r_d)
    t_s = tspice.sense(t_d)
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(r_s))
    np.testing.assert_allclose(
        tspice.tra_latency_ns(t_d, t_s).numpy(),
        np.asarray(rspice.tra_latency_ns(r_d, r_s)), rtol=REL)


def test_table1_matches_reference():
    ref = rspice.table1()
    got = tspice.table1(device="cpu")
    assert list(got) == list(ref)
    for case in ref:
        assert list(got[case]) == list(ref[case])
        for v, want in ref[case].items():
            entry = got[case][v]
            for key in ("result", "expected", "fails"):
                assert entry[key] == want[key], (case, v, key)
            for key in ("delta_v", "latency_ns"):
                assert entry[key] == pytest.approx(want[key], rel=REL), \
                    (case, v, key)
    fails = [(c, v) for c, row in got.items() for v, e in row.items()
             if e["fails"]]
    assert fails == [("1s0w0w", 0.25)]


def _reference_draws(key, n_trials, sigma, p=rspice.DEFAULT_SPICE):
    """The reference's `monte_carlo_tra` draws (spice.py:129-133)."""
    kv, kc = jax.random.split(key)
    values = jax.random.bernoulli(kv, 0.5, (n_trials, 3)).astype(jnp.float32)
    caps = p.c_cell_ff * (1.0 + sigma * jax.random.normal(kc, (n_trials, 3)))
    caps = jnp.clip(caps, p.c_cell_ff * 0.5, p.c_cell_ff * 1.5)
    return np.array(values), np.array(caps)


@pytest.mark.parametrize("seed,n_trials,sigma", [(0, 50_000, 0.06),
                                                 (1, 50_000, 0.25),
                                                 (2, 20_000, 0.4)])
def test_monte_carlo_on_reference_draws(seed, n_trials, sigma):
    key = jax.random.PRNGKey(seed)
    ref = rspice.monte_carlo_tra(key, n_trials, sigma)
    values, caps = _reference_draws(key, n_trials, sigma)
    got = tspice.tra_trials(torch.from_numpy(values), torch.from_numpy(caps))
    assert int(got["n_fail"]) == int(ref["n_fail"])
    assert float(got["failure_rate"]) == float(ref["failure_rate"])
    assert float(got["mean_latency_ns"]) == pytest.approx(
        float(ref["mean_latency_ns"]), rel=REL)
    if sigma > 0.2:
        assert int(got["n_fail"]) > 0


def test_monte_carlo_own_draw():
    def run(seed, sigma):
        gen = torch.Generator().manual_seed(seed)
        return tspice.monte_carlo_tra(gen, 50_000, sigma)

    assert float(run(0, 0.06)["failure_rate"]) == 0.0
    hi = run(1, 0.25)
    assert 0.0 < float(hi["failure_rate"]) < 0.05
    assert int(hi["n_fail"]) == int(run(1, 0.25)["n_fail"])
    assert 14.0 < float(hi["mean_latency_ns"]) < 40.0
    # the entry point evaluates exactly its draw
    values, caps = tspice.draw_trials(torch.Generator().manual_seed(1),
                                      50_000, 0.25)
    assert values.dtype == caps.dtype == torch.float32
    assert set(values.unique().tolist()) == {0.0, 1.0}
    assert float(caps.min()) >= 11.0 and float(caps.max()) <= 33.0
    again = tspice.tra_trials(values, caps)
    assert all(torch.equal(again[k], hi[k]) for k in hi)


def test_table1_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspice.table1_entry((1, 0, 0), 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tisa.BuddyDevice(row_bits=1024)


# ---------------------------------------------------------------------------
# §6.2 bop dispatch
# ---------------------------------------------------------------------------

#: (op, dst, srcs, group of dst if new): the same affinity group (0 PSM),
#: scattered operands (1-2 PSM copies, Buddy), three sources and the
#: destination in four subarrays (3 PSM copies: the CPU path), chained
#: through earlier results
BOPS = (
    ("and", "o1", ["a", "b"], "g0"),
    ("or", "o2", ["a", "c"], "g3"),
    ("xor", "o3", ["a", "b"], "g0"),
    ("maj3", "o4", ["a", "c", "d"], "g4"),
    ("not", "o5", ["o1"], "g0"),
    ("nand", "o6", ["o4", "b"], "g0"),
    ("maj3", "o7", ["o1", "o3", "o5"], None),
    ("xnor", "o4", ["o2", "d"], None),
    ("nor", "o8", ["o6", "o7"], "g1"),
)


@pytest.mark.parametrize("row_bits", [1024, 65536])
def test_bop_sequence_matches_reference(row_bits):
    rng = np.random.default_rng(row_bits)
    rows = {n: rng.integers(0, 2**32, row_bits // 32, dtype=np.uint32)
            for n in "abcd"}
    groups = {"a": "g0", "b": "g0", "c": "g1", "d": "g2"}
    ref = risa.BuddyDevice(row_bits=row_bits)
    got = tisa.BuddyDevice(row_bits=row_bits, device="cpu")
    for n, words in rows.items():
        ref.store(n, jnp.asarray(words), group=groups[n])
        got.store(n, words, group=groups[n])
    paths = set()
    for op, dst, srcs, group in BOPS:
        r = ref.bop(op, dst, srcs, group=group)
        t = got.bop(op, dst, srcs, group=group)
        assert (t.path, t.n_psm) == (r.path, r.n_psm), (op, dst)
        assert t.latency_ns == pytest.approx(r.latency_ns, rel=1e-12)
        assert t.value.device.type == "cpu"
        np.testing.assert_array_equal(to_uint32(t.value), np.asarray(r.value))
        paths.add(t.path)
    assert paths == {"buddy", "cpu"}
    for name in ref.rows:
        np.testing.assert_array_equal(to_uint32(got.rows[name]),
                                      np.asarray(ref.rows[name]))


def test_bop_rejects_a_partial_row():
    dev = tisa.BuddyDevice(row_bits=1024, device="cpu")
    with pytest.raises(ValueError, match="row-sized"):
        dev.store("a", np.zeros(31, np.uint32))
