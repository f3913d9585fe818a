"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test skips (from its fixture) where
`torch.cuda.is_available()` is false. On a machine with a card run
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Unlike the other port tests this file imports neither JAX nor the JAX
package, so it runs on a GPU machine that has only PyTorch; the CPU
parity tests hold the plain versions to the reference."""
import numpy as np
import pytest
import torch

from repro_torch.core import compiler as tcomp
from repro_torch.core import lowering as tlow
from repro_torch.core.bitplane import as_words, to_uint32
from repro_torch.kernels import LAUNCHES, ref, vm
from repro_torch.kernels.bittranspose import bit_transpose_kernel

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _program(seed):
    """A fused random boolean program over D0..D5."""
    r = np.random.default_rng(seed)
    E = tcomp.Expr
    leaves = [E.of(f"D{i}") for i in range(6)]
    e = leaves[0]
    for _ in range(8):
        a = leaves[int(r.integers(6))]
        op = ["and", "or", "xor", "maj3"][int(r.integers(4))]
        e = E("maj3", (e, a, leaves[int(r.integers(6))])) \
            if op == "maj3" else E(op, (e, a))
    return tcomp.compile_expr_fused(e, "OUT").program


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("mode", ["materialize", "shared-mask",
                                  "per-batch-mask", "errors"])
def test_vm_kernel_matches_plain(cuda, batch, mode):
    lp = tlow.lower(_program(batch))
    rng = np.random.default_rng(7)
    words = 300                 # not a multiple of any column block
    data = {f"D{i}": rng.integers(0, 1 << 32, (batch, words),
                                  dtype=np.uint32) for i in range(6)}
    dev = {k: as_words(v, cuda) for k, v in data.items()}
    errors = mask = None
    reduce = None if mode in ("materialize", "errors") else "popcount"
    if mode == "shared-mask":
        mask = rng.integers(0, 1 << 32, (words,), dtype=np.uint32)
    elif mode == "per-batch-mask":
        mask = rng.integers(0, 1 << 32, (batch, words), dtype=np.uint32)
    elif mode == "errors":
        errors = rng.integers(0, 1 << 32, (lp.n_cmds, 4, batch, words),
                              dtype=np.uint32)
    call = tlow.vm_call(lp, dev, outputs=["OUT"], errors=errors, mask=mask)
    before = LAUNCHES["vm_popcount"] + LAUNCHES["vm_materialize"]
    got = call.run(vm.vm_megakernel, reduce)
    torch.cuda.synchronize()
    assert LAUNCHES["vm_popcount"] + LAUNCHES["vm_materialize"] == before + 1
    want = call.run(vm.vm_plain, reduce)
    assert torch.equal(got, want)
    # the lowered entry point on the card agrees with it on the host
    host = tlow.execute_lowered(lp, data, words, ["OUT"], errors=errors)
    card = tlow.execute_lowered(lp, dev, words, ["OUT"], backend="cuda",
                                errors=errors)
    np.testing.assert_array_equal(to_uint32(card["OUT"]),
                                  to_uint32(host["OUT"]))


@pytest.mark.parametrize("n,n_bits", [(1 << 16, 8), (32 * 1001, 13),
                                      (1 << 20, 32), (32, 1)])
def test_bit_transpose_kernel_matches_plain(cuda, n, n_bits):
    rng = np.random.default_rng(n)
    values = as_words(rng.integers(0, 1 << n_bits, n, dtype=np.uint64)
                      .astype(np.uint32), cuda)
    before = LAUNCHES["bit_transpose"]
    got = bit_transpose_kernel(values, n_bits)
    torch.cuda.synchronize()
    assert LAUNCHES["bit_transpose"] == before + 1
    assert torch.equal(got, ref.bit_transpose(values, n_bits))


def _at_word_offset(t, offset):
    """A contiguous copy of ``t`` starting ``offset`` words into its
    storage (offset 1: a data pointer 4 but not 16-byte aligned)."""
    store = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = store[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("words,offset", [(1001, 0), (1003, 0), (1000, 1),
                                          (1003, 1), (100, 0)])
@pytest.mark.parametrize("mode", ["materialize", "shared-mask",
                                  "per-batch-mask", "errors",
                                  "errors-popcount"])
def test_vm_kernel_takes_ragged_and_misaligned_operands(cuda, words, offset,
                                                        mode):
    """Word counts of 1 and 3 mod 4 (the 16-byte columns' ragged tail),
    one slice narrower than a tile, and plane, mask and fault masks one
    word into their storage, as a contiguous view may be."""
    lp = tlow.lower(_program(words + offset))
    rng = np.random.default_rng(words)
    batch = 1 if words == 100 else 3
    dev = {f"D{i}": as_words(rng.integers(0, 1 << 32, (batch, words),
                                          dtype=np.uint32), cuda)
           for i in range(6)}
    call = tlow.vm_call(lp, dev, outputs=["OUT"])
    reduce = None if mode in ("materialize", "errors") else "popcount"
    mask = errors = None
    if mode in ("shared-mask", "errors-popcount"):
        mask = as_words(rng.integers(0, 1 << 32, (1, words),
                                     dtype=np.uint32), cuda)
    elif mode == "per-batch-mask":
        mask = as_words(rng.integers(0, 1 << 32, (batch, words),
                                     dtype=np.uint32), cuda)
    if mode.startswith("errors"):
        errors = as_words(rng.integers(0, 1 << 32, (batch, 4 * lp.n_cmds,
                                                    words),
                                       dtype=np.uint32)
                          & rng.integers(0, 1 << 32, (batch, 4 * lp.n_cmds,
                                                      words),
                                         dtype=np.uint32), cuda)
    plane, mask, errors = (None if t is None else _at_word_offset(t, offset)
                           for t in (call.plane, mask, errors))
    assert plane.data_ptr() % 16 == (4 if offset else 0)
    kw = dict(n_rows=call.lay.n_rows, first_row=call.first_row,
              errors=errors, reduce=reduce, mask=mask)
    before = LAUNCHES["vm_popcount"] + LAUNCHES["vm_materialize"]
    got = vm.vm_megakernel(call.lay.table, plane, call.lay.out_idx, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["vm_popcount"] + LAUNCHES["vm_materialize"] == before + 1
    assert torch.equal(got, vm.vm_plain(call.lay.table, plane,
                                        call.lay.out_idx, **kw))


@pytest.mark.parametrize("groups,n_bits,offset", [(1001, 1, 0), (33, 32, 1),
                                                  (1, 13, 1), (70, 8, 3)])
def test_bit_transpose_kernel_takes_ragged_and_misaligned_values(
        cuda, groups, n_bits, offset):
    """Group counts that leave a ragged last warp, and values one or three
    words into their storage."""
    rng = np.random.default_rng(groups)
    values = _at_word_offset(as_words(
        rng.integers(0, 1 << n_bits, 32 * groups, dtype=np.uint64)
        .astype(np.uint32), cuda), offset)
    got = bit_transpose_kernel(values, n_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.bit_transpose(values, n_bits))


def test_service_on_the_card_matches_its_oracle(cuda):
    from repro_torch.service import (WorkloadSpec, build_service,
                                     query_stream, run_queries_unbatched)

    spec = WorkloadSpec(domain_bits=(1 << 14) + 7)
    LAUNCHES.clear()
    svc = build_service(spec)            # the default device: the card
    assert svc.catalog.get("t0/male").words.device.type == "cuda"
    queries = query_stream(spec, svc)
    report = svc.query_batch(queries)
    oracle = run_queries_unbatched(svc.catalog, queries)
    assert [r.scalar for r in report.results] == \
        [r.scalar for r in oracle.results]
    for name in ("vm_popcount", "vm_materialize", "bit_transpose"):
        assert LAUNCHES[name] > 0, name


def test_unpinned_plans_and_direct_calls_launch_the_kernel(cuda):
    """Without the optimizer, and through `engine.execute` and
    `execute_lowered` called directly, tensors on the card go through the
    kernel; the plain VM is refused there."""
    from repro_torch.core import engine
    from repro_torch.service import (WorkloadSpec, build_service,
                                     query_stream, run_queries_unbatched)

    spec = WorkloadSpec(domain_bits=(1 << 14) + 7)
    svc = build_service(spec, optimize=False)
    queries = query_stream(spec, svc)
    LAUNCHES.clear()
    report = svc.query_batch(queries)
    assert LAUNCHES["vm_popcount"] > 0
    assert [r.scalar for r in report.results] == \
        [r.scalar for r in run_queries_unbatched(svc.catalog,
                                                 queries).results]
    prog = _program(3)
    rng = np.random.default_rng(3)
    dev = {f"D{i}": as_words(rng.integers(0, 1 << 32, (2, 77),
                                          dtype=np.uint32), cuda)
           for i in range(6)}
    before = LAUNCHES["vm_materialize"]
    out = engine.execute(prog, dev, outputs=["OUT"])["OUT"]
    assert LAUNCHES["vm_materialize"] == before + 1
    want = engine.execute(prog, {k: v.cpu() for k, v in dev.items()},
                          outputs=["OUT"])["OUT"]
    assert torch.equal(out.cpu(), want)
    with pytest.raises(ValueError, match="plain VM"):
        tlow.execute_lowered(tlow.lower(prog), dev, outputs=["OUT"],
                             backend="torch")


# ---------------------------------------------------------------------------
# the chip cluster: C chips on the one card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chips", [1, 2, 4])
def test_cluster_shards_launch_the_vm_on_every_chip(cuda, n_chips):
    """`ChipCluster` on ``["cuda:0"] * C``: each chip's shard is one VM
    launch (both modes), the counts tree-psum'd, equal to the cluster on
    ``["cpu"] * C`` and to the unsharded program."""
    from repro_torch.core.bitplane import tail_mask
    from repro_torch.core.cluster import ChipCluster

    lp = tlow.lower(_program(n_chips))
    rng = np.random.default_rng(n_chips)
    words, n_bits = 1_003, 1_003 * 32 - 5
    data = {f"D{i}": rng.integers(0, 1 << 32, (3, words), dtype=np.uint32)
            for i in range(6)}
    clusters = [ChipCluster.create(n_chips, n_banks=8, max_chips=8,
                                   devices=[d] * n_chips)
                for d in ("cuda:0", "cpu")]
    rows, counts = [], []
    for cl in clusters:
        sharded = {k: cl.shard_words(v) for k, v in data.items()}
        mask = cl.shard_words(tail_mask(n_bits))
        before = dict(LAUNCHES)
        out = cl.run_lowered(lp, sharded, ["OUT"])
        rows.append(cl.unshard_words(out["OUT"], words).cpu())
        counts.append(cl.popcounts(lp, sharded, ["OUT"], mask))
        if cl.devices[0].type == "cuda":
            assert LAUNCHES["vm_materialize"] - \
                before.get("vm_materialize", 0) == n_chips
            assert LAUNCHES["vm_popcount"] - \
                before.get("vm_popcount", 0) == n_chips
    assert torch.equal(rows[0], rows[1])
    assert counts[0].dtype == np.int32 and np.array_equal(*counts)
    flat = tlow.execute_lowered(lp, {k: as_words(v, cuda)
                                     for k, v in data.items()},
                                outputs=["OUT"])["OUT"]
    assert torch.equal(rows[0], flat.cpu())


def test_tree_psum_on_one_card(cuda):
    from repro_torch.core.cluster import tree_psum

    xs = [torch.full((3,), i + 1, dtype=torch.int32, device="cuda:0")
          for i in range(4)]
    out = tree_psum(xs)
    assert all(o.device.type == "cuda" and torch.equal(
        o.cpu(), torch.full((3,), 10, dtype=torch.int32)) for o in out)


def test_cluster_of_more_chips_than_cards_raises(cuda):
    from repro_torch.core import engine
    from repro_torch.core.cluster import ChipCluster, ClusterError

    n = torch.cuda.device_count()
    with pytest.raises(ClusterError, match=f"need {n + 1} devices"):
        ChipCluster.create(n + 1)
    if n == 1:
        with pytest.raises(ClusterError, match="need 2 devices"):
            ChipCluster.create(2)
        prog = _program(0)
        rows = {f"D{i}": torch.zeros(8, dtype=torch.int32, device=cuda)
                for i in range(6)}
        with pytest.raises(ClusterError):
            engine.execute(prog, rows, n_chips=2)


def test_distributed_service_on_the_card_matches_the_host(cuda):
    """The §8 stream through ``ServiceConfig(n_chips=1, max_chips=8)`` on
    the card, rescaled onto 4 chips of the one card, equal to the
    single-device service on the host; no plain VM on the card."""
    from repro_torch.service import (ServiceConfig, WorkloadSpec,
                                     build_service, query_stream)

    spec = WorkloadSpec(domain_bits=(1 << 14) + 7)
    host = build_service(spec, device="cpu")
    queries = query_stream(spec, host)
    want = [r.scalar for r in host.query_batch(queries).results]
    svc = build_service(spec, config=ServiceConfig(
        n_chips=1, max_chips=8, device="cuda"))
    LAUNCHES.clear()
    assert [r.scalar for r in svc.query_batch(queries).results] == want
    assert LAUNCHES["vm_popcount"] > 0
    svc.rescale(4, devices=["cuda:0"] * 4)
    assert [r.scalar for r in svc.query_batch(queries).results] == want
    assert svc.stats()["n_chips"] == 4


def test_distributed_service_across_cards_matches_the_host(cuda):
    """With several cards, ``ServiceConfig(n_chips=C)`` puts chip i on
    card i: shards live on their own cards, counts cross cards only
    through `tree_psum`, and a chip kill shrinks the cluster onto the
    first cards; every answer equals the host's."""
    from repro_torch.dist.fault_tolerance import ChipFailure, FaultTolerance
    from repro_torch.service import (ServiceConfig, WorkloadSpec,
                                     build_service, query_stream)

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    c = 4 if n >= 4 else 2
    spec = WorkloadSpec(domain_bits=(1 << 14) + 7)
    host = build_service(spec, device="cpu")
    queries = query_stream(spec, host)
    want = [r.scalar for r in host.query_batch(queries).results]
    armed = {"live": True}

    def inject(g):
        if g == 3 and armed["live"]:
            armed["live"] = False
            raise ChipFailure(c - 1)

    ft = FaultTolerance(failure_injector=inject)
    svc = build_service(spec, config=ServiceConfig(
        n_chips=c, max_chips=8, device="cuda", fault_tolerance=ft))
    assert [d.index for d in svc.cluster.devices] == list(range(c))
    shards = svc.catalog.shards("t0/male")
    assert [s.device.index for s in shards] == list(range(c))
    assert [r.scalar for r in svc.query_batch(queries).results] == want
    assert svc.n_chips == c // 2 and ft.failures == 1
    assert [r.scalar for r in svc.query_batch(queries).results] == want


# ---------------------------------------------------------------------------
# the direct bulk-bitwise path: bitwise, banked bitwise, popcount, scan
# ---------------------------------------------------------------------------

BITWISE_OPS = ["and", "or", "xor", "nand", "nor", "xnor", "andnot", "not",
               "maj3"]


def _card_words(cuda, rng, *shape):
    return as_words(rng.integers(0, 1 << 32, shape, dtype=np.uint32), cuda)


def _operands(cuda, op, shape, seed):
    rng = np.random.default_rng(seed)
    return [_card_words(cuda, rng, *shape) for _ in range(ref.ARITY[op])]


@pytest.mark.parametrize("shape", [(3, 1001), (16, 4096), "misaligned"])
@pytest.mark.parametrize("op", BITWISE_OPS)
def test_bitwise_kernel_matches_plain(cuda, op, shape):
    """Word counts that are not a multiple of 4 (the word-at-a-time path),
    aligned runs (the 16-byte path), and operands 4 bytes off a 16-byte
    boundary."""
    from repro_torch.kernels.bitwise import bitwise_kernel

    if shape == "misaligned":
        args = [a.reshape(-1)[1:].reshape(1, -1)
                for a in _operands(cuda, op, (1, 4097), 3)]
        assert args[0].data_ptr() % 16 == 4
    else:
        args = _operands(cuda, op, shape, len(op))
    before = LAUNCHES["bitwise"]
    got = bitwise_kernel(op, *args)
    torch.cuda.synchronize()
    assert LAUNCHES["bitwise"] == before + 1
    assert torch.equal(got, ref.bitwise(op, *args))


@pytest.mark.parametrize("banks", [1, 3, 8])
@pytest.mark.parametrize("op", BITWISE_OPS)
def test_banked_bitwise_kernel_matches_plain(cuda, op, banks):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.bitwise import banked_bitwise_kernel

    args = _operands(cuda, op, (2, 1001), banks)
    before = LAUNCHES["bitwise_banked"]
    got = kops.bitwise_banked(op, *args, n_banks=banks)
    torch.cuda.synchronize()
    assert LAUNCHES["bitwise_banked"] == before + 1
    assert got.shape == (2, 1001)
    # pad words (not / nand / nor / xnor turn them to ones) are stripped
    assert torch.equal(got, ref.bitwise(op, *args))
    sharded = _operands(cuda, op, (banks, 3, 77), banks + 1)
    assert torch.equal(banked_bitwise_kernel(op, *sharded),
                       ref.bitwise(op, *sharded))


@pytest.mark.parametrize("shape", [(1, 1), (3, 1001), (64, 65536),
                                   "misaligned", "ones"])
def test_popcount_kernel_matches_plain(cuda, shape):
    from repro_torch.kernels.popcount import popcount_kernel

    rng = np.random.default_rng(17)
    if shape == "misaligned":
        words = _card_words(cuda, rng, 4099).reshape(-1)[1:].reshape(1, -1)
    elif shape == "ones":
        words = torch.full((1, 1 << 22), -1, dtype=torch.int32, device=cuda)
    else:
        words = _card_words(cuda, rng, *shape)
    before = LAUNCHES["popcount"]
    got = popcount_kernel(words)
    torch.cuda.synchronize()
    assert LAUNCHES["popcount"] == before + 1
    assert got.dtype == torch.int64 and got.device == words.device
    assert int(got) == int(ref.popcount(words))
    if shape == "ones":
        assert int(got) == 1 << 27


@pytest.mark.parametrize("case", ["inside", "lo_above_hi", "hi_past_range",
                                  "extra_planes"])
@pytest.mark.parametrize("n_bits", [1, 7, 12, 32])
def test_bitweaving_scan_kernel_matches_plain(cuda, n_bits, case):
    from repro_torch.kernels.bitweaving import bitweaving_scan_kernel

    rng = np.random.default_rng(n_bits)
    top = 1 << n_bits
    lo, hi = {"inside": (top // 5, 3 * top // 4),
              "lo_above_hi": (top - 1, 0),
              "hi_past_range": (top // 3, top + 5),
              "extra_planes": (top // 7, top // 2)}[case]
    planes = _card_words(cuda, rng, n_bits + (3 if case == "extra_planes"
                                              else 0), 1001)
    before = LAUNCHES["bitweaving_scan"]
    got = bitweaving_scan_kernel(planes, lo, hi, n_bits)
    torch.cuda.synchronize()
    assert LAUNCHES["bitweaving_scan"] == before + 1
    assert torch.equal(got, ref.bitweaving_scan(planes, lo, hi, n_bits))


def test_use_kernel_false_on_the_card_raises(cuda):
    from repro_torch import ops

    a = _card_words(cuda, np.random.default_rng(1), 64)
    with pytest.raises(ValueError, match="use_kernel"):
        ops.bitwise_and(a, a, use_kernel=False)
    with pytest.raises(ValueError, match="use_kernel"):
        ops.between_scan(a.reshape(2, 32), 1, 2, 2, use_kernel=False)
    with pytest.raises(ValueError, match="different devices"):
        ops.bitwise_and(a, a.cpu())


def test_one_dimensional_ops_launch_the_kernel(cuda):
    """The reference sends 1-D operands to plain jnp; on the card the
    port's ops take the kernel for them too."""
    from repro_torch import ops

    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 32, 300, dtype=np.uint32)
    b = rng.integers(0, 1 << 32, 300, dtype=np.uint32)
    before = LAUNCHES["bitwise"]
    got = ops.bitwise_and(a, b)           # host operands go to the card
    torch.cuda.synchronize()
    assert LAUNCHES["bitwise"] == before + 1
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(to_uint32(got), a & b)


def test_direct_path_on_the_card_matches_the_host(cuda):
    """§8.1-§8.3 and the banked engine on card tensors equal the same
    calls on the host, and go through every new kernel."""
    from repro_torch.apps import bitmap_index, bitweaving
    from repro_torch.core import engine
    from repro_torch.ops import BitSet

    LAUNCHES.clear()
    db = bitmap_index.UserDatabase.synthetic(
        (1 << 16) + 5, 2, generator=torch.Generator(device=cuda)
        .manual_seed(1), device=cuda)
    host = bitmap_index.UserDatabase(db.daily.cpu(), db.male.cpu(),
                                     db.m_users)
    got, want = (bitmap_index.weekly_active_query(d) for d in (db, host))
    assert int(got[0]) == int(want[0])
    assert got[1].cpu().tolist() == want[1].tolist()
    assert bitmap_index.weekly_active_query_service(db)[0] == int(want[0])

    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << 12, 100_003, dtype=np.uint32)
    c_card, bv_card = bitweaving.scan_query(vals, 12, 500, 2500)
    c_host, bv_host = bitweaving.scan_query(vals, 12, 500, 2500,
                                            device="cpu")
    assert int(c_card) == int(c_host) == int(((vals >= 500)
                                              & (vals <= 2500)).sum())
    assert torch.equal(bv_card.words.cpu(), bv_host.words)

    elems = [rng.integers(0, 1 << 14, 500) for _ in range(4)]
    card = [BitSet.from_elements(e, 1 << 14) for e in elems]
    for op in ("union", "intersection", "difference"):
        banked = getattr(card[0], op)(*card[1:], banks=8)
        plain = getattr(card[0], op)(*card[1:])
        assert torch.equal(banked.bits.words, plain.bits.words)

    prog = _program(5)
    data = {f"D{i}": _card_words(cuda, rng, 4099) for i in range(6)}
    one = engine.execute(prog, data, outputs=["OUT"])["OUT"]
    eight = engine.execute(prog, data, outputs=["OUT"], n_banks=8)["OUT"]
    assert torch.equal(one, eight)
    # host rows go to the card by default, banked or not
    host = {k: v.cpu().numpy() for k, v in data.items()}
    for banks in (1, 8):
        out = engine.execute(prog, host, outputs=["OUT"], n_banks=banks)
        assert out["OUT"].is_cuda and torch.equal(out["OUT"], one)
    for name in ("bitwise", "bitwise_banked", "popcount", "bitweaving_scan",
                 "bit_transpose", "vm_materialize"):
        assert LAUNCHES[name] > 0, name


# ---------------------------------------------------------------------------
# TRA reliability and bit-serial arithmetic: majority, add / sub / lt and
# the bit untranspose
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("words", [1001, 1024])   # word / 16-byte path
@pytest.mark.parametrize("threshold", ["default", "one", "zero", "k+1"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 15, 31])
def test_majority_kernel_matches_plain(cuda, k, threshold, words):
    from repro_torch.kernels.majority import majority_kernel

    t = {"default": None, "one": 1, "zero": 0, "k+1": k + 1}[threshold]
    planes = _card_words(cuda, np.random.default_rng(k), k, 3, words)
    before = LAUNCHES["majority"]
    got = majority_kernel(planes, t)
    torch.cuda.synchronize()
    assert LAUNCHES["majority"] == before + 1
    assert torch.equal(got, ref.majority_k(planes, t))


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n_bits", [1, 7, 8, 32])
def test_bitserial_kernels_match_plain(cuda, n_bits, rows):
    from repro_torch.kernels.arith import (bitserial_add_kernel,
                                           bitserial_lt_kernel)

    rng = np.random.default_rng(n_bits + rows)
    a = _card_words(cuda, rng, n_bits, rows, 1001)
    b = _card_words(cuda, rng, n_bits, rows, 1001)
    b[..., :50] = a[..., :50]                   # equal lanes for lt
    for sub in (False, True):
        before = LAUNCHES["bitserial_add"]
        got = bitserial_add_kernel(a, b, sub)
        torch.cuda.synchronize()
        assert LAUNCHES["bitserial_add"] == before + 1
        assert torch.equal(got, ref.bitserial_add(a, b, sub))
    before = LAUNCHES["bitserial_lt"]
    got = bitserial_lt_kernel(a, b)
    torch.cuda.synchronize()
    assert LAUNCHES["bitserial_lt"] == before + 1
    assert torch.equal(got, ref.bitserial_lt(a, b))


@pytest.mark.parametrize("groups", [1, 37, 1001, 1 << 15])
@pytest.mark.parametrize("n_bits", [1, 8, 13, 32])
def test_bit_untranspose_kernel_matches_plain(cuda, n_bits, groups):
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(n_bits * groups)
    planes = _card_words(cuda, rng, n_bits, groups)
    before = LAUNCHES["bit_untranspose"]
    got = kops.bit_untranspose(planes, n_bits)
    torch.cuda.synchronize()
    assert LAUNCHES["bit_untranspose"] == before + 1
    assert torch.equal(got, ref.bit_untranspose(planes, n_bits))
    values = as_words(rng.integers(0, 1 << n_bits, 32 * groups,
                                   dtype=np.uint64).astype(np.uint32), cuda)
    assert torch.equal(kops.bit_untranspose(
        bit_transpose_kernel(values, n_bits), n_bits), values)
    wide = _card_words(cuda, rng, 32, groups)
    assert torch.equal(kops.bit_untranspose(wide, n_bits),
                       ref.bit_untranspose(wide, n_bits))


def test_fault_draw_on_the_card_is_deterministic_per_key(cuda):
    from repro_torch.core import errors

    lp = tlow.lower(_program(4))
    model = errors.TRAErrorModel(p_flip=0.01)

    def draw(key):
        return errors.error_planes(lp.table,
                                   errors.fault_generator(key, cuda), (3,),
                                   1001, model)

    a = draw((9, 1, 0))
    assert a.is_cuda and a.shape == (lp.n_cmds, 4, 3, 1001)
    assert torch.equal(a, draw((9, 1, 0)))
    assert not torch.equal(a, draw((9, 1, 1)))
    tra = torch.from_numpy((lp.table[:, 0] & tlow.KIND_TRA) != 0).to(cuda)
    assert a[tra].any() and not a[~tra].any()


def test_mitigated_execution_puts_host_rows_on_the_card(cuda):
    """Host rows go to the card by default: the masks are drawn there, the
    VM kernel runs every replica and the vote launches the majority."""
    from repro_torch.core import errors

    lp = tlow.lower(_program(5))
    rng = np.random.default_rng(11)
    data = {f"D{i}": rng.integers(0, 1 << 32, (2, 500), dtype=np.uint32)
            for i in range(6)}
    model = errors.TRAErrorModel(p_flip=0.01)
    LAUNCHES.clear()
    hit = errors.execute_injected(lp, data, ["OUT"], model=model, key=(3,))
    voted = errors.execute_voted(lp, data, ["OUT"], model=model, key=(3,))
    out, n = errors.execute_ecc(lp, data, ["OUT"], model=model, key=(3,))
    assert hit["OUT"].is_cuda and voted["OUT"].is_cuda and out["OUT"].is_cuda
    assert n == 3          # at this rate two replicas always disagree
    assert LAUNCHES["vm_materialize"] == 1 + 3 + n
    assert LAUNCHES["majority"] == 2


def test_mitigated_service_on_the_card_matches_the_clean_one(cuda):
    from repro_torch.core.errors import ReliabilityConfig, TRAErrorModel
    from repro_torch.service import WorkloadSpec, build_service, query_stream

    spec = WorkloadSpec(domain_bits=(1 << 14) + 7)
    clean = build_service(spec)
    want = [r.scalar for r in clean.query_batch(
        query_stream(spec, clean)).results]
    for mode in ("vote", "ecc"):
        svc = build_service(spec, reliability=ReliabilityConfig(
            mode=mode, model=TRAErrorModel(p_flip=1e-6), seed=1))
        LAUNCHES.clear()
        rep = svc.query_batch(query_stream(spec, svc))
        assert [r.scalar for r in rep.results] == want
        if mode == "vote":
            assert LAUNCHES["majority"] > 0
            assert svc.stats()["tra_corrected_bits"] > 0


def test_arith_ops_on_the_card_match_the_host(cuda):
    from repro_torch import ops

    rng = np.random.default_rng(8)
    n = (1 << 16) + 3
    a = rng.integers(0, 256, n, dtype=np.uint32)
    b = rng.integers(0, 256, n, dtype=np.uint32)
    LAUNCHES.clear()
    ca, cb = (ops.VerticalColumn.encode(x, 8) for x in (a, b))
    ha, hb = (ops.VerticalColumn.encode(x, 8, device="cpu") for x in (a, b))
    for fn in (ops.add_columns, ops.sub_columns):
        card, host = fn(ca, cb), fn(ha, hb)
        assert torch.equal(card.planes.cpu(), host.planes)
        assert torch.equal(ops.from_vertical(card.planes, 8).cpu(),
                           ops.from_vertical(host.planes, 8))
    assert torch.equal(ops.lt_columns(ca, cb).words.cpu(),
                       ops.lt_columns(ha, hb).words)
    assert ops.sum_column(ca) == ops.sum_column(ha) == int(a.sum())
    for banks in (1, 8):
        assert torch.equal(ops.add_columns_dram(ca, cb, n_banks=banks)
                           .planes.cpu(),
                           ops.add_columns_dram(ha, hb, n_banks=banks)
                           .planes)
    for name in ("bitserial_add", "bitserial_lt", "bit_untranspose",
                 "vm_materialize"):
        assert LAUNCHES[name] > 0, name
    with pytest.raises(ValueError, match="use_kernel"):
        ops.add_columns(ca, cb, use_kernel=False)


# ---------------------------------------------------------------------------
# flash attention and the LM serving path
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, hd, causal, block_q, block_k): the JAX package's five
# test shapes, ragged lengths that are not a multiple of the 64-row tile,
# Sq != Sk without the causal mask and with it (positions aligned at 0),
# and at head dim 128 (bf16 there runs the Hopper kernels, whose tiles are
# 128 rows) GQA groups of 1 and 8, lengths of 130 and 1,000, and B H =
# 144 query heads, more than the card's 132 SMs; the MoE configs' heads:
# a group of 5 (Llama-4 Maverick's 40 over 8) and head dim 112 (Kimi K2's)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 32, True, 32, 32),
    (2, 128, 128, 4, 2, 32, False, 32, 32),
    (1, 100, 100, 4, 4, 16, False, 32, 32),
    (1, 80, 80, 8, 2, 64, True, 32, 16),
    (2, 64, 64, 8, 8, 128, True, 64, 64),
    (1, 1000, 1000, 16, 8, 128, True, 512, 512),
    (3, 77, 77, 4, 1, 64, True, 32, 32),
    (1, 64, 100, 4, 4, 32, False, 32, 32),
    (2, 100, 1000, 8, 2, 128, False, 64, 128),
    (1, 100, 160, 4, 2, 64, True, 32, 32),
    (1, 160, 100, 4, 2, 64, True, 32, 32),
    (1, 130, 130, 16, 16, 128, True, 64, 64),
    (1, 1000, 1000, 16, 2, 128, True, 512, 512),
    (1, 1000, 130, 16, 2, 128, True, 512, 128),
    (9, 256, 256, 16, 8, 128, True, 128, 128),
    (1, 256, 256, 40, 8, 128, True, 128, 128),
    (1, 200, 200, 64, 8, 112, True, 64, 64),
    (2, 100, 160, 8, 2, 112, False, 32, 32),
]
# the JAX package's bounds against its oracle, relative to each element
# and to the plain output's RMS (an absolute bound of the same size as the
# outputs of a long causal row would admit a dropped key tile)
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


def _assert_flash_close(got, want, tol):
    g, w = got.float(), want.float()
    bound = tol * (w.pow(2).mean().sqrt() + w.abs())
    excess = float(((g - w).abs() - bound).max())
    assert bool(torch.isfinite(g).all()) and excess <= 0, excess


def _qkv(cuda, seed, dtype, B, Sq, Sk, H, KV, hd):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(B, n, h, hd, generator=g, device=cuda).to(dtype)
                 for n, h in ((Sq, H), (Sk, KV), (Sk, KV)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,bq,bk", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, hd, causal, bq,
                                    bk, dtype):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flashattn import flash_attention_plain

    q, k, v = _qkv(cuda, Sq * hd + Sk, dtype, B, Sq, Sk, H, KV, hd)
    before = LAUNCHES["flash_attention"]
    got = kops.flash_attention(q, k, v, causal=causal, block_q=bq,
                               block_k=bk)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype and got.is_cuda
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal, bq,
                                 bk).transpose(1, 2)
    _assert_flash_close(got, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_and_misaligned_operands(cuda, dtype):
    """Operands that are views (a head-dim slice of a wider tensor) are
    read in place; a bf16 operand 2 bytes off a 16-byte boundary is
    copied first. Both agree with contiguous operands."""
    from repro_torch.kernels.flashattn import flash_attention_kernel

    q, k, v = _qkv(cuda, 5, dtype, 2, 96, 96, 4, 2, 64)
    want = flash_attention_kernel(q, k, v)
    wide = torch.cat([q, q], dim=-1)[..., :64]          # head stride 128
    flat = torch.empty(k.numel() + 1, dtype=dtype, device=cuda)
    flat[1:] = k.reshape(-1)
    shifted = flat[1:].view(k.shape)                    # 2 or 4 bytes off
    got = flash_attention_kernel(wide, shifted, v)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.flashattn import flash_attention_kernel

    q, k, v = _qkv(cuda, 1, torch.bfloat16, 1, 16, 16, 2, 1, 48)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_kernel(q, k, v)
    q, k, v = _qkv(cuda, 1, torch.float16, 1, 16, 16, 2, 1, 32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_kernel(q, k, v)


def test_serving_path_on_the_card_launches_flash_per_layer(cuda):
    """Reduced Qwen3-0.6B on the card: one flash launch per prefill layer,
    and the card's logits and ids agree with the same weights on the
    host."""
    import copy

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import build
    from repro_torch.serve import extend_cache, generate

    cfg = reduced(get_config("qwen3_0p6b"))
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
    host = build(cfg, device="cpu")
    host_params = copy.deepcopy(params).to("cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 100))
    LAUNCHES.clear()
    ids = generate(bundle, params, {"tokens": toks[:, :99]}, 4)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == cfg.n_layers
    assert ids.is_cuda and ids.shape == (2, 4)
    got, cache = bundle.prefill(params, {"tokens": toks[:, :99]})
    want, _ = host.prefill(host_params, {"tokens": toks[:, :99]})
    err = (got.cpu().float() - want.float()).abs().max() / \
        want.float().abs().max()
    assert err < 0.05, err
    full, _ = bundle.prefill(params, {"tokens": toks})
    step, _ = bundle.decode_step(params, toks[:, 99], extend_cache(cache, 1),
                                 99)
    err = (step.float() - full.float()).abs().max() / full.float().abs().max()
    assert err < 0.05, err
    with pytest.raises(ValueError, match="different devices"):
        bundle.prefill(params, {"tokens": torch.from_numpy(toks)})


def test_moe_serving_on_the_card_matches_the_host(cuda):
    """Reduced Llama-4 Maverick (dense and MoE layers) in float32 on the
    card: one flash launch per prefill layer; prefill and decode logits
    agree with the same weights on the host, at the config's capacity and
    at one that drops tokens."""
    import copy
    import dataclasses

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import build
    from repro_torch.serve import extend_cache

    for cf in (1.25, 0.25):
        cfg = dataclasses.replace(reduced(get_config(
            "llama4_maverick_400b_a17b")), dtype="float32",
            capacity_factor=cf)
        bundle, host = build(cfg), build(cfg, device="cpu")
        params = bundle.init(torch.Generator(device=cuda).manual_seed(1))
        host_params = copy.deepcopy(params).to("cpu")
        toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 65))
        LAUNCHES.clear()
        got, cache = bundle.prefill(params, {"tokens": toks[:, :64]})
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == cfg.n_layers
        want, host_cache = host.prefill(host_params,
                                        {"tokens": toks[:, :64]})
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert err < 1e-4, (cf, err)
        got, _ = bundle.decode_step(params, toks[:, 64],
                                    extend_cache(cache, 1), 64)
        want, _ = host.decode_step(host_params, toks[:, 64],
                                   extend_cache(host_cache, 1), 64)
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert err < 1e-4, (cf, err)


# the serving families' flash shapes, forward and lse forward: Zamba2's
# head dim 80 (32 heads over 32) causal and not at a ragged length,
# SeamlessM4T's non-causal head dim 64 with Sq != Sk, and the VLM's
# cross-attention on the head-dim-128 Hopper kernel (Sk not a multiple of
# the 128-key tile, a GQA group of 8); then the edges of the Hopper route
# at head dims 64, 80 and 112: Sk 100 (under one 128-key tile), Sq 130 (a
# second, nearly empty query tile), GQA groups of 2 and 8 (Kimi K2's), and
# B H = 144 and 160 query heads, more than the card's 132 SMs
SERVE_FLASH_CASES = [
    (2, 300, 300, 32, 32, 80, True),
    (2, 300, 300, 32, 32, 80, False),
    (1, 77, 200, 4, 4, 80, False),
    (2, 512, 256, 16, 16, 64, False),
    (1, 512, 400, 64, 8, 128, False),
    (1, 130, 100, 16, 8, 64, True),
    (9, 130, 100, 16, 8, 64, False),
    (1, 130, 100, 16, 8, 80, True),
    (5, 130, 100, 32, 16, 80, False),
    (1, 130, 100, 64, 8, 112, True),
    (9, 130, 100, 16, 2, 112, False),
    (2, 300, 1000, 32, 16, 112, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", SERVE_FLASH_CASES)
def test_serving_family_flash_shapes_match_plain(cuda, B, Sq, Sk, H, KV, hd,
                                                 causal, dtype):
    from repro_torch.kernels import flashattn as F

    q, k, v = _qkv(cuda, Sq * hd + Sk + 1, dtype, B, Sq, Sk, H, KV, hd)
    got = F.flash_attention_kernel(q, k, v, causal)
    o, lse = F.flash_attention_fwd_kernel(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(o, got)
    want, plse = F.flash_attention_fwd_plain(q.transpose(1, 2),
                                             k.transpose(1, 2),
                                             v.transpose(1, 2), causal)
    _assert_flash_close(got, want.transpose(1, 2), FLASH_TOL[dtype])
    _assert_flash_close(lse, plse, 1e-4)


@pytest.mark.parametrize("hd", [80, 112])
def test_flash_kernel_reads_fused_qkv_in_place(cuda, hd):
    """q, k and v sliced from one fused (B, S, 3, H, hd) projection are
    strided views (160- or 224-byte heads, 3 H hd-element rows) that the
    tensor maps read in place: the serving and lse forwards and the
    backward equal those of contiguous copies, and the output lies within
    the gate of the plain version's."""
    from repro_torch.kernels import flashattn as F

    B, S, H = 2, 200, 8
    g = torch.Generator(device=cuda).manual_seed(21)
    qkv = torch.randn(B, S, 3, H, hd, generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and q.stride(1) == 3 * H * hd
    dense = [x.contiguous() for x in (q, k, v)]
    do = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    LAUNCHES.clear()
    got = F.flash_attention_kernel(q, k, v)
    want = F.flash_attention_kernel(*dense)
    o, lse = F.flash_attention_fwd_kernel(q, k, v)
    grads = F.flash_attention_bwd_kernel(q, k, v, o, lse, do)
    grads_dense = F.flash_attention_bwd_kernel(*dense, o, lse, do)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"flash_attention": 2, "flash_attention_fwd": 1,
                              "flash_attention_bwd": 2}
    assert torch.equal(got, want) and torch.equal(o, got)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_dense))
    plain = F.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2))
    _assert_flash_close(got, plain.transpose(1, 2),
                        FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("hd,causal", [(64, False), (64, True), (80, True),
                                       (112, True), (112, False)])
def test_flash_fwd_kernel_is_deterministic(cuda, hd, causal):
    """The Hopper forward at head dims 64, 80 and 112 gives the same bits over
    two runs, serving and lse forward alike (bf16, B H = 144 query heads
    over the card's 132 SMs, ragged Sq and Sk)."""
    from repro_torch.kernels import flashattn as F

    q, k, v = _qkv(cuda, 13, torch.bfloat16, 9, 1000, 300, 16, 8, hd)
    first = F.flash_attention_kernel(q, k, v, causal)
    second = F.flash_attention_kernel(q, k, v, causal)
    o1, lse1 = F.flash_attention_fwd_kernel(q, k, v, causal)
    o2, lse2 = F.flash_attention_fwd_kernel(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(o1, o2)
    assert torch.equal(lse1, lse2) and torch.equal(o1, first)


#: the backward's cases at head dims 64, 80 and 112: Zamba2's shared attention
#: (32 heads over 32, 1,000 queries, causal and not), a GQA group of 2,
#: ragged query tiles, Sq < Sk, B H = 160 query heads (over the card's
#: 132 SMs), then SeamlessM4T's forms: its cross attention (2 Sk queries
#: over Sk keys, not causal) and its decoder (causal 4,096, 16 heads
#: over 16)
HOPPER_BWD_CASES = [
    (1, 1000, 1000, 32, 32, True),
    (1, 1000, 1000, 32, 32, False),
    (2, 300, 300, 8, 4, True),
    (1, 77, 100, 4, 2, False),
    (5, 130, 130, 32, 16, True),
    (2, 2048, 1024, 16, 16, False),
    (1, 4096, 4096, 16, 16, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 80, 112])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal", HOPPER_BWD_CASES)
def test_flash_bwd_kernel_at_head_dims_64_80_and_112_matches_plain(
        cuda, B, Sq, Sk, H, KV, causal, hd, dtype):
    """The backward at head dims 64, 80 and 112 (bf16: the Hopper kernels
    `flash_bwd_dq_sm90_kernel<HD, true>` and `flash_bwd_dkv_sm90_kernel<HD,
    true>`; float32: their 3xTF32 counterparts) within the gate of the
    plain backward, and bit-identical over two runs."""
    from repro_torch.kernels import flashattn as F

    q, k, v = _qkv(cuda, Sq + Sk + H + hd, dtype, B, Sq, Sk, H, KV, hd)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(Sq + 1), device=cuda).to(dtype)
    o, lse = F.flash_attention_fwd_kernel(q, k, v, causal)
    before = LAUNCHES["flash_attention_bwd"]
    first = F.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
    second = F.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 2
    want = F.flash_attention_bwd_plain(_hm(q), _hm(k), _hm(v), _hm(o), lse,
                                       _hm(do), causal)
    for got, again, w, like in zip(first, second, want, (q, k, v)):
        assert got.shape == like.shape and got.dtype == dtype
        assert torch.equal(got, again)
        _assert_flash_close(got, _hm(w), FLASH_TOL[dtype])


#: the Hopper route's edges: 100 keys under 130 queries (less than one
#: key tile), 300 queries (ragged query tiles) over 1,000 and 100 keys,
#: GQA groups of 2 and 8, B H = 144 and 160 query heads (over the card's
#: 132 SMs), causal and not
HOPPER_EDGES = [
    (1, 130, 100, 16, 8, True),
    (9, 300, 1000, 16, 8, False),
    (2, 300, 300, 8, 4, True),
    (5, 300, 100, 32, 16, False),
    (1, 300, 1000, 64, 8, True),
]


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64),
                                      (torch.float32, 80),
                                      (torch.float32, 112),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 16),
                                      (torch.bfloat16, 32)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal", HOPPER_EDGES)
def test_flash_kernels_at_hopper_edges_match_plain(cuda, B, Sq, Sk, H, KV,
                                                   causal, dtype, hd):
    """The float32 3xTF32 kernels (forward, lse forward and backward) and
    the bf16 Hopper backward at head dims 16 and 32 at the edges of their
    tiles, within the gate of the plain versions, the lse within 1e-4 and
    the backward bit-identical over two runs."""
    from repro_torch.kernels import flashattn as F

    q, k, v = _qkv(cuda, Sq + Sk + H + hd, dtype, B, Sq, Sk, H, KV, hd)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(Sq + 2), device=cuda).to(dtype)
    before = dict(LAUNCHES)
    out = F.flash_attention_kernel(q, k, v, causal)
    o, lse = F.flash_attention_fwd_kernel(q, k, v, causal)
    first = F.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
    second = F.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] - before.get(n, 0) for n in (
        "flash_attention", "flash_attention_fwd", "flash_attention_bwd")} \
        == {"flash_attention": 1, "flash_attention_fwd": 1,
            "flash_attention_bwd": 2}
    want_o, want_lse = F.flash_attention_fwd_plain(_hm(q), _hm(k), _hm(v),
                                                   causal)
    assert torch.equal(out, o)
    _assert_flash_close(o, _hm(want_o), FLASH_TOL[dtype])
    _assert_flash_close(lse, want_lse, 1e-4)
    want = F.flash_attention_bwd_plain(_hm(q), _hm(k), _hm(v), _hm(o), lse,
                                       _hm(do), causal)
    for got, again, w, like in zip(first, second, want, (q, k, v)):
        assert got.shape == like.shape and got.dtype == dtype
        assert torch.equal(got, again)
        _assert_flash_close(got, _hm(w), FLASH_TOL[dtype])


def test_float32_path_launches_the_tf32_kernels(cuda):
    """In float32, `ops.flash_attention` with grad on counts one lse
    forward and one backward on the wrappers' counters, and the card runs
    the 3xTF32 kernels and their pre-pass, not the bf16 ones."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops as kops

    q, k, v = (x.requires_grad_() for x in
               _qkv(cuda, 19, torch.float32, 2, 200, 200, 8, 2, 128))
    LAUNCHES.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = kops.flash_attention(q, k, v)
        out.pow(2).sum().backward()
        torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"flash_attention_fwd": 1,
                              "flash_attention_bwd": 1}
    names = " ".join(e.key for e in prof.key_averages())
    for kernel in ("flash_fwd_tf32_sm90_kernel", "tf32_split_kernel",
                   "flash_bwd_dq_tf32_sm90_kernel",
                   "flash_bwd_dkv_tf32_sm90_kernel"):
        assert kernel in names, kernel
    assert "flash_fwd_sm90_kernel" not in names
    assert "flash_bwd_dq_sm90_kernel" not in names


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_2p7b",
                                  "seamless_m4t_medium",
                                  "llama_3p2_vision_90b"])
def test_serving_families_on_the_card_match_the_host(cuda, arch):
    """Reduced SSM, hybrid, enc-dec and VLM configs in float32 on the card:
    the exact flash launches of a prefill (none for Mamba2), and prefill
    and decode logits within 1e-4 of the same weights on the host."""
    import copy
    import dataclasses

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.pipeline import frontend_name
    from repro_torch.models import build
    from repro_torch.serve import extend_cache

    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    bundle, host = build(cfg), build(cfg, device="cpu")
    params = bundle.init(torch.Generator(device=cuda).manual_seed(2))
    host_params = copy.deepcopy(params).to("cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 41))
    batch = {"tokens": toks[:, :40]}
    if cfg.frontend:
        batch[frontend_name(cfg)] = rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    flash = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
             "encdec": cfg.n_enc_layers + 2 * cfg.n_layers,
             "vlm": cfg.n_layers + cfg.n_layers // max(cfg.cross_attn_every,
                                                       1)}[cfg.family]
    LAUNCHES.clear()
    got, cache = bundle.prefill(params, batch)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == ({"flash_attention": flash} if flash else {})
    want, host_cache = host.prefill(host_params, batch)
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err < 1e-4, err
    got, _ = bundle.decode_step(params, toks[:, 40], extend_cache(cache, 1),
                                40)
    want, _ = host.decode_step(host_params, toks[:, 40],
                               extend_cache(host_cache, 1), 40)
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err < 1e-4, err


# ---------------------------------------------------------------------------
# the training path: flash forward with lse, its backward, sign packing
# ---------------------------------------------------------------------------


def _hm(x):
    return x.transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,bq,bk", FLASH_CASES)
def test_flash_fwd_and_bwd_kernels_match_plain(cuda, B, Sq, Sk, H, KV, hd,
                                               causal, bq, bk, dtype):
    from repro_torch.kernels import flashattn as F

    q, k, v = _qkv(cuda, Sq * hd + Sk + 1, dtype, B, Sq, Sk, H, KV, hd)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(Sq), device=cuda).to(dtype)
    before = dict(LAUNCHES)
    o, lse = F.flash_attention_fwd_kernel(q, k, v, causal)
    dq, dk, dv = F.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == \
        before.get("flash_attention_fwd", 0) + 1
    assert LAUNCHES["flash_attention_bwd"] == \
        before.get("flash_attention_bwd", 0) + 1
    assert torch.equal(o, F.flash_attention_kernel(q, k, v, causal))
    po, plse = F.flash_attention_fwd_plain(_hm(q), _hm(k), _hm(v), causal,
                                           bq, bk)
    _assert_flash_close(o, _hm(po), FLASH_TOL[dtype])
    _assert_flash_close(lse, plse, 1e-4)
    want = F.flash_attention_bwd_plain(_hm(q), _hm(k), _hm(v), _hm(o), lse,
                                       _hm(do), causal, bq, bk)
    for got, w, like in zip((dq, dk, dv), want, (q, k, v)):
        assert got.shape == like.shape and got.dtype == dtype
        _assert_flash_close(got, _hm(w), FLASH_TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal", [
    (2, 1000, 1000, 16, 8, True), (2, 100, 1000, 8, 2, False)])
def test_flash_bwd_kernel_is_deterministic(cuda, B, Sq, Sk, H, KV, causal):
    """The backward sums in registers, never with atomics: two runs on
    the same inputs give bit-identical dq, dk and dv (bf16, head dim 128:
    the Hopper kernels)."""
    from repro_torch.kernels import flashattn as F

    q, k, v = _qkv(cuda, 11, torch.bfloat16, B, Sq, Sk, H, KV, 128)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(12), device=cuda).to(torch.bfloat16)
    o, lse = F.flash_attention_fwd_kernel(q, k, v, causal)
    first = F.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
    second = F.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_function_on_the_card_launches_fwd_and_bwd(cuda):
    """With grad on, `ops.flash_attention` launches the lse forward and,
    in the backward, the backward kernel, once each; without it, the
    serving kernel."""
    from repro_torch.kernels import ops as kops

    q, k, v = (x.requires_grad_() for x in
               _qkv(cuda, 9, torch.bfloat16, 2, 200, 200, 8, 2, 64))
    LAUNCHES.clear()
    out = kops.flash_attention(q, k, v)
    out.float().pow(2).sum().backward()
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"flash_attention_fwd": 1,
                              "flash_attention_bwd": 1}
    assert q.grad.shape == q.shape and k.grad.dtype == torch.bfloat16
    with torch.no_grad():
        kops.flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32), (3, 32 * 1001), (5, 32 * 7),
                                   (1, 1 << 20)])
def test_sign_pack_kernels_match_plain(cuda, shape, dtype):
    from repro_torch.kernels.signpack import (pack_signs_kernel,
                                              unpack_signs_kernel)

    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1.0, -1.0, -0.0], device=cuda)
    n = min(8, shape[-1])
    x[:, :n] = special[:n].to(dtype)
    before = dict(LAUNCHES)
    words = pack_signs_kernel(x)
    signs = unpack_signs_kernel(words, dtype)
    torch.cuda.synchronize()
    assert LAUNCHES["pack_signs"] == before.get("pack_signs", 0) + 1
    assert LAUNCHES["unpack_signs"] == before.get("unpack_signs", 0) + 1
    assert torch.equal(words, ref.pack_signs(x))
    assert torch.equal(signs, ref.unpack_signs(words, dtype))
    # the IEEE sign bit: -0.0 packs as 1 and unpacks as -1
    assert torch.equal(signs, torch.where(torch.signbit(x), -1.0, 1.0)
                       .to(dtype))
    assert float(signs[0, 1]) == -1.0


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_on_the_card(cuda, accum):
    """Reduced Qwen3-0.6B on the card: the step launches the lse forward
    twice per layer and microbatch and the backward once; accumulated
    gradients are float32; loss and gradients agree with the same
    weights on the host (plain attention)."""
    import copy

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.optim import adamw, constant
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads

    cfg = reduced(get_config("qwen3_0p6b"))
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
    host_params = copy.deepcopy(params).to("cpu")
    batch = SyntheticLM(cfg.vocab_size, 96, 4, seed=1, device=cuda).batch(0)
    LAUNCHES.clear()
    loss, _, grads = loss_and_grads(bundle, params, batch, accum)
    torch.cuda.synchronize()
    n = cfg.n_layers * accum
    assert dict(LAUNCHES) == {"flash_attention_fwd": 2 * n,
                              "flash_attention_bwd": n}
    want_dtype = torch.float32 if accum > 1 else torch.bfloat16
    assert all(g.dtype == want_dtype and g.is_cuda for g in grads.values())
    host = build(cfg, device="cpu")
    hloss, _, hgrads = loss_and_grads(
        host, host_params, {k: x.cpu() for k, x in batch.items()}, accum)
    assert abs(float(loss) - float(hloss)) < 5e-3 * abs(float(hloss))
    for name, g in hgrads.items():
        d = (grads[name].cpu().float() - g.float()).pow(2).mean().sqrt()
        assert float(d) <= 0.05 * float(g.float().pow(2).mean().sqrt()) \
            + 1e-12, name
    opt = adamw(constant(1e-3))
    step = make_train_step(bundle, opt, grad_accum=accum)
    _, _, m = step(params, opt.init(params), 0, batch)
    assert bool(torch.isfinite(m["loss"])) and m["loss"].is_cuda


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_2p7b",
                                  "seamless_m4t_medium",
                                  "llama_3p2_vision_90b"])
def test_training_families_on_the_card(cuda, arch):
    """Reduced SSM, hybrid, enc-dec and VLM configs in float32 on the
    card: one step of two microbatches launches the lse forward twice per
    attention and microbatch and the backward once (nothing for Mamba2);
    loss and gradients agree with the same weights on the host, the loss
    within 1e-4 relative and each leaf within 1e-3 of its largest
    magnitude (in bf16 the reduced Zamba2's SSM scalar gradients, sums of
    terms that cancel, differed between card and host by more than 0.05
    of their RMS); an AdamW step gives a finite loss on the card."""
    import dataclasses
    import copy

    from repro_torch.configs.base import ShapeConfig, get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.optim import adamw, constant
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=cuda).manual_seed(3))
    host_params = copy.deepcopy(params).to("cpu")
    batch = SyntheticLM.for_cell(cfg, ShapeConfig("card", 96, 4, "train"),
                                 seed=4, device=cuda).batch(0)
    attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
            "encdec": cfg.n_enc_layers + 2 * cfg.n_layers,
            "vlm": cfg.n_layers + cfg.n_layers // max(cfg.cross_attn_every,
                                                      1)}[cfg.family]
    LAUNCHES.clear()
    loss, _, grads = loss_and_grads(bundle, params, batch, 2)
    torch.cuda.synchronize()
    assert {k: n for k, n in LAUNCHES.items() if n} == (
        {"flash_attention_fwd": 4 * attn, "flash_attention_bwd": 2 * attn}
        if attn else {})
    assert all(g.dtype == torch.float32 and g.is_cuda
               for g in grads.values())
    host = build(cfg, device="cpu")
    hloss, _, hgrads = loss_and_grads(
        host, host_params, {k: x.cpu() for k, x in batch.items()}, 2)
    assert abs(float(loss) - float(hloss)) < 1e-4 * abs(float(hloss))
    for name, g in hgrads.items():
        d = (grads[name].cpu() - g).abs().max()
        assert float(d) <= 1e-3 * float(g.abs().max()) + 1e-12, name
    opt = adamw(constant(1e-3))
    step = make_train_step(bundle, opt, grad_accum=2)
    _, _, m = step(params, opt.init(params), 0, batch)
    assert bool(torch.isfinite(m["loss"])) and m["loss"].is_cuda


@pytest.mark.parametrize("dtype,B,Sq,Sk,causal", [
    (torch.bfloat16, 1, 4096, 4096, True),
    (torch.bfloat16, 1, 300, 1000, False),
    (torch.float32, 1, 300, 1000, False)])
def test_flash_fwd_and_bwd_at_kimi_head_layout(cuda, dtype, B, Sq, Sk,
                                               causal):
    """Head dim 112 at Kimi K2's heads (64 query heads over 8): the lse
    forward and the backward (in bf16 the Hopper kernels
    `flash_fwd_sm90_kernel<112>` and `flash_bwd_{dq,dkv}_sm90_kernel<112,
    true>`; in float32 scalar FMAs) against their plain versions, at the
    training path's causal 4,096 and a ragged non-causal shape."""
    from repro_torch.kernels import flashattn as F

    q, k, v = _qkv(cuda, Sq + Sk, dtype, B, Sq, Sk, 64, 8, 112)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(Sk), device=cuda).to(dtype)
    LAUNCHES.clear()
    o, lse = F.flash_attention_fwd_kernel(q, k, v, causal)
    dq, dk, dv = F.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"flash_attention_fwd": 1,
                              "flash_attention_bwd": 1}
    po, plse = F.flash_attention_fwd_plain(_hm(q), _hm(k), _hm(v), causal,
                                           512, 512)
    _assert_flash_close(o, _hm(po), FLASH_TOL[dtype])
    _assert_flash_close(lse, plse, 1e-4)
    want = F.flash_attention_bwd_plain(_hm(q), _hm(k), _hm(v), _hm(o), lse,
                                       _hm(do), causal, 512, 512)
    for got, w in zip((dq, dk, dv), want):
        _assert_flash_close(got, _hm(w), FLASH_TOL[dtype])


@pytest.mark.parametrize("arch", ["llama4_maverick_400b_a17b",
                                  "kimi_k2_1t_a32b"])
def test_moe_training_on_the_card(cuda, arch):
    """Reduced Maverick and Kimi K2 in float32 at their published head
    dims (128, 112) on the card: one microbatch launches the lse forward
    twice per attention and the backward once; the loss, its aux and
    every gradient leaf agree with the same step with the plain attention
    forward and backward swapped in (loss within 1e-4 relative, each leaf
    within 1e-3 of its largest magnitude); the gradients keep the
    parameters' dtypes; an Adafactor step gives a finite loss."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flashattn as F
    from repro_torch.models import build
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.optim import adafactor, constant
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(
        reduced(get_config(arch)), dtype="float32",
        head_dim=get_config(arch).head_dim)
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=cuda).manual_seed(5))
    batch = SyntheticLM.for_cell(cfg, ShapeConfig("card", 200, 2, "train"),
                                 seed=6, device=cuda).batch(0)
    LAUNCHES.clear()
    loss, metrics, grads = loss_and_grads(bundle, params, batch, 1)
    torch.cuda.synchronize()
    n = len(layer_kinds(cfg))
    assert {k: c for k, c in LAUNCHES.items() if c} == {
        "flash_attention_fwd": 2 * n, "flash_attention_bwd": n}
    named = dict(params.named_parameters())
    assert all(g.dtype == named[k].dtype and g.is_cuda
               for k, g in grads.items())

    def fwd(q, k, v, causal=True, block_q=512, block_k=512):
        o, lse = F.flash_attention_fwd_plain(_hm(q), _hm(k), _hm(v), causal,
                                             block_q, block_k)
        return _hm(o), lse

    def bwd(q, k, v, o, lse, do, causal=True, block_q=512, block_k=512):
        return tuple(_hm(g) for g in F.flash_attention_bwd_plain(
            _hm(q), _hm(k), _hm(v), _hm(o), lse, _hm(do), causal, block_q,
            block_k))

    saved = F.flash_attention_fwd_kernel, F.flash_attention_bwd_kernel
    F.flash_attention_fwd_kernel, F.flash_attention_bwd_kernel = fwd, bwd
    try:
        ploss, pmetrics, pgrads = loss_and_grads(bundle, params, batch, 1)
    finally:
        F.flash_attention_fwd_kernel, F.flash_attention_bwd_kernel = saved
    assert abs(float(loss) - float(ploss)) < 1e-4 * abs(float(ploss))
    assert float(metrics["aux"]) == pytest.approx(float(pmetrics["aux"]),
                                                  rel=1e-4)
    for name, g in pgrads.items():
        d = (grads[name] - g).abs().max()
        assert float(d) <= 1e-3 * float(g.abs().max()) + 1e-12, name
    opt = adafactor(constant(1e-3))
    step = make_train_step(bundle, opt)
    _, _, m = step(params, opt.init(params), 0, batch)
    assert bool(torch.isfinite(m["loss"])) and m["loss"].is_cuda


def test_clip_makes_no_float32_copy_of_a_large_gradient(cuda):
    """`clip_by_global_norm` on a bf16 gradient of 2^29 elements (an
    expert weight's size class) scales it in place, a slice of
    `CHUNK_ELEMS` at a time: the card's peak memory grows by at most two
    float32 slices (512 MB), a quarter of the 2 GiB float32 copy that a
    whole-tensor pass would make."""
    from repro_torch.optim import optimizers as O

    g = torch.randn(1 << 13, 1 << 16, device=cuda).to(torch.bfloat16)
    want = (g.float() * torch.clamp(1.0 / g.float().norm(), max=1.0)).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = {"wi": g}
    out, _ = O.clip_by_global_norm(grads, 1.0)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert out is grads and out["wi"] is g
    assert grown <= 2 * 4 * O.CHUNK_ELEMS + (1 << 20), grown
    assert (g.float() - want.float()).abs().max() <= 2 ** -7 * float(
        want.float().abs().max())


@pytest.mark.parametrize("name", ["adafactor", "adamw"])
def test_optimizers_make_no_float32_copy_of_an_expert_weight(cuda, name):
    """One Adafactor / AdamW update of a bf16 expert weight of 2^29
    elements ((E, D, 2, F) = (64, 1,024, 2, 4,096)) takes it in slices
    of `CHUNK_ELEMS`: beyond the state, the card's peak memory grows by
    less than one float32 copy of the whole weight (2 GiB; a whole-leaf
    pass holds three), and the updated weight is finite and moved. The
    CPU tests hold the sliced arithmetic to the whole-leaf one."""
    from repro_torch.optim import constant, get_optimizer

    gen = torch.Generator(device=cuda).manual_seed(8)
    shape = (64, 1024, 2, 4096)
    p = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    before = p[:2].clone()
    g = (0.01 * torch.randn(shape, generator=gen, device=cuda)).to(
        torch.bfloat16)
    opt = get_optimizer(name, constant(1e-3))
    state = opt.init({"wi": p})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    opt.update({"wi": g}, state, {"wi": p}, 0)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown < 4 * p.numel(), grown
    assert bool(torch.isfinite(p[:2].float()).all())
    assert not torch.equal(p[:2], before)


@pytest.mark.parametrize("reduce", [None, "popcount", "aggregate"])
def test_run_megakernel_on_the_card_matches_the_host(cuda, reduce):
    """`make_plane` + `run_megakernel` (the named-row helpers) launch the
    VM on the card and agree with the same call on the host, with a
    batch of 3 and, in the count modes, a per-word mask."""
    from repro_torch.kernels.ops import run_megakernel

    lp = tlow.lower(_program(11))
    rng = np.random.default_rng(11)
    words = 300
    data = {f"D{i}": rng.integers(0, 1 << 32, (3, words), dtype=np.uint32)
            for i in range(6)}
    mask = None if reduce is None else rng.integers(0, 1 << 32, (words,),
                                                    dtype=np.uint32)
    plane = tlow.make_plane(lp, data, words, batch=(3,), device=cuda)
    assert plane.is_cuda
    before = LAUNCHES["vm_popcount"] + LAUNCHES["vm_materialize"]
    got = run_megakernel(lp, plane, ["OUT"], reduce=reduce, mask=mask)
    torch.cuda.synchronize()
    assert LAUNCHES["vm_popcount"] + LAUNCHES["vm_materialize"] == before + 1
    host = tlow.make_plane(lp, data, words, batch=(3,), device="cpu")
    want = run_megakernel(lp, host, ["OUT"], reduce=reduce, mask=mask)
    assert torch.equal(got.cpu(), want)


def test_remat_dots_on_the_card_equals_block(cuda):
    """Reduced Qwen3-0.6B in bf16 on the card: "dots" launches the flash
    forward and backward as "block" does and gives the same loss and
    gradients."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.train.step import loss_and_grads

    cfg = reduced(get_config("qwen3_0p6b"))
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    batch = SyntheticLM(cfg.vocab_size, 96, 4, seed=1, device=cuda).batch(0)
    out = {}
    for remat in ("block", "dots"):
        LAUNCHES.clear()
        out[remat] = loss_and_grads(build(cfg, remat=remat), params, batch)
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == {"flash_attention_fwd": 2 * cfg.n_layers,
                                  "flash_attention_bwd": cfg.n_layers}
    assert torch.equal(out["dots"][0], out["block"][0])
    for name, g in out["block"][2].items():
        d = (out["dots"][2][name].float() - g.float()).pow(2).mean().sqrt()
        assert float(d) <= 0.05 * float(g.float().pow(2).mean().sqrt()) \
            + 1e-12, name


def test_hlocost_count_on_the_card_allocates_nothing(cuda):
    """A reduced train step counted on meta beside the card: no card
    memory moves, and the roofline prices it against this card's row."""
    from repro_torch import hw
    from repro_torch.configs.base import ShapeConfig, get_config, reduced
    from repro_torch.launch import hlocost, roofline
    from repro_torch.models import build, input_specs
    from repro_torch.optim import adamw, constant
    from repro_torch.train import make_train_step

    cfg = reduced(get_config("qwen3_0p6b"))
    shape = ShapeConfig("t", 64, 2, "train")
    bundle = build(cfg)
    params, _ = bundle.abstract()
    opt = adamw(constant(1e-3))
    state = opt.init(params)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cost = hlocost.count(make_train_step(bundle, opt), params, state, 0,
                         input_specs(cfg, shape))
    assert torch.cuda.memory_allocated() == before
    r = roofline.analyze(cost, cfg, shape, "1", 1, "qwen3_0p6b")
    assert r.card is hw.current() and 0 < r.useful_ratio


# --------------------------------------------------------------------------
# the mesh on the card: one NCCL rank (two ranks cannot share the card
# through NCCL, and gloo's functional all-gather of CUDA tensors hangs)
# --------------------------------------------------------------------------

@pytest.fixture
def one_rank_mesh(cuda):
    """A (data 1, model 1) `DeviceMesh` of one NCCL rank on the card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_host_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("H,KV,hd", [(16, 8, 128), (8, 1, 112), (4, 4, 64)])
def test_sharded_flash_on_the_card_equals_the_kernels(one_rank_mesh, H, KV,
                                                      hd):
    """The flash wrapper's mesh branch (`local_map` over DTensors) runs the
    same kernels as the plain call: forward and gradients bit for bit,
    one lse forward and one backward launched."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import ops

    mesh = one_rank_mesh
    g = torch.Generator(device="cuda").manual_seed(H + hd)
    q, k, v, do = (torch.randn(s, generator=g, device="cuda",
                               dtype=torch.bfloat16)
                   for s in ((2, 256, H, hd), (2, 256, KV, hd),
                             (2, 256, KV, hd), (2, 256, H, hd)))
    want = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o_want = ops.flash_attention(*want)
    o_want.backward(do)
    LAUNCHES.clear()
    with sh.axis_rules(mesh):
        got = [sh.distribute(x, mesh, [Replicate()] * 2).requires_grad_(True)
               for x in (q, k, v)]
        o = ops.flash_attention(sh.constrain(got[0], "batch", None, "heads",
                                             None), got[1], got[2])
        o.backward(sh.distribute(do, mesh, [Replicate()] * 2))
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"flash_attention_fwd": 1,
                              "flash_attention_bwd": 1}
    assert torch.equal(o.full_tensor(), o_want)
    for a, b in zip(got, want):
        assert torch.equal(a.grad.full_tensor(), b.grad)


def test_train_cell_on_the_card(one_rank_mesh):
    """Reduced Qwen3-0.6B through `build_cell` on the one-rank mesh: its
    parameters DTensors, the flash kernels launched from the mesh branch
    (twice forward and once backward a layer, the checkpointed blocks'
    recompute on the autograd engine's thread included), loss and
    gradients equal to the unsharded step's within 3f's gate."""
    import copy
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.cells import build_cell
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train.step import loss_and_grads

    cfg = reduced(get_config("qwen3_0p6b"))
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    twin = copy.deepcopy(params)
    batch = SyntheticLM(cfg.vocab_size, 256, 2, seed=1).batch(0)
    cell = build_cell("qwen3_0p6b", "train_4k", one_rank_mesh,
                      reduce_config=True,
                      shape_override=ShapeConfig("t", 256, 2, "train"),
                      params=params, batch=batch, lr_fn=constant(1e-3))
    LAUNCHES.clear()
    loss, _, grads = dataclasses.replace(
        cell, fn=lambda p, s, i, b: loss_and_grads(bundle, p, b)).run()
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "flash_attention_fwd": 2 * cfg.n_layers,
        "flash_attention_bwd": cfg.n_layers}
    want_loss, _, want = loss_and_grads(bundle, twin, batch)
    assert abs(float(loss.full_tensor()) - float(want_loss)) \
        < 1e-3 * abs(float(want_loss))
    for name, g in want.items():
        d = (grads[name].full_tensor().float() - g.float()).pow(2).mean()
        assert float(d.sqrt()) <= 0.05 * float(g.float().pow(2).mean()
                                               .sqrt()) + 1e-12, name
    _, _, m = cell.run()
    assert bool(torch.isfinite(m["loss"])) and m["loss"].is_cuda


def test_compressed_cell_on_the_card(one_rank_mesh):
    """The compressed cell on the mesh's data axis: the sign pack, the
    majority vote and the unpack launched once each, on the card."""
    from repro_torch.configs.base import ShapeConfig, get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.cells import build_cell
    from repro_torch.models import build
    from repro_torch.optim import constant

    cfg = reduced(get_config("qwen3_0p6b"))
    params = build(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    batch = SyntheticLM(cfg.vocab_size, 128, 2, seed=1).batch(0)
    cell = build_cell("qwen3_0p6b", "train_4k", one_rank_mesh,
                      overrides={"compressed_dp": True}, reduce_config=True,
                      shape_override=ShapeConfig("t", 128, 2, "train"),
                      params=params, batch=batch, lr_fn=constant(1e-3))
    LAUNCHES.clear()
    _, _, m = cell.run()
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items()
            if k in ("pack_signs", "unpack_signs", "majority")} == {
        "pack_signs": 1, "unpack_signs": 1, "majority": 1}
    assert bool(torch.isfinite(m["loss"]))
