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
from repro_torch.kernels.bittranspose import bit_transpose

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
    got = bit_transpose(values, n_bits)
    torch.cuda.synchronize()
    assert LAUNCHES["bit_transpose"] == before + 1
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
