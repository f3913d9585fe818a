"""Port parity: the VM's named-row helpers, `core.lowering.make_plane` /
`read_rows` and `kernels.vm.run_megakernel`, on the CPU.

`make_plane` gives the reference's bit patterns (C1 all ones, absent rows
zero, rows broadcast over batch dims); `read_rows` its rows; and
`run_megakernel` (the plain VM for CPU tensors) equals the reference's
Pallas `vm_megakernel` in interpret mode, row index for row index, in
materialize mode with and without TRA fault masks. The counts of
``reduce="popcount"`` (with and without a mask) and ``"aggregate"`` are
held to the popcounts of the reference's materialized rows, as
`test_torch_vm.py` holds its counts, around the reference's jitted
``_dispatch`` failing after mixed calls in one process (ROADMAP §C).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import lowering as rlow  # noqa: E402
from repro.core.errors import TRAErrorModel, error_planes  # noqa: E402
from repro.kernels import vm as rvm  # noqa: E402
from repro_torch.core import lowering as tlow  # noqa: E402
from repro_torch.core.bitplane import to_uint32  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import vm as tvm  # noqa: E402
from test_torch_vm import _programs  # noqa: E402


def _popcounts(rows, mask=None):
    r = np.asarray(rows) if mask is None else np.asarray(rows) & mask
    return np.unpackbits(np.ascontiguousarray(r).view(np.uint8),
                         axis=-1).sum(-1)


def _case(seed, batch, words):
    rprog, tprog = _programs(seed)
    rlp, tlp = rlow.lower(rprog), tlow.lower(tprog)
    assert rlp.row_names == tlp.row_names
    rng = np.random.default_rng(seed)
    names = [n for n in rlp.row_names if n.startswith("D")]
    data = {}
    for i, n in enumerate(names):
        # batched rows, rows shared by every batch slice, one row absent
        if i % 3 == 2:
            continue
        shape = (words,) if i % 3 == 1 else batch + (words,)
        data[n] = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    data["T1"] = rng.integers(0, 1 << 32, (words,), dtype=np.uint32)
    outs = [r for r in rlp.writes if r != rlow.SINK] or names[:1]
    return rlp, tlp, data, outs, rng


@pytest.mark.parametrize("seed,batch", [(0, ()), (1, (3,)), (2, (2, 2)),
                                        (5, (1, 3))])
def test_make_plane_and_read_rows_match_the_reference(seed, batch):
    words = 13
    rlp, tlp, data, _, _ = _case(seed, batch, words)
    want = np.asarray(rlow.make_plane(rlp, data, words, batch=batch))
    got = tlow.make_plane(tlp, data, words, batch=batch, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(to_uint32(got), want)
    c1 = tlp.row_index("C1")
    assert (to_uint32(got[c1]) == 0xFFFFFFFF).all()
    names = list(dict.fromkeys(list(tlp.row_names[:3]) + list(data)))
    rows = tlow.read_rows(tlp, got, names)
    ref_rows = rlow.read_rows(rlp, jax.numpy.asarray(want), names)
    assert list(rows) == names
    for n in names:
        np.testing.assert_array_equal(to_uint32(rows[n]),
                                      np.asarray(ref_rows[n]))
    # tensors keep their device; host rows go to the device asked for
    tdata = {k: torch.from_numpy(v.view(np.int32)) for k, v in data.items()}
    assert torch.equal(tlow.make_plane(tlp, tdata, words, batch), got)
    assert torch.equal(tlow.make_plane(tlp, None, words, batch, "cpu")[c1],
                       torch.full(batch + (words,), -1, dtype=torch.int32))


@pytest.mark.parametrize("seed,batch", [(3, (2,)), (4, (2, 2))])
def test_run_megakernel_matches_the_references_vm(seed, batch):
    words = 45
    rlp, tlp, data, outs, rng = _case(seed, batch, words)
    rplane = rlow.make_plane(rlp, data, words, batch=batch)
    tplane = tlow.make_plane(tlp, data, words, batch=batch, device="cpu")
    out_idx = tuple(rlp.row_index(o) for o in outs)
    errors = np.asarray(error_planes(rlp.table, jax.random.PRNGKey(seed),
                                     batch, words,
                                     TRAErrorModel(p_flip=0.05)))
    mask = rng.integers(0, 1 << 32, (words,), dtype=np.uint32)
    for err in (None, errors):
        want = np.asarray(rvm.vm_megakernel(rlp.table, rplane, out_idx,
                                            errors=err))
        got = tvm.run_megakernel(tlp, tplane, outs, errors=err)
        assert got.shape == want.shape
        np.testing.assert_array_equal(to_uint32(got), want)
        assert torch.equal(kops.run_megakernel(tlp, tplane, outs,
                                               errors=err), got)
        for m in (None, mask):
            counts = tvm.run_megakernel(tlp, tplane, outs, errors=err,
                                        reduce="popcount", mask=m)
            assert counts.shape == (len(outs),) + batch
            np.testing.assert_array_equal(counts.numpy(),
                                          _popcounts(want, m))
            agg = tvm.run_megakernel(tlp, tplane, outs, errors=err,
                                     reduce="aggregate", mask=m)
            np.testing.assert_array_equal(
                agg.numpy(), sum(_popcounts(want[j], m).astype(np.float32)
                                 * (1 << j) for j in range(len(outs))))
    with pytest.raises(ValueError, match="reduce"):
        tvm.run_megakernel(tlp, tplane, outs, reduce="sum")
    with pytest.raises(ValueError, match="mask="):
        tvm.run_megakernel(tlp, tplane, outs, mask=mask)
