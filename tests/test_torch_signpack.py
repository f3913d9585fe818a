"""Port parity: sign pack / unpack, the packed tree and the majority
all-reduce, on the CPU.

Pack and unpack are held bit for bit to the JAX package's Pallas kernels
(interpret mode, through `repro.kernels.ops`) and its plain
`repro.kernels.ref` versions, in float32 and bf16, on lanes that include
+-0.0, +-inf and NaNs with and without the sign bit (built from bit
patterns, so both packages see the same bits), at lane counts that are
not a multiple of the reference's (8, 512-word) blocks, 1-D and 2-D.
`majority_allreduce` runs on D = 8 gloo ranks (spawned processes, a
``file://`` rendezvous) against the JAX package's own oracle
(`tests/test_sharding_launch.py::test_majority_allreduce_subprocess`).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rkops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.optim.signum import pack_tree as rpack_tree  # noqa: E402
from repro_torch.core.bitplane import as_words, to_uint32  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.signpack import (pack_signs_kernel,  # noqa: E402
                                          unpack_signs_kernel)
from repro_torch.optim.signum import pack_tree, unpack_tree  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
# bit patterns of +0.0, -0.0, +inf, -inf, NaN, NaN with the sign bit, 1, -1
SPECIAL = {"float32": np.array([0x00000000, 0x80000000, 0x7F800000,
                                0xFF800000, 0x7FC00000, 0xFFC00000,
                                0x3F800000, 0xBF800000], np.uint32),
           "bfloat16": np.array([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0,
                                 0xFFC0, 0x3F80, 0xBF80], np.uint16)}


def _lanes(shape, dtype, seed):
    """Random lanes of ``dtype`` with the special values at the front and
    at the end of every row, as (jax array, torch tensor) of one bit
    pattern."""
    rng = np.random.default_rng(seed)
    bits = np.asarray(jnp.asarray(rng.standard_normal(shape,
                                                      dtype=np.float32),
                                  dtype=dtype))
    if dtype == "float32":
        u = bits.view(np.uint32).copy()
    else:
        u = bits.view(np.uint16).copy()
    sp = SPECIAL[dtype]
    u[..., :len(sp)] = sp
    u[..., -len(sp):] = sp[::-1]
    if dtype == "float32":
        return jnp.asarray(u.view(np.float32)), torch.from_numpy(
            u.view(np.int32)).view(torch.float32)
    return jnp.asarray(u).view(jnp.bfloat16), torch.from_numpy(
        u.view(np.int16)).view(torch.bfloat16)


SHAPES = [(32 * 5,), (32 * 37,), (32 * 600,), (3, 32 * 7), (9, 32 * 33),
          (1, 32)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_matches_reference_bit_for_bit(shape, dtype):
    xj, xt = _lanes(shape, dtype, sum(shape))
    before = dict(LAUNCHES)
    got = tkops.pack_signs(xt)
    assert dict(LAUNCHES) == before               # the plain version
    assert got.dtype == torch.int32
    assert got.shape == shape[:-1] + (shape[-1] // 32,)
    kernel = np.asarray(rkops.pack_signs(xj))
    plain = np.asarray(rref.pack_signs(xj))
    np.testing.assert_array_equal(to_uint32(got), kernel)
    np.testing.assert_array_equal(to_uint32(got), plain)
    assert torch.equal(tref.pack_signs(xt), got)


@pytest.mark.parametrize("shape", [(5,), (37,), (600,), (3, 7), (9, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpack_matches_reference_bit_for_bit(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    words = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    words.reshape(-1)[:2] = (0, 0xFFFFFFFF)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = tkops.unpack_signs(as_words(words), tdt)
    assert got.dtype == tdt and got.shape == shape[:-1] + (32 * shape[-1],)
    kernel = np.asarray(rkops.unpack_signs(jnp.asarray(words), jdt),
                        np.float32)
    plain = np.asarray(rref.unpack_signs(jnp.asarray(words), jdt),
                       np.float32)
    np.testing.assert_array_equal(got.float().numpy(), kernel)
    np.testing.assert_array_equal(got.float().numpy(), plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_unpack_round_trip_is_the_sign_bit(dtype):
    _, xt = _lanes((4, 32 * 9), dtype, 7)
    signs = tkops.unpack_signs(tkops.pack_signs(xt), xt.dtype)
    want = torch.where(torch.signbit(xt), -1.0, 1.0).to(xt.dtype)
    assert torch.equal(signs, want)
    # -0.0 and the signed NaN unpack to -1; the sign step's x >= 0 rule
    # (optim.signum, local) would give +1 and -1
    assert signs[0, 1] == -1 and signs[0, 5] == -1 and signs[0, 4] == 1


def test_kernel_wrappers_reject_what_they_do_not_take():
    with pytest.raises(ValueError, match="multiple of 32"):
        pack_signs_kernel(torch.zeros(2, 33))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pack_signs_kernel(torch.zeros(2, 32, dtype=torch.float16))
    with pytest.raises(ValueError, match="int32"):
        unpack_signs_kernel(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        unpack_signs_kernel(torch.zeros(2, 3, dtype=torch.int32),
                            torch.float16)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(37, dtype=np.float32),
            "b": {"c": rng.standard_normal((4, 9), dtype=np.float32),
                  "d": np.array([0.0, -0.0, 1.5], np.float32)}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def test_pack_tree_matches_reference_and_round_trips():
    tree = _tree(0)
    packed, meta = pack_tree(_to_torch(tree))
    want, _ = rpack_tree(jax.tree.map(jnp.asarray, tree), use_kernel=False)
    assert packed.shape == (1, -(-(37 + 36 + 3) // 32))
    np.testing.assert_array_equal(to_uint32(packed), np.asarray(want))
    signs = unpack_tree(packed, meta)
    for got, x in ((signs["a"], tree["a"]), (signs["b"]["c"], tree["b"]["c"]),
                   (signs["b"]["d"], tree["b"]["d"])):
        assert got.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.where(np.signbit(x), -1.0, 1.0))


def test_pack_tree_keeps_shapes_and_dtypes_of_a_single_tensor():
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(1)) \
        .bfloat16()
    packed, meta = pack_tree(x)
    out = unpack_tree(packed, meta)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert torch.equal(out, torch.where(x < 0, -1.0, 1.0).bfloat16())


_MAJORITY_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def worker(rank, D, init, out):
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=D)
        try:
            from repro_torch.optim.signum import (majority_allreduce,
                                                  pack_tree, unpack_tree)
            xs = np.load(out + "/xs.npy")
            packed, meta = pack_tree({{"g": torch.from_numpy(xs[rank])}})
            agg = majority_allreduce(packed)
            np.save(out + f"/signs{{rank}}.npy",
                    unpack_tree(agg, meta)["g"].numpy())
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        out = sys.argv[1]
        mp.spawn(worker, args=(8, "file://" + out + "/rendezvous", out),
                 nprocs=8, join=True)
        print("MAJORITY_DONE")
""")


@pytest.mark.parametrize("n", [333, 32 * 8 * 5])
def test_majority_allreduce_on_eight_gloo_ranks(tmp_path, n):
    """D = 8 workers, each with its own gradient; every worker ends with
    the elementwise majority of their signs (ties, 4 against 4, give
    +1), as the JAX package's test holds its shard_map version."""
    D = 8
    xs = np.random.default_rng(n).standard_normal((D, n)).astype(np.float32)
    np.save(tmp_path / "xs.npy", xs)
    script = tmp_path / "majority.py"
    script.write_text(_MAJORITY_SCRIPT.format(src=SRC))
    r = subprocess.run([sys.executable, str(script), str(tmp_path)],
                       capture_output=True, text=True, timeout=120)
    assert "MAJORITY_DONE" in r.stdout, r.stderr[-3000:]
    neg = (xs < 0).sum(0)
    expect = np.where(neg * 2 > D, -1.0, 1.0)
    for d in range(D):
        np.testing.assert_array_equal(np.load(tmp_path / f"signs{d}.npy"),
                                      expect, err_msg=f"worker {d}")
