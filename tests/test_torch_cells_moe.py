"""Port parity: `launch.cells.build_cell` on a 2 x 2 gloo mesh, on the
CPU: the reference's Kimi K2 train cell, reduced, in float32, with the
MoE's dispatch and experts in their `local_map` regions (experts over
the model axis, capacity rows over the data axis) and Adafactor over
two microbatches (the cases and tolerances are
`tests/_torch_cells_parity.py`'s)."""
import pytest

pytest.importorskip("jax")
import _torch_cells_parity as C  # noqa: E402

ARCH = "kimi_k2_1t_a32b"


@pytest.fixture(scope="module")
def cells():
    return C.results((ARCH,))


def test_train_cell_loss_and_gradients(cells):
    C.check_loss_and_gradients(cells, ARCH)


def test_train_cell_step(cells):
    C.check_step(cells, ARCH)


def test_train_cell_is_sharded(cells):
    # the experts over model, their D over data; the router's D over data
    C.check_placements(cells, ARCH, {
        "moe.moe.wi": "(Shard(dim=1), Shard(dim=0))",
        "moe.moe.wo": "(Shard(dim=2), Shard(dim=0))",
        "moe.router": "(Shard(dim=0), Replicate())"})
