"""Port parity: `launch.cells.build_cell` on a 2 x 2 gloo mesh, on the
CPU: the reference's Qwen3-0.6B train cell and Mamba2 decode cell,
reduced, in float32 (the cases and tolerances are
`tests/_torch_cells_parity.py`'s; Kimi K2's train cell is
`test_torch_cells_moe.py`)."""
import pytest

pytest.importorskip("jax")
import _torch_cells_parity as C  # noqa: E402


@pytest.fixture(scope="module")
def cells():
    return C.results(("qwen3_0p6b", "mamba2_1p3b"))


def test_train_cell_loss_and_gradients(cells):
    C.check_loss_and_gradients(cells, "qwen3_0p6b")


def test_train_cell_step(cells):
    C.check_step(cells, "qwen3_0p6b")


def test_train_cell_is_sharded(cells):
    # wq (D, H, hd): fsdp over data, heads over model; the norms replicate
    C.check_placements(cells, "qwen3_0p6b", {
        "attn.wq": "(Shard(dim=0), Shard(dim=1))",
        "mlp.wi": "(Shard(dim=0), Shard(dim=2))",
        "final_norm": "(Replicate(), Replicate())"})


def test_decode_cell(cells):
    C.check_decode(cells)
