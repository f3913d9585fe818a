"""Port parity: the training step in float32, on the CPU: the loss and every
gradient leaf at ``grad_accum`` 1 and 2, and two steps of sgd at both (cases
of `_torch_train_parity`: the reference's reduced Qwen3-0.6B, its parameters
and batches, with the tolerances stated there). The float32 cases are split
by optimizer over this file, `test_torch_train_step_adaptive` and
`test_torch_train_step_signum`, so that none holds a test worker for long."""
import pytest

pytest.importorskip("jax")
import _torch_train_parity as P  # noqa: E402


@pytest.mark.parametrize("accum", [1, 2])
def test_loss_and_grads_match_reference(accum):
    P.loss_and_grads_case("float32", accum)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ["sgd"])
def test_train_step_matches_reference(name, accum):
    P.train_step_case("float32", name, accum)
