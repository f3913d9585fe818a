"""Port parity: training the JAX package's reduced Mamba2-1.3B on the
CPU (cases of `_torch_train_parity`, its parameters carried across by
`convert.model_params_from_reference`, batches of sequence 40 and batch
4): the loss and every gradient leaf of `train.step.loss_and_grads`
against ``jax.grad`` of the reference's ``bundle.loss`` in float32 at
``grad_accum`` 1 and 2 (1e-4 of each leaf's largest magnitude) and in
bf16 at 1 (0.05); one AdamW and one Adafactor step from the same start,
then a second step resumed from the reference's state
(`convert.opt_state_from_reference`), with the sign-like exemptions
stated there."""
import pytest

pytest.importorskip("jax")
import _torch_train_parity as P  # noqa: E402

ARCH = "mamba2_1p3b"


@pytest.mark.parametrize("dtype,accum", [("float32", 1), ("float32", 2),
                                         ("bfloat16", 1)])
def test_loss_and_grads_match_reference(dtype, accum):
    P.loss_and_grads_case(dtype, accum, ARCH)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_step_matches_reference(name):
    P.train_step_case("float32", name, 1, ARCH)
