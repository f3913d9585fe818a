"""Port parity: the training step of a model with QKV biases, in float32,
on the CPU: the cases of `_torch_train_parity` on the JAX package's
reduced Qwen1.5-110B (4 layers, d_model 128, 4 heads, 2 KV heads,
head_dim 32, ``qkv_bias=True``) and its parameters: the loss and every
gradient leaf at ``grad_accum`` 1 and 2, and two steps of sgd / adamw /
adafactor / signum at ``grad_accum`` 1, with the tolerances stated there.

The key bias barely moves the scores, so a fifth of its gradients lie
below 1e-8, where the two packages' sums differ by about 1e-10. AdamW and
Adafactor normalise such a gradient into a step of about ``lr`` whose
sign is noise, so their steps leave out the elements that
`_torch_train_parity.noise_exempt` names (a gradient within 10 x AdamW's
eps = 1e-8 of 0, and for Adafactor also a column whose factored
normaliser such gradients set); every other element, and every leaf of
sgd and signum, is held as in the bias-free cases."""
import pytest

pytest.importorskip("jax")
import _torch_train_parity as P  # noqa: E402

ARCH = "qwen1p5_110b"


@pytest.mark.parametrize("accum", [1, 2])
def test_loss_and_grads_match_reference(accum):
    P.loss_and_grads_case("float32", accum, ARCH)


@pytest.mark.parametrize("name", P.OPTS)
def test_train_step_matches_reference(name):
    P.train_step_case("float32", name, 1, ARCH, noise=True)
