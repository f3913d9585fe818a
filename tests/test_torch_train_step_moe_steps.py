"""Port parity: training the JAX package's reduced MoE models on the CPU
(cases of `_torch_train_parity`, batches of sequence 40 and batch 4):
for reduced Llama-4 Maverick and Kimi K2, one AdamW and one Adafactor
`make_train_step` step from the same start (loss, ``grad_norm``, every
updated parameter), the port's own second step's loss, then a second
step resumed from the reference's state after its first
(`convert.opt_state_from_reference` carries the MoE state across), with
the sign-like exemptions stated there."""
import pytest

pytest.importorskip("jax")
import _torch_train_parity as P  # noqa: E402


@pytest.mark.parametrize("arch", ["llama4_maverick_400b_a17b",
                                  "kimi_k2_1t_a32b"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_step_matches_reference(arch, name):
    P.train_step_case("float32", name, 1, arch)
