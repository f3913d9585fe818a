"""Port parity: ``remat="dots"`` on the reduced SSM, hybrid, enc-dec and
VLM models in float32 (`_torch_train_parity.dots_case`): the loss and
every gradient leaf equal the port's under "block" bit for bit and the
reference's under "dots" within `_torch_train_parity.TOL`. The dense and
MoE cases are in `test_torch_remat_dots.py`."""
import pytest

pytest.importorskip("jax")
import _torch_train_parity as P  # noqa: E402


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_2p7b",
                                  "seamless_m4t_medium",
                                  "llama_3p2_vision_90b"])
def test_dots_equals_block_and_the_references_dots(arch):
    P.dots_case(arch)
