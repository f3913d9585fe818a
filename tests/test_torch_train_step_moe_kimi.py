"""Port parity: training the JAX package's reduced Kimi K2 on the CPU
(cases of `_torch_train_parity`, the reference's parameters carried
across by `convert.model_params_from_reference`, batches of sequence 40
and batch 4) (8 experts, top-2, a shared expert, one leading dense layer,
three MoE layers): the loss, ``metrics["aux"]`` (the load-balancing loss
that the loss weights by ``MOE_AUX_WEIGHT``) and every gradient leaf of
`train.step.loss_and_grads` against ``jax.grad`` of the reference's
``bundle.loss`` in float32 at ``grad_accum`` 1 and 2 (1e-4 of each
leaf's largest magnitude), in bf16 at 1 (0.05), and in float32 at a
capacity factor that drops tokens (`P.DROP_CF`). Each case first holds
the routing (`P.check_routes`): per MoE layer the port's router sends
every token to the experts that the reference's jitted gradient routes
it to, so a near-tie flipped between the packages shows as a routing
difference, not as a gradient out of tolerance; in bf16 such a flip
must be a near-tie, and the port is then pinned to the reference's ids.
"""
import functools

import pytest

jax = pytest.importorskip("jax")
import _torch_train_parity as P  # noqa: E402

ARCH = "kimi_k2_1t_a32b"


@pytest.mark.parametrize("dtype,accum", [("float32", 1), ("float32", 2),
                                         ("bfloat16", 1)])
def test_loss_and_grads_match_reference(dtype, accum, monkeypatch):
    check = P.check_routes if dtype == "float32" else functools.partial(
        P.check_routes, monkeypatch=monkeypatch)
    P.loss_and_grads_case(dtype, accum, ARCH, check=check)


def test_loss_and_grads_with_dropped_tokens_match_reference():
    """At a capacity factor of 0.25 every MoE layer drops slots; the
    dropped slots carry no gradient in either package."""
    P.loss_and_grads_case("float32", 1, ARCH, cf=P.DROP_CF,
                          check=P.check_routes)
