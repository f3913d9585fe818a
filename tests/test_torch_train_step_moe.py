"""Port parity: training the JAX package's reduced Llama-4 Maverick on the CPU
(cases of `_torch_train_parity`, the reference's parameters carried
across by `convert.model_params_from_reference`, batches of sequence 40
and batch 4) (8 experts, top-1, a shared expert, dense and MoE layers
alternating: two super-layers): the loss, ``metrics["aux"]`` (the load-balancing loss
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
The leaf trees of both MoE archs: `optim.optimizers.leaves` over the
port's model, and every optimizer's state, equal the reference's
(names, shapes, order). Kimi K2's gradients are in
`test_torch_train_step_moe_kimi.py`, both archs' optimizer steps in
`test_torch_train_step_moe_steps.py`.
"""
import functools

import pytest

jax = pytest.importorskip("jax")
import _torch_train_parity as P  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import optim as topt  # noqa: E402
from repro_torch.optim.optimizers import leaves  # noqa: E402

ARCH = "llama4_maverick_400b_a17b"
ARCHS = [ARCH, "kimi_k2_1t_a32b"]


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


def _ref_tree(tree):
    """(dotted name, shape) of every leaf, in the reference's order."""
    return [(".".join(str(getattr(k, "key", k)) for k in path),
             tuple(np.shape(v)))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_trees_equal_the_reference(arch):
    """`optim.optimizers.leaves` over the port's MoE model gives the
    reference's parameter tree (``lead.*``, ``groups.dense.*`` stacked
    on (G, moe_every - 1), ``groups.moe.*`` on (G,)), and every
    optimizer's state has the reference's leaves."""
    cfg, _, rp, _, _ = P._setup("float32", arch)
    model = P.model_params_from_reference(cfg, rp, device="cpu")
    named = dict(model.named_parameters())
    got = [(leaf.name, tuple(leaf.shape(named))) for leaf in leaves(named)]
    assert got == _ref_tree(rp)
    shapes = dict(got)
    n_groups = (cfg.n_layers - cfg.n_dense_layers) // cfg.moe_every
    assert shapes["groups.moe.moe.wi"] == (
        n_groups, cfg.n_experts, cfg.d_model, 2, cfg.d_ff)
    if cfg.moe_every > 1:
        assert shapes["groups.dense.attn.wq"][:2] == (
            n_groups, cfg.moe_every - 1)
    assert any(n.startswith("lead.") for n in shapes) == bool(
        cfg.n_dense_layers)
    for name in ("sgd", "adamw", "adafactor"):
        rstate = P._ref_opt(name).init(rp)
        state = topt.get_optimizer(name, topt.constant(1e-3)).init(model)
        assert set(state) == set(rstate)
        for key in rstate:
            port = [(f"{n}.{k}" if isinstance(v, dict) else n,
                     tuple(x.shape))
                    for n, v in state[key].items()
                    for k, x in (sorted(v.items()) if isinstance(v, dict)
                                 else [(None, v)])]
            assert port == _ref_tree(rstate[key]), (name, key)
