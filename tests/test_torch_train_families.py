"""Training the SSM, hybrid, enc-dec and VLM families beside the dense
one, on the CPU: `optim.optimizers.leaves` names the reference's
parameter tree for every family that trains (two stacked layer axes for
Zamba2's and the VLM's groups) and refuses a ragged stack, and
`launch.train` trains the four new families (reduced, 2 steps). Their
loss, gradients and optimizer steps against the reference are
`test_torch_train_step_{ssm,hybrid,encdec,vlm}.py`."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import repro.configs.base as RC  # noqa: E402
import repro.optim as ropt  # noqa: E402
from repro.models import build as rbuild  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.convert import (model_params_from_reference,  # noqa: E402
                                 opt_state_from_reference)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim.optimizers import leaves, named  # noqa: E402


TRAINED_ARCHS = [a for a in RC.ARCH_IDS
                 if RC.get_config(a).family != "moe"]


@pytest.mark.parametrize("arch", TRAINED_ARCHS)
def test_leaves_are_the_reference_tree(arch):
    """For every family that trains, `leaves` names exactly the
    reference's flattened parameter tree, in its order, and each leaf
    gathers to the reference's stacked shape: Zamba2's ``groups.<g>.<j>``
    SSM blocks and the VLM's ``groups.<g>.self.<j>`` layers on two
    leading axes. An Adafactor state of the reference then carries across
    (`opt_state_from_reference`) in the port's layout."""
    rcfg = RC.reduced(RC.get_config(arch))
    cfg = TC.reduced(TC.get_config(arch))
    rp = rbuild(rcfg).init(jax.random.PRNGKey(0))
    ref = {".".join(str(k.key) for k in path): tuple(v.shape)
           for path, v in jax.tree_util.tree_flatten_with_path(rp)[0]}
    model = model_params_from_reference(cfg, rp, device="cpu")
    tensors = named(model)
    got = {leaf.name: tuple(leaf.gather(tensors).shape)
           for leaf in leaves(tensors)}
    assert list(got) == list(ref) and got == ref
    rstate = ropt.adafactor(ropt.constant(1e-3)).init(rp)
    state = opt_state_from_reference("adafactor", rstate, model)
    want = topt.adafactor(topt.constant(1e-3)).init(model)
    assert {k: {n: tuple(x.shape) for n, x in v.items()}
            for k, v in state["f"].items()} == \
        {k: {n: tuple(x.shape) for n, x in v.items()}
         for k, v in want["f"].items()}


def test_leaves_refuse_a_ragged_stack():
    """Names whose layer indices do not fill a grid (the MoE family's
    flat list, every other layer an MoE block) have no reference leaf."""
    names = ["layers.0.moe.router", "layers.2.moe.router", "head"]
    with pytest.raises(ValueError, match="do not fill"):
        leaves(names)
    got = leaves(["groups.1.0.w", "groups.0.1.w", "groups.0.0.w",
                  "groups.1.1.w", "b"])
    assert [(x.name, x.grid, x.members) for x in got] == [
        ("b", (), ("b",)),
        ("groups.w", (2, 2), ("groups.0.0.w", "groups.0.1.w",
                              "groups.1.0.w", "groups.1.1.w"))]


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_2p7b",
                                  "seamless_m4t_medium",
                                  "llama_3p2_vision_90b"])
def test_train_cli_trains_the_other_families_on_the_cpu(arch, capsys):
    """`launch.train` takes the SSM, hybrid, enc-dec and VLM archs as it
    does the dense ones (reduced, 2 steps; `SyntheticLM.for_cell` adds
    the frontend's stub embeddings)."""
    assert ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                        "--seq", "20", "--batch", "2", "--log-every", "1",
                        "--grad-accum", "2"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    cfg = TC.get_config(arch)
    assert f"arch={cfg.name} family={cfg.family} device=cpu" in out
    assert len(losses) == 2 and np.isfinite(losses).all()
