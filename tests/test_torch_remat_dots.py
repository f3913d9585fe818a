"""Port parity: ``remat="dots"``, the reference's
``dots_with_no_batch_dims_saveable``, on the CPU.

For the reduced dense and MoE models in float32
(`_torch_train_parity.dots_case`: the reference's parameters and
batches), the loss and every gradient leaf of
`train.step.loss_and_grads` under "dots" equal the port's under "block"
bit for bit and the reference's under "dots" within
`_torch_train_parity.TOL` (1e-4 of each leaf's largest magnitude); the
other families' cases are in `test_torch_remat_dots_families.py`. A
dispatch mode counts the weight products (``aten.mm`` and a ``aten.bmm``
with a batch of 1) that run inside a block's rerun in the backward: none
under "dots", more than none under "block" and "full".
"""
import pytest

jax = pytest.importorskip("jax")
import _torch_train_parity as P  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import hybrid as HY  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models import vision as VI  # noqa: E402


@pytest.mark.parametrize("arch", ["qwen3_0p6b",
                                  "llama4_maverick_400b_a17b"])
def test_dots_equals_block_and_the_references_dots(arch):
    P.dots_case(arch)


_aten = torch.ops.aten


class _RerunProducts(TorchDispatchMode):
    """Counts weight products dispatched while ``inside`` (a block's
    rerun in the backward) is set."""

    def __init__(self):
        super().__init__()
        self.inside = 0
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.inside and (func is _aten.mm.default or (
                func is _aten.bmm.default and args[0].shape[0] == 1)):
            self.n += 1
        return func(*args, **(kwargs or {}))


#: the block functions each family's stack checkpoints, by module
_BLOCKS = [(TF, "dense_block"), (TF, "moe_block"), (HY, "ssm_block"),
           (HY, "dense_block"), (ED, "enc_block"), (ED, "dec_block"),
           (VI, "dense_block"), (VI, "dec_block")]


def _rerun_products(arch, remat, monkeypatch):
    cfg, _, rp, batches, _ = P._setup("float32", arch)
    model = model_params_from_reference(cfg, rp, device="cpu")
    mode = _RerunProducts()
    backward = {"on": False}
    for mod, name in _BLOCKS:
        orig = getattr(mod, name)

        def wrapped(*args, _orig=orig, **kw):
            mode.inside += backward["on"]
            try:
                return _orig(*args, **kw)
            finally:
                mode.inside -= backward["on"]

        monkeypatch.setattr(mod, name, wrapped)
    bundle = build(cfg, device="cpu", remat=remat)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    with P._one_thread():
        loss, _ = bundle.loss(model, P._torch_batch(batches[0]))
        backward["on"] = True
        with mode:
            torch.autograd.grad(loss, list(named.values()))
    return mode.n


@pytest.mark.parametrize("arch", ["qwen3_0p6b",
                                  "llama4_maverick_400b_a17b",
                                  "zamba2_2p7b", "seamless_m4t_medium"])
def test_dots_recomputes_no_weight_product(arch, monkeypatch):
    assert _rerun_products(arch, "dots", monkeypatch) == 0
    assert _rerun_products(arch, "block", monkeypatch) > 0
    assert _rerun_products(arch, "full", monkeypatch) > 0
