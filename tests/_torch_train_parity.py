"""Shared cases of the training-step parity tests
(`test_torch_train_step.py` in float32, `test_torch_train_step_bf16.py`
in bf16, one file each so that each stays short on its test worker).

The JAX package's reduced Qwen3-0.6B (4 layers, d_model 128, 4 heads, 2
KV heads, head_dim 32, vocab 512 padded to 2,048) and its parameters
(``build(cfg).init(PRNGKey(0))``) are carried into the port with
`convert.model_params_from_reference`; both packages take the JAX
package's `SyntheticLM` batches (seq 16, batch 4). Held, in float32 and
bf16, at ``grad_accum`` 1 and 2: the loss and every gradient leaf of
`train.step.loss_and_grads` against ``jax.grad`` of ``bundle.loss``
(averaged in float32 over the microbatches, as the reference's scan
does), and for sgd / adamw / adafactor / signum one `make_train_step`
step from the same start (loss, ``grad_norm``, updated parameters), then
a second step resumed from the reference's state after its first
(`convert.opt_state_from_reference`), plus the port's own second step.

Tolerances: 1e-4 of the reference's largest magnitude per leaf in
float32 (the two sum in other orders), 0.05 in bf16 (one bf16 rounding
that lands the other way moves a value by 2^-8 of it; the bound
`tests/test_models.py` holds bf16 decode to prefill with). Sign-like
updates (AdamW's normalised step, Adafactor's unfactored first step and
signum's sign) turn a gradient difference near 0 into a step of about
``lr``: an element outside the tolerance must be one whose deciding
value (the gradient; for signum ``g + error feedback``) is below
`SIGN_FRAC` of its leaf's largest (in bf16 the gradient tolerance
itself), and such elements are counted (at
most `MAX_EXEMPT` of a leaf, none for SGD). The reference runs its
pure-jnp attention here; its Pallas flash backward is held to the
port's in `tests/test_torch_flashattn_bwd.py`.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

import repro.configs.base as RC
import repro.optim as ropt
from repro.data import SyntheticLM as RSyntheticLM
from repro.models import build as rbuild
from repro.train import make_train_step as rmake_train_step
from repro_torch import configs as TC
from repro_torch import optim as topt
from repro_torch.convert import (model_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.models import build
from repro_torch.optim.optimizers import leaves
from repro_torch.train import make_train_step
from repro_torch.train.step import loss_and_grads

TOL = {"float32": 1e-4, "bfloat16": 0.05}
SIGN_FRAC = {"float32": 1e-3, "bfloat16": 0.05}
MAX_EXEMPT = 0.01
LR = {"sgd": 0.05, "adamw": 1e-3, "adafactor": 1e-3, "signum": 1e-3}
OPTS = list(LR)
SIGN_LIKE = {"adamw", "adafactor", "signum"}


@functools.lru_cache(None)
def _setup(dtype):
    rcfg = dataclasses.replace(RC.reduced(RC.get_config("qwen3_0p6b")),
                               dtype=dtype)
    cfg = dataclasses.replace(TC.reduced(TC.get_config("qwen3_0p6b")),
                              dtype=dtype)
    rb = rbuild(rcfg)
    rp = rb.init(jax.random.PRNGKey(0))
    data = RSyntheticLM(rcfg.vocab_size, 16, 4, seed=7)
    batches = [data.batch(i) for i in range(2)]
    grad = jax.jit(jax.grad(lambda p, b: rb.loss(p, b)[0]))
    return cfg, rb, rp, batches, grad


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _ref_grads(grad, params, batch, accum):
    """The reference's gradients of one batch: averaged in float32 over
    ``accum`` microbatches (`repro.train.step`'s scan)."""
    if accum == 1:
        return grad(params, batch)
    mbs = [jax.tree.map(lambda x, i=i: x.reshape(accum, -1, *x.shape[1:])[i],
                        batch) for i in range(accum)]
    acc = None
    for mb in mbs:
        g = jax.tree.map(lambda x: x.astype(jnp.float32), grad(params, mb))
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    return jax.tree.map(lambda x: x / accum, acc)


def _flat(tree):
    """Reference tree -> {port leaf name: float32 numpy}."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(k.key) for k in path)] = np.asarray(v, np.float32)
    return out


def _f32(x):
    return x.detach().float().numpy()


def _close(got, want, tol, what, exempt=None):
    """Every element within ``tol`` of the reference's largest magnitude,
    or exempt; returns how many exempt elements were outside it (at most
    `MAX_EXEMPT` of the leaf)."""
    err = np.abs(got - want) / (np.abs(want).max() + 1e-12)
    off = err >= tol
    if exempt is not None:
        assert off.mean() <= MAX_EXEMPT, (what, off.mean())
        off = off & ~exempt
    worst = float(np.where(off, err, 0.0).max())
    assert not off.any(), f"{what}: max error {worst:.3g} of the " \
        f"reference's max"
    return int((err >= tol).sum())


def _ref_opt(name):
    lr = ropt.constant(LR[name])
    if name == "sgd":
        return ropt.sgd(lr)
    if name == "signum":
        return ropt.signum(lr)
    return getattr(ropt, name)(lr)


def _port_opt(name):
    return topt.get_optimizer(name, topt.constant(LR[name]))


def _deciders(name, grads, gnorm, state):
    """Per leaf, the values whose sign decides a sign-like update: the
    clipped gradient (plus signum's error feedback)."""
    scale = min(1.0, 1.0 / max(gnorm, 1e-9))
    out = {k: g * scale for k, g in _flat(grads).items()}
    if name == "signum":
        for k, e in _flat(state["err"]).items():
            out[k] = out[k] + e
    return out


def _check_params(model, ref_params, name, deciders, dtype, what):
    """Hold every updated parameter leaf to the reference's; returns the
    number of exempt elements outside the tolerance."""
    named = dict(model.named_parameters())
    want = _flat(ref_params)
    n_off = 0
    for leaf in leaves(named):
        got = _f32(leaf.gather(named))
        exempt = None
        if name in SIGN_LIKE:
            d = np.abs(deciders[leaf.name])
            exempt = d < SIGN_FRAC[dtype] * d.max()
        n_off += _close(got, want[leaf.name], TOL[dtype],
                        f"{what} {leaf.name}", exempt)
    return n_off


def loss_and_grads_case(dtype, accum):
    """Loss, metrics and every gradient leaf of one batch."""
    cfg, rb, rp, batches, grad = _setup(dtype)
    want = _flat(_ref_grads(grad, rp, batches[0], accum))
    bundle = build(cfg, device="cpu")
    model = model_params_from_reference(cfg, rp, device="cpu")
    loss, metrics, grads = loss_and_grads(bundle, model,
                                          _torch_batch(batches[0]), accum)
    ref_loss, _ = rb.loss(rp, batches[0])
    assert abs(float(loss) - float(ref_loss)) < TOL[dtype] * abs(
        float(ref_loss))
    assert set(metrics) == ({"xent", "aux"} if accum == 1 else set())
    named = dict(model.named_parameters())
    for leaf in leaves(named):
        g = leaf.gather(grads)
        assert g.dtype == (torch.float32 if accum > 1
                           else getattr(torch, dtype))
        _close(_f32(g), want[leaf.name], TOL[dtype], f"grad {leaf.name}")


def train_step_case(dtype, name, accum):
    """Two `make_train_step` steps of optimizer ``name``."""
    cfg, rb, rp, batches, grad = _setup(dtype)
    tol = TOL[dtype]
    ropt_ = _ref_opt(name)
    rstep = jax.jit(rmake_train_step(rb, ropt_, grad_accum=accum))
    rs0 = ropt_.init(rp)
    rp1, rs1, rm1 = rstep(rp, rs0, jnp.int32(0), batches[0])
    rp2, rs2, rm2 = rstep(rp1, rs1, jnp.int32(1), batches[1])

    bundle = build(cfg, device="cpu")
    opt = _port_opt(name)
    step = make_train_step(bundle, opt, grad_accum=accum)
    model = model_params_from_reference(cfg, rp, device="cpu")
    state = opt.init(model)
    model, state, m1 = step(model, state, 0, _torch_batch(batches[0]))
    for k in ("loss", "grad_norm"):
        assert abs(float(m1[k]) - float(rm1[k])) < tol * abs(float(rm1[k]))
    dec = _deciders(name, _ref_grads(grad, rp, batches[0], accum),
                    float(rm1["grad_norm"]), rs0)
    _check_params(model, rp1, name, dec, dtype, "step 1")
    # the port's own second step: its loss
    _, _, m2 = step(model, state, 1, _torch_batch(batches[1]))
    assert abs(float(m2["loss"]) - float(rm2["loss"])) < tol * abs(
        float(rm2["loss"]))

    # the second step resumed from the reference's parameters and state
    model = model_params_from_reference(cfg, rp1, device="cpu")
    state = opt_state_from_reference(name, rs1, model)
    model, _, m2 = step(model, state, 1, _torch_batch(batches[1]))
    for k in ("loss", "grad_norm"):
        assert abs(float(m2[k]) - float(rm2[k])) < tol * abs(float(rm2[k]))
    dec = _deciders(name, _ref_grads(grad, rp1, batches[1], accum),
                    float(rm2["grad_norm"]), rs1)
    _check_params(model, rp2, name, dec, dtype, "step 2")
