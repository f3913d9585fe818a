"""Shared cases of `test_torch_cells.py` (Qwen3 train, Mamba2 decode)
and `test_torch_cells_moe.py` (Kimi K2 train): `launch.cells.build_cell`
on a 2 x 2 gloo mesh against the reference's unsharded step.

The reference's three cells of `tests/test_sharding_launch.py`
(``qwen3_0p6b`` train, ``mamba2_1p3b`` decode, ``kimi_k2_1t_a32b``
train), reduced and in float32, built by `build_cell` over a (data 2,
model 2) mesh of four spawned gloo ranks with the reference's parameters
carried across (`convert.model_params_from_reference`) and its
`SyntheticLM` batch: each rank keeps its shards, and the step runs on
DTensors under the plan's contexts (`Cell.run`). Held to the reference's
jitted unsharded step on the same parameters and batch, at the
tolerances of `tests/_torch_train_parity.py` (1e-4 of the largest
magnitude per leaf; sign-like optimizer steps exempt elements whose
gradient is below `SIGN_FRAC` of its leaf's largest):

* train: the loss, every gradient leaf (`train.step.loss_and_grads` of
  the cell's arguments, gathered) and every parameter after one step of
  the plan's optimizer (AdamW for Qwen3; Adafactor at the plan's
  ``grad_accum`` for Kimi K2, clamped to its batch of 2: two
  microbatches of one sequence);
* decode: one step's logits and the updated SSM state and conv window.

Each file spawns its ranks once (`results`) and computes the reference's
side meanwhile.
"""
import concurrent.futures
import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
import torch

import _torch_mesh_ranks as R
import _torch_train_parity as P
import repro.configs.base as RC
import repro.optim as ropt
from repro.data import SyntheticLM as RSyntheticLM
from repro.models import build as rbuild
from repro.train import make_train_step as rmake_train_step
from repro_torch.convert import model_params_from_reference
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.plans import plan_for

SEQ, BATCH, LR, CELLS = R.SEQ, R.BATCH, R.LR, R.CELLS
TOL = P.TOL["float32"]


def _cfgs(arch):
    rcfg = dataclasses.replace(RC.reduced(RC.get_config(arch)),
                               dtype="float32")
    return rcfg, R.port_config(arch)


_shape = R.shape


def _accum(cfg, arch):
    accum = plan_for(cfg, _shape(arch)).grad_accum
    while accum > 1 and BATCH[arch] % accum:
        accum //= 2
    return accum


def _inputs(arch):
    """(reference config, bundle, params, batch) and the port's model
    state and batch, for one cell."""
    rcfg, cfg = _cfgs(arch)
    rb = rbuild(rcfg)
    rp = jax.jit(rb.init)(jax.random.PRNGKey(0))
    batch = RSyntheticLM.for_cell(rcfg, RC.ShapeConfig("t", SEQ, BATCH[arch],
                                                       "train"),
                                  seed=5).batch(0)
    model = model_params_from_reference(cfg, rp, device="cpu")
    state = {n: p.detach().clone() for n, p in model.named_parameters()}
    return rb, rp, batch, state, P._torch_batch(batch)


def results(archs):
    """(the ranks' results, the reference's) for the cells ``archs``."""
    refs = {arch: _inputs(arch) for arch in archs}
    inputs = {arch: (r[3], r[4]) for arch, r in refs.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_ranks, R.cells, 4, inputs, timeout=400)
        want = {arch: _reference(arch, *refs[arch][:3]) for arch in archs}
        got = fut.result()
    return got, want


def _reference(arch, rb, rp, batch):
    rcfg, cfg = _cfgs(arch)
    kind = CELLS[arch]
    if kind == "decode":
        S = batch["tokens"].shape[1]
        _, cache = jax.jit(rb.prefill)(rp, {"tokens": batch["tokens"]})
        logits, cache = jax.jit(rb.decode_step)(
            rp, batch["tokens"][:, -1], cache, jnp.int32(S - 1))
        return {"logits": np.asarray(logits, np.float32),
                "state": np.asarray(cache["ssm"]["state"], np.float32),
                "conv": np.asarray(cache["ssm"]["conv"], np.float32)}
    accum = _accum(cfg, arch)
    name = plan_for(cfg, _shape(arch)).optimizer
    grad = jax.jit(jax.grad(lambda p, b: rb.loss(p, b)[0]))
    grads = P._ref_grads(grad, rp, batch, accum)
    mbs = [jax.tree.map(lambda x, i=i: x.reshape(accum, -1,
                                                 *x.shape[1:])[i], batch)
           for i in range(accum)]
    loss_fn = jax.jit(lambda p, b: rb.loss(p, b)[0])
    loss = sum(float(loss_fn(rp, mb)) for mb in mbs) / accum
    opt = getattr(ropt, name)(ropt.constant(LR))
    step = jax.jit(rmake_train_step(rb, opt, grad_accum=accum))
    state0 = opt.init(rp)
    params, _, metrics = step(rp, state0, jnp.int32(0), batch)
    return {"loss": loss, "grads": grads, "params": params, "name": name,
            "accum": accum, "gnorm": float(metrics["grad_norm"]),
            "state0": state0}


def _model(arch, flat):
    """A port model holding ``flat`` (parameter name -> numpy)."""
    cfg = _cfgs(arch)[1]
    from repro_torch.models import build
    model = build(cfg, device="cpu").abstract()[0].to_empty(device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(flat[n]))
    return model


def check_loss_and_gradients(cells, arch):
    got, want = cells
    for rank in got:
        g, w = rank[arch], want[arch]
        assert g["plan"]["grad_accum"] == w["accum"]
        assert abs(g["loss"] - w["loss"]) < TOL * abs(w["loss"])
        model = _model(arch, g["grads"])
        named = dict(model.named_parameters())
        ref = P._flat(w["grads"])
        for leaf in P.leaves(named):
            P._close(P._f32(leaf.gather(named)), ref[leaf.name], TOL,
                     f"{arch} grad {leaf.name}")


def check_step(cells, arch):
    got, want = cells
    w = want[arch]
    deciders = P._deciders(w["name"], w["grads"], w["gnorm"], w["state0"])
    noise = P.noise_exempt(w["name"], deciders)
    for rank in got:
        g = rank[arch]
        assert abs(g["grad_norm"] - w["gnorm"]) < TOL * w["gnorm"]
        P._check_params(_model(arch, g["params"]), w["params"], w["name"],
                        deciders, "float32", f"{arch} step", noise)


def check_placements(cells, arch, want):
    """The step's parameters keep the placements ``want`` (name suffix
    -> placements string) on every rank."""
    for rank in cells[0]:
        pl = rank[arch]["placements"]
        for suffix, placements in want.items():
            names = [n for n in pl if n.endswith(suffix)]
            assert names, suffix
            assert all(pl[n] == placements for n in names), suffix


def check_decode(cells):
    got, want = cells
    w = want["mamba2_1p3b"]
    for rank in got:
        g = rank["mamba2_1p3b"]
        for key in ("logits", "state", "conv"):
            err = np.abs(g[key] - w[key]).max() / np.abs(w[key]).max()
            assert err < TOL, (key, err)
