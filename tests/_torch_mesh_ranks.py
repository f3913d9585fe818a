"""The ranks' side of the mesh tests: functions that `launch.mesh.
run_ranks` runs in each spawned gloo rank. This module imports torch and
the port only, so that a rank starts without the JAX package; the
reference's side stays in the test files and their helpers."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs as TC

SEQ = 32
LR = 1e-3
#: the cells of `_torch_cells_parity` by arch, and each one's global
#: batch: Kimi K2's plan accumulates over as many microbatches as it has
#: sequences (its grad_accum of 16, clamped)
CELLS = {"qwen3_0p6b": "train", "mamba2_1p3b": "decode",
         "kimi_k2_1t_a32b": "train"}
BATCH = {"qwen3_0p6b": 8, "mamba2_1p3b": 8, "kimi_k2_1t_a32b": 2}


def port_config(arch):
    return dataclasses.replace(TC.reduced(TC.get_config(arch)),
                               dtype="float32")


def shape(arch):
    return TC.ShapeConfig("t", SEQ, BATCH[arch], CELLS[arch])


def cells(rank, world, inputs):
    """Every cell on this rank of the (2, 2) mesh: numpy results."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train.step import loss_and_grads

    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 2, device="cpu")
    out = {}
    for arch, (state, batch) in inputs.items():
        kind = CELLS[arch]
        cfg = port_config(arch)
        bundle = build(cfg, device="cpu")
        model = bundle.abstract()[0].to_empty(device="cpu")
        for n, p in model.named_parameters():
            p.data.copy_(state[n])
        if kind == "decode":
            S = batch["tokens"].shape[1]
            _, cache = bundle.prefill(model, {"tokens": batch["tokens"]})
            batch = {"token": batch["tokens"][:, -1], "cache": cache,
                     "pos": S - 1}
        cell = build_cell(arch, "train_4k", mesh, reduce_config=True,
                          shape_override=shape(arch), params=model,
                          batch=batch, config_override={"dtype": "float32"},
                          lr_fn=constant(LR))
        whole = (lambda x: x.full_tensor().detach().numpy()
                 if hasattr(x, "full_tensor") else np.asarray(x))
        if kind == "train":
            accum = cell.plan.grad_accum
            grads_cell = dataclasses.replace(
                cell, fn=lambda p, s, i, b: loss_and_grads(bundle, p, b,
                                                           accum))
            loss, _, grads = grads_cell.run()
            g = {n: whole(x) for n, x in grads.items()}
            del grads
            params, _, metrics = cell.run()
            out[arch] = {"loss": float(whole(loss)), "grads": g,
                         "grad_norm": float(metrics["grad_norm"]),
                         "params": {n: whole(x) for n, x in
                                    params.named_parameters()},
                         "plan": dataclasses.asdict(cell.plan),
                         "placements": {n: str(x.placements) for n, x in
                                        params.named_parameters()}}
        else:
            logits, cache = cell.run()
            out[arch] = {"logits": whole(logits),
                         "state": whole(cache["ssm"]["state"]),
                         "conv": whole(cache["ssm"]["conv"])}
    return out




def _whole(x):
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).detach()


def compressed(mesh_shape, state, batch, n_layers):
    """One compressed (majority-vote signum) step of reduced Qwen3 in
    float32 with ``n_layers`` layers, built by `build_cell` with
    ``compressed_dp`` on a ``mesh_shape`` (data, model) mesh, its
    parameters ``state``: the loss, the grad norm, the parameters after
    the step, and this rank's packed signs and the voted words."""
    from repro_torch.launch import cells as tcells
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    import importlib

    from repro_torch.optim import constant
    # the module (repro_torch.optim exports a function of its name)
    tsignum = importlib.import_module("repro_torch.optim.signum")

    mesh = make_host_mesh(*mesh_shape, device="cpu")
    cfg = dataclasses.replace(port_config("qwen3_0p6b"), n_layers=n_layers)
    model = build(cfg, device="cpu").abstract()[0].to_empty(device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state[n])
    seen = {}
    vote = tsignum.majority_allreduce

    def recorded(packed, group=None):
        seen["packed"] = packed.clone()
        seen["voted"] = vote(packed, group)
        return seen["voted"]

    tsignum.majority_allreduce = recorded
    try:
        cell = tcells.build_cell(
            "qwen3_0p6b", "train_4k", mesh, overrides={"compressed_dp": True},
            reduce_config=True,
            shape_override=TC.ShapeConfig("t", batch["tokens"].shape[1],
                                          batch["tokens"].shape[0], "train"),
            params=model, batch=batch,
            config_override={"dtype": "float32", "n_layers": n_layers},
            lr_fn=constant(LR))
        params, _, metrics = cell.run()
    finally:
        tsignum.majority_allreduce = vote
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": {n: _whole(x).numpy()
                       for n, x in params.named_parameters()},
            "packed": seen["packed"].numpy(), "voted": seen["voted"].numpy()}


def train_mp(rank, world, cli_argv, comp):
    """The train CLI with ``cli_argv`` (rank 0's output), then the
    compressed step on a (4, 1) and a (2, 2) mesh (`compressed`)."""
    import contextlib
    import io

    from repro_torch.launch import train

    torch.set_num_threads(1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(cli_argv)
    state, batch, n_layers = comp
    return {"cli": out.getvalue(),
            "comp41": compressed((4, 1), state, batch, n_layers),
            "comp22": compressed((2, 2), state, batch, n_layers)}
