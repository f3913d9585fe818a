"""End-to-end training driver (the counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0p6b \
        --steps 200 --batch 8 --seq 128 [--full] [--opt adamw|signum] \
        [--ckpt-dir DIR [--ckpt-every N]] [--device cpu]

Runs on the card (``--device cuda``, the default) unless asked for the
CPU; the reduced config unless ``--full``. Every arch trains: the dense
and MoE ones (``--arch llama4_maverick_400b_a17b``, ``kimi_k2_1t_a32b``,
whose loss adds the load-balancing term), ``mamba2_1p3b``,
``zamba2_2p7b``, ``seamless_m4t_medium`` and ``llama_3p2_vision_90b``;
`SyntheticLM.for_cell` adds the enc-dec / VLM stub frames / patches to
each batch. One process trains on one device: ``--opt signum`` is then
the local sign step, as the reference's is on one device.
``--ckpt-dir`` runs the reference's resilient loop: a `ResilientRunner`
over a `train.state.TrainCheckpointer` (the reference's checkpoint files,
every ``--ckpt-every`` steps and at the end), resuming from the newest
checkpoint in the directory, with a `StragglerMonitor` on each step's
wall.

``--model-parallel M`` trains on a ``(data, model)`` mesh of the world
(`launch.mesh.make_host_mesh`), one process a rank, launched by
``torchrun`` (or `launch.mesh.run_ranks`, which calls `main` in each
rank)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --model-parallel 2 --device cpu --steps 3

Every rank draws the same weights and batches; each keeps its shards
(`launch.cells.shard_module`, placements from `dist.sharding.
tree_shardings`) and the step runs under `axis_rules` on the mesh; with
``--opt signum`` and more than one data rank it is the majority-vote
step over the data axis (`make_train_step_compressed`), as the
reference's is. ``--init-from DIR`` starts from the newest checkpoint in
``DIR`` (the reference's files), restored onto the mesh. A world that
``M`` does not divide raises, and so does ``--model-parallel`` with no
process group and no ``torchrun`` environment. On a mesh ``--ckpt-dir``
is not taken (the resilient loop saves from one process).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.data import SyntheticLM
from repro_torch.dist.fault_tolerance import ResilientRunner, StragglerMonitor
from repro_torch.models import build
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.train import make_train_step
from repro_torch.train.state import TrainCheckpointer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0p6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init-from", default="",
                    help="checkpoint directory to start from")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        return _main_on_mesh(args)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    bundle = build(cfg, device=args.device)
    print(f"arch={cfg.name} family={cfg.family} device={bundle.device}")
    params = bundle.init(
        torch.Generator(device=bundle.device).manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    print(f"params: {n_params / 1e6:.2f}M")

    lr_fn = warmup_cosine(args.lr, max(10, args.steps // 20), args.steps)
    data = SyntheticLM.for_cell(
        cfg, ShapeConfig("cli", args.seq, args.batch, "train"),
        device=bundle.device)
    opt = get_optimizer(args.opt, lr_fn)
    step_fn = make_train_step(bundle, opt, grad_accum=args.grad_accum)
    opt_state = opt.init(params)
    if args.ckpt_dir:
        _run_resilient(args, step_fn, data, (params, opt_state))
        return 0
    t0 = time.time()
    for i in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state, i,
                                             data.batch(i))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    return 0


def _main_on_mesh(args) -> int:
    """`main` on a ``(data, model)`` mesh of the world (the module
    docstring)."""
    from repro_torch.dist.sharding import axis_rules, tree_shardings
    from repro_torch.launch.cells import shard_module, shard_tree
    from repro_torch.launch.mesh import (axis_group, init_from_env,
                                         make_host_mesh)
    from repro_torch.models.registry import batch_logical_specs
    from repro_torch.train import make_train_step_compressed

    if args.ckpt_dir:
        raise ValueError("--ckpt-dir saves from one process; on a mesh "
                         "start from a checkpoint with --init-from")
    rank, _ = init_from_env("nccl" if args.device == "cuda" else "gloo")
    mesh = make_host_mesh(model=args.model_parallel, device=args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    bundle = build(cfg, device=args.device)
    if rank == 0:
        print(f"arch={cfg.name} family={cfg.family} device={bundle.device}"
              f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    params = bundle.init(
        torch.Generator(device=bundle.device).manual_seed(0))
    _, specs = bundle.abstract()
    lr_fn = warmup_cosine(args.lr, max(10, args.steps // 20), args.steps)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    data = SyntheticLM.for_cell(cfg, shape, device=bundle.device)
    n_data = mesh.shape[0]
    if args.opt == "signum" and n_data > 1:
        sub = mesh["model"]
        group = axis_group(mesh, ("data",))
        opt = get_optimizer("signum", lr_fn, group=group)
        step_fn = make_train_step_compressed(bundle, opt, group,
                                             grad_accum=args.grad_accum)
        shard_module(params, tree_shardings(params, specs, sub), sub)
        run_mesh, b_pl = sub, None
    else:
        opt = get_optimizer(args.opt, lr_fn)
        step_fn = make_train_step(bundle, opt, grad_accum=args.grad_accum)
        shard_module(params, tree_shardings(params, specs, mesh), mesh)
        b_pl = tree_shardings(data.batch(0), batch_logical_specs(cfg, shape),
                              mesh)
        run_mesh = mesh
    opt_state = opt.init(params)
    start = 0
    with axis_rules(run_mesh):
        if args.init_from:
            start, _, _ = TrainCheckpointer(args.init_from).restore(
                (params, opt_state))
        t0 = time.time()
        for i in range(start, args.steps):
            batch = data.batch(i)
            if b_pl is not None:
                batch = shard_tree(batch, b_pl, mesh)
            params, opt_state, metrics = step_fn(params, opt_state, i, batch)
            if rank == 0 and (i % args.log_every == 0
                              or i == args.steps - 1):
                print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({(time.time() - t0) / (i + 1 - start):.2f}s/step)",
                      flush=True)
    return 0


def _run_resilient(args, step_fn, data, state) -> None:
    """The reference's ``--ckpt-dir`` loop: `ResilientRunner` over a
    `TrainCheckpointer` in ``args.ckpt_dir``, each step's wall observed
    by a `StragglerMonitor`."""
    monitor = StragglerMonitor()
    seen = {"stragglers": 0, "metrics": {}}

    def timed_step(state, step, batch):
        t = time.perf_counter()
        params, opt_state, metrics = step_fn(*state, step, batch)
        seen["metrics"] = {k: float(v) for k, v in metrics.items()}
        if monitor.observe(step, time.perf_counter() - t):
            seen["stragglers"] += 1
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {seen['metrics']['loss']:.4f} "
                  f"gnorm {seen['metrics']['grad_norm']:.3f}")
        return (params, opt_state), metrics

    ck = TrainCheckpointer(args.ckpt_dir, keep=3)
    runner = ResilientRunner(timed_step, data.batch, ck,
                             ckpt_every=args.ckpt_every)
    t0 = time.time()
    _, rep = runner.run(state, args.steps)
    print(f"ran {rep.steps_run} steps in {time.time() - t0:.1f}s "
          f"({rep.checkpoints} ckpts, {rep.restores} restores, "
          f"{seen['stragglers']} stragglers); timeline "
          f"{' '.join(rep.timeline)}")
    print("final metrics:", seen["metrics"])


if __name__ == "__main__":
    raise SystemExit(main())
