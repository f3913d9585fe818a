"""Multi-pod dry run: build every (architecture x input shape) cell on the
production meshes and count its FLOPs, bytes and collectives.

The counterpart of `repro.launch.dryrun`, with its command line. The
reference lowers and compiles each cell on 256 or 512 placeholder host
devices; here the 16x16 (or 2x16x16) `DeviceMesh` spans a ``"fake"``
process group of 256 (512) ranks in this one process, the cell's
parameters, optimizer state and inputs are DTensors whose shards lie on
``meta`` (nothing is allocated on any device), and `launch.hlocost.count`
runs the step on them: each op once in its global shapes, the collectives
DTensor issues with their operand bytes. The reference's ``lower_s`` /
``compile_s`` are the seconds to build the cell and to count it
(``"timing"`` in the JSON says so), and its ``memory_analysis`` is one
rank's parameter, optimizer-state and input bytes over its local shards
(`hlocost.tensor_bytes`). The roofline is priced against the H100 SXM's
row of `hw`.

The fake group is the process's default group, so the dry run runs in a
process of its own, as the reference's (which fixes its device count at
import) does:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b \\
        --shape train_4k [--multi-pod] [--out results/]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out results/]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch import hw
from repro_torch.configs.base import SHAPES, cells, get_config, reduced
from repro_torch.launch import hlocost
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import analyze

#: the card the dry run prices its roofline against
CARD = "NVIDIA H100 80GB HBM3"


def fake_world(n: int) -> None:
    """Make the default process group a ``"fake"`` group of ``n`` ranks
    (this process is rank 0; collectives return at once, moving
    nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             overrides: dict | None = None, verbose: bool = True,
             reduce_config: bool = False) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, overrides,
                      reduce_config=reduce_config)
    t_build = time.time() - t0
    t0 = time.time()
    cost = hlocost.count(cell.run, *cell.args)     # meta shards only
    t_count = time.time() - t0
    params, *rest = cell.args
    state = rest[0] if cell.shape.kind == "train" else {}
    inputs = rest[1:] if cell.shape.kind == "train" else rest
    mem = {"parameter_bytes": hlocost.tensor_bytes(params),
           "optimizer_bytes": hlocost.tensor_bytes(state),
           "input_bytes": hlocost.tensor_bytes(inputs)}
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] "
              f"build {t_build:.1f}s count {t_count:.1f}s")
        print("  memory_analysis (per rank):", mem)
    cfg = get_config(arch)
    if reduce_config:
        cfg = reduced(cfg)
    rl = analyze(cost, cfg, SHAPES[shape_name], mesh_name, chips, arch,
                 bytes_per_device=float(sum(mem.values())),
                 card=hw.lookup(CARD))
    out = rl.to_dict()
    out.update({
        "lower_s": t_build, "compile_s": t_count,
        "timing": "lower_s is the seconds to build the cell on meta, "
                  "compile_s the seconds to count its step",
        "plan": dataclasses.asdict(cell.plan),
        "memory_analysis": mem,
        "collective_ops": cost.collective_ops,
        "status": "ok",
    })
    if verbose:
        print("  cost:", f"flops={rl.hlo_flops:.3e}",
              f"bytes={rl.hlo_bytes:.3e}",
              f"coll_bytes={rl.collective_bytes:.3e}",
              f"coll_ops={cost.collective_ops}")
        print("  roofline:", f"compute={rl.t_compute*1e3:.2f}ms",
              f"memory={rl.t_memory*1e3:.2f}ms",
              f"mem_floor={rl.t_memory_floor*1e3:.2f}ms",
              f"collective={rl.t_collective*1e3:.2f}ms",
              f"dominant={rl.dominant}",
              f"useful={rl.useful_ratio:.3f}",
              f"roofline_frac={rl.roofline_fraction:.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--override", default="",
                    help="json dict of CellPlan overrides")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a quick check)")
    args = ap.parse_args(argv)
    overrides = json.loads(args.override) if args.override else None

    grid = (cells() if args.all else [(args.arch, args.shape)])
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    results = []
    for arch, shape in grid:
        for mp in meshes:
            try:
                results.append(run_cell(arch, shape, mp, overrides,
                                        reduce_config=args.reduced))
            except Exception as e:
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "status": f"error: {e}"})
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                tag = "all" if args.all else f"{args.arch}_{args.shape}"
                with open(os.path.join(args.out, f"dryrun_{tag}.json"),
                          "w") as f:
                    json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{ok}/{len(results)} cells counted OK")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
