"""The port's dry run (`launch.dryrun`) on a fake group, on the CPU.

``python -m repro_torch.launch.dryrun`` runs in subprocesses, as the
reference's must: Qwen3-0.6B's train_4k cell, reduced on the 16 x 16
mesh and on the 2 x 16 x 16 one, and at its full config on 16 x 16. Each
builds the cell over a ``"fake"`` process group of 256 (512) ranks with
every shard on ``meta`` (the count raises on any other tensor, so
nothing is allocated) and counts its step. Held: the reference's keys;
its FLOPs equal to `launch.hlocost.count` of the same cell without a mesh
(one rank, no DTensor) to `FLOPS_REL`: the mesh adds only the backward of
the flash region's slice of the replicated KV heads (each rank's dk and
dv written into zeros of all the KV heads, 1.4e-4 of the full model's
step, whose 8 KV heads the 16 model ranks do not divide); collectives
counted, with bytes above 0; one rank's parameter bytes below the whole
model's.
"""
import concurrent.futures
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import SHAPES, get_config, reduced
from repro_torch.launch import hlocost
from repro_torch.launch.plans import plan_for
from repro_torch.models import registry
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE = "qwen3_0p6b", "train_4k"
RUNS = {"reduced": ["--reduced"], "reduced_pod": ["--reduced", "--multi-pod"],
        "full": []}
FLOPS_REL = 2e-4
#: the reference's `launch.dryrun.run_cell` keys
REF_KEYS = {"arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
            "collective_bytes", "collective_by_kind", "model_flops",
            "bytes_per_device", "t_compute_s", "t_memory_s",
            "t_memory_floor_s", "dot_bytes", "t_collective_s", "dominant",
            "useful_flops_ratio", "roofline_fraction", "lower_s",
            "compile_s", "plan", "memory_analysis", "status"}


def _dryrun(tag, out):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", SHAPE, "--out", str(out / tag), *RUNS[tag]],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out / tag / f"dryrun_{ARCH}_{SHAPE}.json") as f:
        return json.load(f)[0], r.stdout


def _mesh_free(full):
    """`hlocost.count` of the cell on one rank, no mesh."""
    cfg = get_config(ARCH) if full else reduced(get_config(ARCH))
    shape = SHAPES[SHAPE]
    plan = plan_for(cfg, shape)
    accum = plan.grad_accum
    while accum > 1 and shape.global_batch % accum:
        accum //= 2
    bundle = registry.build(cfg, device="cpu", remat=plan.remat)
    params, _ = bundle.abstract()
    opt = get_optimizer(plan.optimizer, warmup_cosine(3e-4, 100, 10_000))
    cost = hlocost.count(make_train_step(bundle, opt, accum), params,
                         opt.init(params), 0,
                         registry.input_specs(cfg, shape))
    return cost, hlocost.tensor_bytes(params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    with concurrent.futures.ThreadPoolExecutor(len(RUNS)) as ex:
        futs = {tag: ex.submit(_dryrun, tag, out) for tag in RUNS}
        free = {full: _mesh_free(full) for full in (False, True)}
        return {tag: f.result() for tag, f in futs.items()}, free


@pytest.mark.parametrize("tag", list(RUNS))
def test_dryrun_counts_the_cell(runs, tag):
    got, free = runs
    res, stdout = got[tag]
    assert res["status"] == "ok" and "1/1 cells counted OK" in stdout
    assert REF_KEYS <= set(res)
    pod = tag.endswith("pod")
    assert res["mesh"] == ("2x16x16" if pod else "16x16")
    assert res["chips"] == (512 if pod else 256)
    cost, param_bytes = free[tag == "full"]
    assert abs(res["hlo_flops"] - cost.flops) <= FLOPS_REL * cost.flops
    assert res["collective_bytes"] > 0
    assert {"all-gather", "all-reduce"} <= set(res["collective_by_kind"])
    mem = res["memory_analysis"]
    assert 0 < mem["parameter_bytes"] < param_bytes
    assert mem["optimizer_bytes"] > 0 and mem["input_bytes"] > 0
    assert "seconds to count" in res["timing"]


def test_dryrun_needs_its_own_process():
    """The fake group is the default one: the dry run refuses a world
    that does not fit the production mesh."""
    if torch.distributed.is_initialized():
        pytest.skip("a process group is up in this process")
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_production_mesh(device="cpu")
