"""Device meshes over the ranks that `torch.distributed` has initialized.

The counterpart of `repro.launch.mesh`. The reference's meshes are JAX
`Mesh`es over its devices; here a mesh is a `DeviceMesh` over the world
of ranks, with the reference's axis names: ``("data", "model")``, and
``("pod", "data", "model")`` for the multi-pod production mesh. Both
makers are functions, never module constants, and read the world when
called; a world whose size does not fit the shape raises (nothing shrinks
the mesh to fit, and nothing falls back on the CPU).

Ranks come from a ``torchrun``-style launch (`init_from_env` reads
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``) or from
`run_ranks`, which spawns ``world`` processes on this host, joins them in
one process group over ``tcp://127.0.0.1`` and returns what each rank's
function returned. The dry run (`launch.dryrun`) makes the production
mesh over a ``"fake"`` process group of 256 or 512 ranks in one process.
"""
from __future__ import annotations

import math
import os
import socket
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import resolve_device

HOST_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the ranks of torch.distributed: "
                           "call init_process_group (or init_from_env, or "
                           "run under run_ranks) first")
    return dist.get_world_size()


def _mesh(device: str, shape: Tuple[int, ...],
          axes: Tuple[str, ...]) -> DeviceMesh:
    n = _world()
    if math.prod(shape) != n or min(shape) < 1:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the world has {n}")
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    if multi_pod:
        return _mesh(device, (2, 16, 16), POD_AXES)
    return _mesh(device, (16, 16), HOST_AXES)


def make_host_mesh(data: Optional[int] = None, model: int = 1,
                   device: str = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the world: ``data`` defaults to the
    world size over ``model``; raises unless ``data * model`` is the
    world size."""
    n = _world()
    if model < 1 or (data is None and n % model):
        raise ValueError(f"--model-parallel {model} does not divide the "
                         f"world of {n} ranks")
    data = data or n // model
    return _mesh(device, (data, model), HOST_AXES)


def axis_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group of ``mesh``'s axes ``axes`` that holds this
    rank: one axis's own group, or for several axes the group of their
    flattened product (the reference's tuple of data-parallel axes)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


# --------------------------------------------------------------------------
# launching ranks
# --------------------------------------------------------------------------

def init_from_env(backend: str = "gloo") -> Tuple[int, int]:
    """Join the process group of a ``torchrun``-style launch (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment)
    unless this process has joined one already; returns (rank, world)."""
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group and no torchrun "
                               f"environment ({', '.join(missing)} unset)")
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str,
               fn: Callable, args: tuple, queue) -> None:
    # no LOCAL_RANK: DeviceMesh then takes rank % cards as this rank's
    # card, so two ranks may share one card (gloo)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        dist.init_process_group(backend, init_method="env://")
        out = fn(rank, world, *args)
        queue.put((rank, True, out))
    except BaseException:                 # handed back to the caller
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args: Any, backend: str = "gloo",
              timeout: float = 600.0) -> List[Any]:
    """``[fn(rank, world, *args) for rank in range(world)]``, each call in
    a spawned process that has joined a ``world``-rank process group of
    ``backend`` (``fn`` and ``args`` must pickle; ``fn`` a module-level
    function). Raises with the failing rank's traceback if a rank
    raises; every process is ended before it returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    try:
        for _ in range(world):
            rank, ok, out = queue.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
