"""Cell construction: one (architecture x input shape x mesh) cell = a
step function, its arguments laid out on the mesh, and their placements.

The counterpart of `repro.launch.cells`. The reference's cell holds
``ShapeDtypeStruct`` arguments and ``NamedSharding``s and lowers the
jitted step; here the arguments are DTensors on a `DeviceMesh`, laid
out with the placements `dist.sharding.tree_shardings` gives (the
parameters from `registry.param_spec`, the optimizer state beside them,
the inputs from `registry.batch_logical_specs`), and `Cell.run` runs the
step eagerly under the contexts the reference's ``lower`` sets:
`axis_rules` with the plan's rules, `layers.attention_remat`,
`layers.attention_backend` and `moe.moe_constraints`.

With no ``params`` / ``batch`` given, the arguments are the abstract ones
(`bundle.abstract()` and `registry.input_specs` on ``meta``): nothing is
allocated, and `launch.hlocost.count` or `launch.dryrun` can run the
cell. Given ``params`` (the whole model on every rank, e.g. carried
across from the reference by `convert.model_params_from_reference`) and
``batch`` (the whole global batch on every rank), each rank keeps its own
shards and the cell computes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import SHAPES, ShapeConfig, get_config, reduced
from repro_torch.dist.sharding import (DECODE_SP_RULES, DEFAULT_RULES,
                                       DP_RULES, SP_RULES, axis_rules,
                                       distribute, strip_axes,
                                       tree_shardings)
from repro_torch.launch.plans import CellPlan, plan_for
from repro_torch.models import registry
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.step import make_train_step


def rules_named(name: str):
    return {"default": DEFAULT_RULES, "sp": SP_RULES,
            "decode_sp": DECODE_SP_RULES, "dp": DP_RULES}.get(
        name, DEFAULT_RULES)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    plan: CellPlan
    fn: Callable                  # the step
    args: Tuple                   # its arguments, DTensors on the mesh
    in_shardings: Tuple           # their placements, by name per tree
    mesh: DeviceMesh              # the mesh the arguments lie on
    rules: Dict[str, Tuple[str, ...]]

    def run(self, *args):
        """The step on ``args`` (default the cell's own) under the plan's
        contexts (the reference's ``Cell.lower`` sets the same)."""
        from repro_torch.models.layers import (attention_backend,
                                               attention_remat)
        from repro_torch.models.moe import moe_constraints
        with axis_rules(self.mesh, self.rules), \
                attention_remat(self.plan.attn_remat), \
                attention_backend(self.plan.attn_kernel), \
                moe_constraints(self.plan.moe_constrain):
            return self.fn(*(args or self.args))


def shard_module(model: nn.Module, placements: Dict[str, Any],
                 mesh: DeviceMesh) -> nn.Module:
    """Replace each parameter of ``model`` (whole on every rank) by a
    DTensor of its ``placements`` (this rank's shards only), in place."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = nn.Parameter(
            distribute(p.detach(), mesh, placements[name]),
            requires_grad=p.requires_grad)
    return model


def shard_tree(tree: Dict[str, Any], placements: Dict[str, Any],
               mesh: DeviceMesh, prefix: str = "") -> Dict[str, Any]:
    """A nested dict of tensors (whole on every rank) as DTensors of
    ``placements`` (`tree_shardings`' names); other leaves stay."""
    out = {}
    for k, v in tree.items():
        name = prefix + k
        if isinstance(v, dict):
            out[k] = shard_tree(v, placements, mesh, name + ".")
        elif isinstance(v, torch.Tensor):
            out[k] = distribute(v, mesh, placements[name])
        else:
            out[k] = v
    return out


def _batch(cfg, shape, mesh, rules, batch):
    specs = registry.batch_logical_specs(cfg, shape)
    tree = batch if batch is not None else registry.input_specs(cfg, shape)
    shapes = {k: v for k, v in tree.items() if k != "pos"}
    specs = {k: v for k, v in specs.items() if k != "pos"}
    placements = tree_shardings(shapes, specs, mesh, rules)
    return shard_tree(tree, placements, mesh), placements


def build_cell(arch: str, shape_name: str, mesh: DeviceMesh,
               overrides: Optional[dict] = None,
               reduce_config: bool = False,
               shape_override: Optional[ShapeConfig] = None,
               params: Optional[nn.Module] = None,
               batch: Optional[Dict[str, Any]] = None,
               config_override: Optional[dict] = None,
               lr_fn: Optional[Callable] = None) -> Cell:
    """The cell of ``arch`` x ``shape_name`` on ``mesh`` (the reference's
    `build_cell` and arguments, plus ``params`` / ``batch`` to compute
    with, ``config_override`` (`dataclasses.replace` fields of the
    config, such as a depth cut or float32) and the train step's
    ``lr_fn``). The shards lie on ``params``' device, on ``meta`` when
    ``params`` is None."""
    cfg = get_config(arch)
    if reduce_config:
        cfg = reduced(cfg)
    if config_override:
        cfg = dataclasses.replace(cfg, **config_override)
    shape = shape_override or SHAPES[shape_name]
    plan = plan_for(cfg, shape, overrides)
    # clamp accumulation to a divisor of the (possibly overridden) batch
    accum = plan.grad_accum
    while accum > 1 and shape.global_batch % accum:
        accum //= 2
    if accum != plan.grad_accum:
        plan = dataclasses.replace(plan, grad_accum=accum)
    rules = rules_named(plan.rules)
    device = "cpu" if params is None else params.device
    bundle = registry.build(cfg, device=device, remat=plan.remat)
    model, specs = bundle.abstract()
    if params is not None:
        model = params
    lr_fn = lr_fn or warmup_cosine(3e-4, 100, 10_000)
    names = mesh.mesh_dim_names

    if shape.kind == "train" and plan.compressed_dp:
        # majority-vote 1-bit signSGD over the data axes: the parameters
        # are sharded over the model axis only (replicated over the data
        # axes, the reference's DP layout), and each data rank takes its
        # share of the whole batch inside the step
        from repro_torch.launch.mesh import axis_group
        from repro_torch.train.step import make_train_step_compressed
        dp_axes = tuple(a for a in ("pod", "data") if a in names)
        sub = mesh["model"] if "model" in names else None
        rules = strip_axes(rules, dp_axes)
        group = axis_group(mesh, dp_axes)
        opt = get_optimizer("signum", lr_fn, group=group)
        if sub is not None:
            model = shard_module(
                model, tree_shardings(model, specs, sub, rules), sub)
        step_fn = make_train_step_compressed(bundle, opt, group,
                                             grad_accum=plan.grad_accum)
        tree = batch if batch is not None else \
            registry.input_specs(cfg, shape)
        args = (model, opt.init(model), 0, tree)
        return Cell(arch, shape, plan, step_fn, args, ({}, {}, None, {}),
                    sub if sub is not None else mesh, rules)

    p_pl = tree_shardings(model, specs, mesh, rules)
    model = shard_module(model, p_pl, mesh)
    b_tree, b_pl = _batch(cfg, shape, mesh, rules, batch)
    if shape.kind == "train":
        opt = get_optimizer(plan.optimizer, lr_fn)
        step_fn = make_train_step(bundle, opt, grad_accum=plan.grad_accum)
        opt_state = opt.init(model)
        args = (model, opt_state, 0, b_tree)
        return Cell(arch, shape, plan, step_fn, args,
                    (p_pl, _opt_shardings(opt_state), None, b_pl), mesh,
                    rules)
    if shape.kind == "prefill":
        args = (model, b_tree)
        return Cell(arch, shape, plan, bundle.prefill, args, (p_pl, b_pl),
                    mesh, rules)
    # decode: serve_step(params, token, cache, pos)
    # the abstract position (a meta scalar) decodes into the last slot
    pos = b_tree["pos"]
    pos = shape.seq_len - 1 if getattr(pos, "is_meta", False) else int(pos)
    args = (model, b_tree["token"], b_tree["cache"], pos)
    return Cell(arch, shape, plan, bundle.decode_step, args,
                (p_pl, b_pl["token"], {k: v for k, v in b_pl.items()
                                       if k.startswith("cache.")}, None),
                mesh, rules)


def _opt_shardings(tree):
    """Name -> placements of the optimizer state (a nested dict of
    DTensors): the optimizers lay each leaf's state out beside its
    parameter (`optim.optimizers._leaf_zeros`), as the reference's
    ``_opt_shardings`` does, and this reads them back."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": p for n, p in _opt_shardings(v).items()})
        elif hasattr(v, "placements"):
            out[k] = tuple(v.placements)
    return out
