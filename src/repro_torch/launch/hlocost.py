"""A step's FLOPs and bytes, counted on ``meta``.

The counterpart of `repro.launch.hlocost`. The reference walks the
optimized HLO of a compiled step; the port has no HLO, so `count` runs
the step function itself on ``meta`` parameters, optimizer state and
batch (nothing is allocated or computed) under a `TorchDispatchMode`
that prices every aten op the step dispatches, the backward's included:

  * products (``mm``, ``addmm``, ``bmm``, ``baddbmm``): ``2 M N K`` FLOPs
    exactly (an ``addmm`` / ``baddbmm`` adds one per output element for
    its bias); their bytes also go to ``dot_bytes``;
  * reductions (``sum``, ``mean``, ``amax``, ...): one FLOP per input
    element; every other op one per output element, and the
    transcendental ones (``exp``, ``log``, ``rsqrt``, ...) also count in
    ``transcendentals``; a sort ``n log2 n`` -- the reference's
    approximations;
  * bytes: the tensor operands' bytes plus the outputs' (a write-only op
    such as ``copy_`` or ``fill_`` does not read its destination);
    indexed reads (``index``, ``gather``, ``embedding``, ...) twice the
    output's bytes and indexed writes (``index_put_``, ``scatter_add_``,
    ...) twice the written values' bytes, as the reference prices
    dynamic-slice / gather and dynamic-update-slice / scatter;
  * views (`torch._ops.OpOverload.is_view`) and allocations count
    nothing;
  * the flash kernel wrappers, called on ``meta``, charge their launch's
    `kernels.flashattn.flash_cost` (FLOPs and bytes, all of it product
    traffic) through `Counter.charge_kernel`.

How the two counts differ: in eager PyTorch each aten op is one kernel,
which reads its operands from device memory and writes its outputs back,
so this unfused count is close to the bytes the card moves. The
reference counts each XLA fusion's operands and outputs once, so its
``bytes`` sits between its ``dot_bytes`` and this count; the FLOPs agree
up to the elementwise approximations.

On a mesh (a `launch.cells` cell on ``meta`` DTensors, as `launch.dryrun`
runs it) the count sees each op once, at the DTensor level, in its
global shapes: DTensor runs the op on the local shards with the count's
mode off. A `local_map` region (the sharded flash wrapper, the MoE's
dispatch) computes on local shards, which the count sees: each region
wraps its function in `per_shard`, which charges its ops, forward and
backward, once for each of the shards that split the work. An outer
mode beside the count sees the collectives DTensor issues:
``collective_ops`` counts them by the reference's kinds and
``collective_bytes`` sums their operand bytes over every rank of the
world (one rank's operands times the world size), the reference's
whole-step term. An MoE region's sort of all T k routed slots, which
every rank of it runs, counts once per shard: that is work each rank
does, so an MoE cell on a mesh counts a little more than the same cell
without one (a dense cell the same, but for the backward of the KV
heads' slice where the model axis does not divide them).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.logsumexp, aten.var, aten.std, aten.prod,
               aten.argmax, aten.argmin, aten.all, aten.any, aten.norm,
               aten.linalg_vector_norm, aten.var_mean}
_TRANSCENDENTAL = {aten.exp, aten.log, aten.tanh, aten.rsqrt, aten.sqrt,
                   aten.pow, aten.sigmoid, aten.sin, aten.cos, aten.erf,
                   aten.log1p, aten.expm1, aten.silu, aten.gelu,
                   aten._softmax, aten._log_softmax, aten.softplus,
                   aten.exp_, aten.log_, aten.sigmoid_}
_SORTS = {aten.sort, aten.argsort, aten.topk}
_INDEXED_READS = {aten.index, aten.gather, aten.embedding,
                  aten.index_select}
#: indexed writes: (op, position of the written values)
_INDEXED_WRITES = {aten.index_put: 2, aten.index_put_: 2,
                   aten._index_put_impl_: 2, aten.scatter: 3,
                   aten.scatter_: 3, aten.scatter_add: 3,
                   aten.scatter_add_: 3, aten.index_add: 3,
                   aten.index_add_: 3, aten.index_copy: 3,
                   aten.index_copy_: 3}
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.detach,
         aten.lift_fresh, aten.alias, aten.sym_size, aten.sym_stride,
         aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
         aten._local_scalar_dense}


#: the collectives' namespaces: moved, not computed (`_Collectives`)
_COMM = ("_c10d_functional", "c10d_functional", "_dtensor")
#: ops that only lay data out (`Counter._moved_by_collective`)
_LAYOUT = {aten.cat, aten.clone, aten.stack, aten._to_copy, aten.copy_}


@dataclasses.dataclass
class Cost:
    """The reference's `Cost` fields but ``unknown_trip_counts`` (a count
    on ``meta`` sees every iteration of a loop, so there is none to
    miss), plus ``kernel_flops``: the FLOPs charged by hand-written
    kernel launches by kernel name (included in ``flops``)."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: float = 0.0
    collective_ops: Dict[str, float] = dataclasses.field(default_factory=dict)
    # matmul-attributed traffic: the products' operands and outputs
    dot_bytes: float = 0.0
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Cost") -> "Cost":
        self.flops += o.flops
        self.bytes += o.bytes
        self.transcendentals += o.transcendentals
        self.collective_bytes += o.collective_bytes
        for k, v in o.collective_ops.items():
            self.collective_ops[k] = self.collective_ops.get(k, 0) + v
        self.dot_bytes += o.dot_bytes
        for k, v in o.kernel_flops.items():
            self.kernel_flops[k] = self.kernel_flops.get(k, 0) + v
        return self


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_flops(packet, args) -> float:
    """2 M N K of one product, plus one per output element of a bias."""
    if packet in (aten.mm, aten.bmm):
        a, b = args[0], args[1]
        bias = 0
    else:                                   # addmm / baddbmm(bias, a, b)
        a, b = args[1], args[2]
        bias = 1
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    return 2.0 * batch * m * n * k + bias * batch * m * n


def op_cost(func, args, kwargs, out) -> Cost:
    """The `Cost` of one dispatched aten op (the module docstring)."""
    c = Cost()
    packet = func.overloadpacket
    if func.is_view or packet in _FREE:
        return c
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    in_bytes = float(sum(_nbytes(t) for t in ins))
    out_bytes = float(sum(_nbytes(t) for t in outs))
    out_elems = float(sum(t.numel() for t in outs))
    if packet in _PRODUCTS:
        c.flops = _product_flops(packet, args)
        c.bytes = c.dot_bytes = in_bytes + out_bytes
        return c
    if packet in _INDEXED_READS:
        c.flops, c.bytes = out_elems, 2.0 * out_bytes
        return c
    if packet in _INDEXED_WRITES:
        pos = _INDEXED_WRITES[packet]
        vals = args[pos] if len(args) > pos else None
        upd = float(_nbytes(vals)) if isinstance(vals, torch.Tensor) else 0.0
        c.flops, c.bytes = out_elems, 2.0 * upd
        return c
    if packet in _WRITE_ONLY:
        c.bytes = out_bytes + in_bytes - float(_nbytes(args[0]))
        c.flops = out_elems if packet is not aten.copy_ else 0.0
        return c
    c.bytes = in_bytes + out_bytes
    if packet in _REDUCTIONS:
        c.flops = float(ins[0].numel()) if ins else out_elems
    elif packet in _SORTS:
        n = float(ins[0].numel()) if ins else out_elems
        c.flops = n * max(1.0, math.log2(max(n, 2.0)))
    else:
        c.flops = out_elems
        if packet in _TRANSCENDENTAL:
            c.transcendentals = out_elems
    return c


def _scaled(c: Cost, n: float) -> Cost:
    if n == 1:
        return c
    return Cost(c.flops * n, c.bytes * n, c.transcendentals * n,
                c.collective_bytes, dict(c.collective_ops), c.dot_bytes * n,
                {k: v * n for k, v in c.kernel_flops.items()})


class Counter(TorchDispatchMode):
    """The dispatch mode `count` runs a step under; ``cost`` sums every
    op's `op_cost` and every charged kernel launch, each times ``scale``
    (the shards of a `per_shard` region)."""

    def __init__(self):
        from torch.utils.weak import WeakIdKeyDictionary
        super().__init__()
        self.cost = Cost()
        self.scale = 1
        # a collective's outputs and what only lays them out (`_moved`)
        self._moved = WeakIdKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._moved_by_collective(func, args, kwargs):
            for t in _tensors(out):
                self._moved[t] = True
        else:
            self.cost += _scaled(op_cost(func, args, kwargs, out),
                                 self.scale)
        return out

    def _moved_by_collective(self, func, args, kwargs) -> bool:
        """A collective, or a view, concatenation or copy of nothing but
        collectives' outputs: DTensor laying a gathered tensor out, part
        of the collective (`_Collectives` counts it), not a compute op."""
        if func.namespace in _COMM:
            return True
        if not (func.is_view or func.overloadpacket in _LAYOUT):
            return False
        ins = _tensors((args, kwargs))
        return bool(ins) and all(t in self._moved for t in ins)

    def charge_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """Charge one launch of hand-written kernel ``name`` on ``meta``
        tensors (its wrapper computes no op this mode sees)."""
        self.cost += _scaled(Cost(flops=float(flops), bytes=float(nbytes),
                                  dot_bytes=float(nbytes),
                                  kernel_flops={name: float(flops)}),
                             self.scale)


def _counters() -> list:
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, Counter)]


def _rescale(factor: float) -> None:
    for c in _counters():
        c.scale *= factor


class _Scope(torch.autograd.Function):
    """The identity, whose backward multiplies the counts' scale by
    ``factor``: at a region's outputs (its backward starts there) the
    shards, at its inputs (its backward ends there) their inverse."""

    @staticmethod
    def forward(ctx, factor, *xs):
        ctx.factor = factor
        return tuple(x.view_as(x) if isinstance(x, torch.Tensor) else x
                     for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _rescale(ctx.factor)
        return (None, *grads)


@contextlib.contextmanager
def _shards(n: int):
    _rescale(n)
    try:
        yield
    finally:
        _rescale(1 / n)


def per_shard(fn: Callable, n: int) -> Callable:
    """``fn``, a `local_map` region's function whose work is split into
    ``n`` equal shards over the ranks: under a count, its ops (and those
    of its backward) are charged ``n`` times, the whole work once;
    otherwise ``fn`` itself."""

    def run(*args):
        if n == 1 or not _counters():
            return fn(*args)
        grad = torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args)
        if grad:
            args = _Scope.apply(1 / n, *args)
        with _shards(n):
            out = fn(*args)
        if not grad:
            return out
        single = isinstance(out, torch.Tensor)
        out = _Scope.apply(n, *((out,) if single else out))
        return out[0] if single else out

    return run


#: the reference's collective kinds by functional-collective op
_COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather",
                     "all_reduce": "all-reduce",
                     "reduce_scatter_tensor": "reduce-scatter",
                     "all_to_all_single": "all-to-all",
                     "broadcast": "collective-broadcast"}


class _Collectives(TorchDispatchMode):
    """Beside a `Counter`, outside it: lets DTensor desugar its ops
    (``NotImplemented``) and records the collectives among what comes
    back, with one rank's operand bytes."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, float] = {}
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _COLLECTIVE_KINDS.get(getattr(func.overloadpacket,
                                             "__name__", ""))
        if kind is not None:
            self.ops[kind] = self.ops.get(kind, 0) + 1
            self.bytes += float(sum(_nbytes(t) for t in _tensors(args)))
        return out


def _leaf_tensors(tree) -> list:
    """Every tensor of ``tree``, a module's parameters and buffers
    included."""
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.nn.Module):
            out += list(t.parameters()) + list(t.buffers())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def tensor_bytes(*trees: Any) -> int:
    """The bytes of every tensor in ``trees`` (modules: their parameters
    and buffers), of a DTensor its local shards: what a device holds of a
    step's parameters, optimizer state and inputs
    (`launch.roofline.analyze`'s ``bytes_per_device``)."""
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _leaf_tensors(trees))


def _check_meta(tree) -> None:
    for t in _leaf_tensors(tree):
        if t.device.type != "meta":
            raise ValueError(f"count runs on meta tensors only; got a "
                             f"{tuple(t.shape)} tensor on {t.device}")


def count(fn: Callable, *args: Any, **kwargs: Any) -> Cost:
    """The `Cost` of ``fn(*args, **kwargs)``, run on ``meta`` under a
    `Counter`. Every tensor among the arguments (a module's parameters
    and buffers included) must lie on ``meta``; anything else raises."""
    import torch.distributed as dist
    _check_meta((args, kwargs))
    with _Collectives() as coll, Counter() as counter:
        fn(*args, **kwargs)
    world = dist.get_world_size() if dist.is_initialized() else 1
    counter.cost.collective_bytes = coll.bytes * world
    counter.cost.collective_ops = dict(coll.ops)
    return counter.cost
