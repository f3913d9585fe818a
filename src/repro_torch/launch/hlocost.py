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
up to the elementwise approximations. ``collective_bytes`` is 0 and
``collective_ops`` empty: the port runs no collective inside a step
until the mesh of ROADMAP A8b.
"""
from __future__ import annotations

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


class Counter(TorchDispatchMode):
    """The dispatch mode `count` runs a step under; ``cost`` sums every
    op's `op_cost` and every charged kernel launch."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost += op_cost(func, args, kwargs, out)
        return out

    def charge_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """Charge one launch of hand-written kernel ``name`` on ``meta``
        tensors (its wrapper computes no op this mode sees)."""
        self.cost += Cost(flops=float(flops), bytes=float(nbytes),
                          dot_bytes=float(nbytes),
                          kernel_flops={name: float(flops)})


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
    and buffers): what a device holds of a step's parameters, optimizer
    state and inputs (`launch.roofline.analyze`'s ``bytes_per_device``)."""
    return sum(_nbytes(t) for t in _leaf_tensors(trees))


def _check_meta(tree) -> None:
    for t in _leaf_tensors(tree):
        if t.device.type != "meta":
            raise ValueError(f"count runs on meta tensors only; got a "
                             f"{tuple(t.shape)} tensor on {t.device}")


def count(fn: Callable, *args: Any, **kwargs: Any) -> Cost:
    """The `Cost` of ``fn(*args, **kwargs)``, run on ``meta`` under a
    `Counter`. Every tensor among the arguments (a module's parameters
    and buffers included) must lie on ``meta``; anything else raises."""
    _check_meta((args, kwargs))
    with Counter() as counter:
        fn(*args, **kwargs)
    return counter.cost
