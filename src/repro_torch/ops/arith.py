"""Bit-serial arithmetic over `VerticalColumn` operands (SIMDRAM-style).

The deployable API of the arithmetic layer: element-wise ADD / SUB
(two's-complement, wrapping modulo 2**n_bits), constant and column
LESS-THAN predicates, and SUM aggregation — all over the vertical layout of
`ops.predicate.VerticalColumn`, so a column transposes once and every
arithmetic op after that is bit-plane streaming.

Two execution paths per op, bit-identical:

  * the fast path (`add_columns`, ...) always goes through the bit-serial
    kernel wrappers (`kernels.ops.bitserial_add` / `bitserial_lt`, and the
    BitWeaving scan for `lt_const`): the CUDA kernels for planes on the
    card, their plain versions for planes on the CPU. (The reference
    switched to plain `jnp` under 2**16 bits of planes, a threshold that
    priced a TPU launch.) ``use_kernel`` only agrees with the device or
    raises;
  * the in-DRAM path (`add_columns_dram`, ...) lowers to the maj3+xor AAP
    microprograms of `core.arith_compiler` and executes them through
    `core.engine` — on one subarray or word-sharded across banks via
    `n_banks=` (`core.bankgroup`). By default the planes' device picks the
    VM (the kernel on the card, its plain loop on the CPU);
    ``backend="interp"`` selects the micro-op interpreter oracle, and
    ``"cuda"`` / ``"torch"`` are passed to `engine.execute`.

Tail lanes of a column (padding up to a multiple of 32 values) may hold
garbage after an arithmetic op; every consumer here masks through
`BitVector`/`tail_mask` before counting or comparing, so results over the
`n_values` logical lanes are exact. Results stay on the planes' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import check_use_kernel
from repro_torch.core import arith_compiler, engine
from repro_torch.core.bitplane import BitVector, as_words, tail_mask
from repro_torch.ops.popcount import popcount_words
from repro_torch.ops.predicate import VerticalColumn

_A_PREFIX, _B_PREFIX, _OUT_PREFIX = "X", "Y", "S"


def _check_pair(a: VerticalColumn, b: VerticalColumn) -> None:
    if a.n_bits != b.n_bits:
        raise ValueError(f"width mismatch: {a.n_bits} vs {b.n_bits} bits")
    if a.n_values != b.n_values:
        raise ValueError(
            f"length mismatch: {a.n_values} vs {b.n_values} values")


def _mask(col: VerticalColumn) -> torch.Tensor:
    return as_words(tail_mask(col.n_values), col.planes.device)


# ---------------------------------------------------------------------------
# fast path: the bit-serial kernels (plain versions on the CPU)
# ---------------------------------------------------------------------------


def _add(a: VerticalColumn, b: VerticalColumn, sub: bool,
         use_kernel: Optional[bool]) -> VerticalColumn:
    from repro_torch.kernels import ops as kops

    _check_pair(a, b)
    check_use_kernel(use_kernel, a.planes.device)
    planes = kops.bitserial_add(a.planes, b.planes, sub=sub)
    return VerticalColumn(planes, a.n_bits, a.n_values)


def add_columns(a: VerticalColumn, b: VerticalColumn,
                use_kernel: Optional[bool] = None) -> VerticalColumn:
    """(a + b) mod 2**n_bits, element-wise over the vertical layout."""
    return _add(a, b, False, use_kernel)


def sub_columns(a: VerticalColumn, b: VerticalColumn,
                use_kernel: Optional[bool] = None) -> VerticalColumn:
    """(a - b) mod 2**n_bits — exact for unsigned and two's-complement."""
    return _add(a, b, True, use_kernel)


def lt_columns(a: VerticalColumn, b: VerticalColumn,
               use_kernel: Optional[bool] = None) -> BitVector:
    """Packed predicate bitvector of element-wise unsigned `a < b`."""
    from repro_torch.kernels import ops as kops

    _check_pair(a, b)
    check_use_kernel(use_kernel, a.planes.device)
    words = kops.bitserial_lt(a.planes, b.planes)
    return BitVector(words & _mask(a), a.n_values)


def lt_const(col: VerticalColumn, k: int,
             use_kernel: Optional[bool] = None) -> BitVector:
    """Packed predicate bitvector of `v < k` (unsigned compare).

    Trivial bounds short-circuit (k <= 0 -> all-false, k >= 2**n ->
    all-true); in range this is the BitWeaving scan 0 <= v <= k-1, riding
    the fused between-scan kernel.
    """
    dev = col.planes.device
    check_use_kernel(use_kernel, dev)
    if k <= 0:
        return BitVector.zeros(col.n_values, device=dev)
    if k >= (1 << col.n_bits):
        return BitVector.ones(col.n_values, device=dev)
    return col.scan(0, k - 1, use_kernel)


def weighted_plane_sum(planes: torch.Tensor, mask: torch.Tensor) -> int:
    """sum_j 2**j * popcount(planes[j] & mask): the per-plane counts are
    int64 on the device, read back once, and weighted in exact Python ints
    (a 32-bit column over 2**25 values sums past 2**56)."""
    counts = popcount_words(planes & mask[None, :], axis=-1).tolist()
    return sum(int(c) << j for j, c in enumerate(counts))


def sum_column(col: VerticalColumn) -> int:
    """SUM(col) over the logical lanes: sum_j 2**j * popcount(plane_j)."""
    return weighted_plane_sum(col.planes, _mask(col))


# ---------------------------------------------------------------------------
# in-DRAM path: AAP microprograms through the engine / bank group
# ---------------------------------------------------------------------------


def _plane_state(col: VerticalColumn, prefix: str) -> dict:
    return {f"{prefix}{j}": col.planes[j] for j in range(col.n_bits)}


def _engine_kw(backend: Optional[str]) -> dict:
    """Map the public `backend` knob onto `engine.execute` arguments."""
    if backend is None:
        return {}
    if backend == "interp":
        return {"lowered": False}
    if backend in ("cuda", "torch"):
        return {"lowered": True, "backend": backend}
    raise ValueError(f"unknown backend {backend!r}; expected None (the "
                     "planes' device picks the VM), 'cuda', 'torch' or "
                     "'interp'")


def _add_dram(a: VerticalColumn, b: VerticalColumn, sub: bool,
              n_banks: int, backend: Optional[str]) -> VerticalColumn:
    _check_pair(a, b)
    res = arith_compiler.ripple_add_program(
        a.n_bits, _A_PREFIX, _B_PREFIX, _OUT_PREFIX, sub=sub)
    data = {**_plane_state(a, _A_PREFIX), **_plane_state(b, _B_PREFIX)}
    out = engine.execute(res.program, data, outputs=res.outputs,
                         n_banks=n_banks, **_engine_kw(backend))
    return VerticalColumn(torch.stack([out[o] for o in res.outputs]),
                          a.n_bits, a.n_values)


def add_columns_dram(a: VerticalColumn, b: VerticalColumn,
                     n_banks: int = 1,
                     backend: Optional[str] = None) -> VerticalColumn:
    """ADD through the maj3+xor AAP microprogram on the simulated machine."""
    return _add_dram(a, b, False, n_banks, backend)


def sub_columns_dram(a: VerticalColumn, b: VerticalColumn,
                     n_banks: int = 1,
                     backend: Optional[str] = None) -> VerticalColumn:
    """SUB (a + ~b + 1) through the AAP microprogram."""
    return _add_dram(a, b, True, n_banks, backend)


def lt_columns_dram(a: VerticalColumn, b: VerticalColumn,
                    n_banks: int = 1,
                    backend: Optional[str] = None) -> BitVector:
    """Element-wise `a < b` as one fused single-output AAP program."""
    _check_pair(a, b)
    res = arith_compiler.compile_lt_columns(a.n_bits, "OUT",
                                            _A_PREFIX, _B_PREFIX)
    data = {**_plane_state(a, _A_PREFIX), **_plane_state(b, _B_PREFIX)}
    out = engine.execute(res.program, data, outputs=["OUT"],
                         n_banks=n_banks, **_engine_kw(backend))["OUT"]
    return BitVector(out & _mask(a), a.n_values)


def lt_const_dram(col: VerticalColumn, k: int, n_banks: int = 1,
                  backend: Optional[str] = None) -> BitVector:
    """`v < k` as a fused AAP program (trivial bounds short-circuit)."""
    dev = col.planes.device
    if k <= 0:
        return BitVector.zeros(col.n_values, device=dev)
    if k >= (1 << col.n_bits):
        return BitVector.ones(col.n_values, device=dev)
    res = arith_compiler.compile_lt_const(col.n_bits, k, "OUT", _A_PREFIX)
    assert res is not None
    out = engine.execute(res.program, _plane_state(col, _A_PREFIX),
                         outputs=["OUT"], n_banks=n_banks,
                         **_engine_kw(backend))["OUT"]
    return BitVector(out & _mask(col), col.n_values)


def sum_column_dram(col: VerticalColumn, n_banks: int = 1,
                    backend: Optional[str] = None) -> int:
    """SUM via the plane-readout program (planes staged through the engine,
    host-side weighted bitcount — the paper's §8.1 split)."""
    res = arith_compiler.plane_readout_program(col.n_bits, _A_PREFIX,
                                               _OUT_PREFIX)
    out = engine.execute(res.program, _plane_state(col, _A_PREFIX),
                         outputs=res.outputs, n_banks=n_banks,
                         **_engine_kw(backend))
    planes = torch.stack([out[o] for o in res.outputs])
    return weighted_plane_sum(planes, _mask(col))
