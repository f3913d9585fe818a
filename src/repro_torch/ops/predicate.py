"""BitWeaving-style predicate evaluation over integer columns (paper §8.2).

`VerticalColumn.encode` transposes a column into vertical bit planes
(`ops.transpose.to_vertical`); `scan(column, lo, hi)` evaluates
``lo <= v <= hi`` for every value through the fused BitWeaving kernel and
returns a packed result bitvector — the core of the paper's database-scan
workload. `range_scan_expr` lowers the same predicate to a fusable DAG the
service compiles into one AAP program.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import check_use_kernel, operand_device
from repro_torch.core.bitplane import BitVector, as_words, i32
from repro_torch.ops.transpose import to_vertical


def between_scan(planes, lo: int, hi: int, n_bits: int,
                 use_kernel: Optional[bool] = None,
                 device=None) -> torch.Tensor:
    """Packed result words of lo <= v <= hi over vertical bit planes.

    The public seam over the fused between-scan (`kernels.ops.
    bitweaving_scan`): one streaming pass that keeps all four comparison
    states in registers. The planes' device picks the path — the CUDA
    kernel on the card, its plain version (`kernels.ref.bitweaving_scan`)
    on the CPU — with no size threshold (the reference's priced a TPU
    launch). Host planes go to ``device`` (default ``"cuda"``);
    ``use_kernel`` that disagrees with the device raises.
    """
    from repro_torch.kernels import ops as kops

    dev = operand_device([planes], device)
    check_use_kernel(use_kernel, dev)
    return kops.bitweaving_scan(as_words(planes, dev), int(lo), int(hi),
                                n_bits)


@dataclasses.dataclass
class VerticalColumn:
    """An integer column in BitWeaving-V layout."""

    planes: torch.Tensor   # (n_bits, n//32) int32 words
    n_bits: int
    n_values: int

    @classmethod
    def encode(cls, values, n_bits: int,
               device: Optional[torch.device] = None) -> "VerticalColumn":
        """Transpose `values` (< 2**n_bits) into vertical bit planes: a
        tensor's on its own device, host values' on ``device`` (default
        ``"cuda"``).

        Tail positions are padded with an out-of-range sentinel so range
        predicates never select them.
        """
        values = as_words(values, operand_device([values], device))
        n = values.shape[0]
        pad = (-n) % 32
        if pad:
            # pad with sentinel > any real value so range predicates exclude it
            values = torch.cat([values, torch.full(
                (pad,), i32((1 << n_bits) - 1), dtype=torch.int32,
                device=values.device)])
        return cls(to_vertical(values, n_bits), n_bits, n)

    def scan(self, lo: int, hi: int, use_kernel: Optional[bool] = None
             ) -> BitVector:
        """Packed bitvector of lo <= v <= hi (tail padding masked off)."""
        words = between_scan(self.planes, lo, hi, self.n_bits, use_kernel)
        bv = BitVector(words, self.n_values)
        return BitVector(words & bv._mask(), self.n_values)


def scan_count(values, n_bits: int, lo: int, hi: int,
               device=None) -> torch.Tensor:
    """select count(*) from T where lo <= val <= hi (one-shot), as a 0-dim
    int64 tensor on the column's device."""
    from repro_torch.kernels import ops as kops

    col = VerticalColumn.encode(values, n_bits, device=device)
    return kops.popcount(col.scan(lo, hi).words)


# ---------------------------------------------------------------------------
# In-DRAM lowering: the range predicate as a fusable expression DAG
# ---------------------------------------------------------------------------


def range_scan_expr(n_bits: int, lo: int, hi: int, plane_prefix: str = "P"):
    """The predicate lo <= v <= hi as a boolean expression DAG over plane
    rows `P0..P{n_bits-1}` (LSB-first, one D-group row per bit plane).

    This is the multi-term-predicate path of the fusing compiler: feed the
    returned `Expr` to `core.compiler.compile_expr_fused` and the whole
    scan lowers to ONE minimized AAP program (constants folded at build
    time, shared eq-prefixes CSE'd, `eq & ~P` terms fused to ANDNOT).
    """
    from repro_torch.core.compiler import Expr

    planes = [Expr.of(f"{plane_prefix}{j}") for j in range(n_bits)]

    def cmp_const(c: int):
        """(lt, eq) exprs vs constant c, MSB->LSB; None folds 0/1 consts."""
        lt, eq = None, None
        for j in range(n_bits - 1, -1, -1):
            pj = planes[j]
            if (c >> j) & 1:
                term = ~pj if eq is None else eq & ~pj
                lt = term if lt is None else lt | term
                eq = pj if eq is None else eq & pj
            else:
                eq = ~pj if eq is None else eq & ~pj
        return lt, eq

    lt_lo, _ = cmp_const(lo)           # v <  lo
    lt_hi, eq_hi = cmp_const(hi)       # v <  hi, v == hi
    le_hi = eq_hi if lt_hi is None else lt_hi | eq_hi
    if lt_lo is None:                  # lo == 0: lower bound always holds
        return le_hi
    return le_hi & ~lt_lo


def compile_range_scan(n_bits: int, lo: int, hi: int, dst: str = "OUT",
                       plane_prefix: str = "P"):
    """Fused AAP program for the range scan (see `range_scan_expr`)."""
    from repro_torch.core.compiler import compile_expr_fused

    return compile_expr_fused(range_scan_expr(n_bits, lo, hi, plane_prefix),
                              dst)
