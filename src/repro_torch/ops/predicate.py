"""BitWeaving-style integer columns (paper §8.2) and their range predicate.

`VerticalColumn.encode` transposes a column into vertical bit planes
(`ops.transpose.to_vertical`); `range_scan_expr` lowers ``lo <= v <= hi``
to a fusable predicate DAG the service compiles into one AAP program.
The direct between-scan (`between_scan`, `VerticalColumn.scan`) needs the
BitWeaving kernel and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.bitplane import as_words, i32
from repro_torch.ops.transpose import to_vertical


@dataclasses.dataclass
class VerticalColumn:
    """An integer column in BitWeaving-V layout."""

    planes: torch.Tensor   # (n_bits, n//32) int32 words
    n_bits: int
    n_values: int

    @classmethod
    def encode(cls, values, n_bits: int,
               device: Optional[torch.device] = None) -> "VerticalColumn":
        """Transpose `values` (< 2**n_bits) into vertical bit planes on
        ``device`` (the values' own device when None).

        Tail positions are padded with an out-of-range sentinel so range
        predicates never select them.
        """
        values = as_words(values, device)
        n = values.shape[0]
        pad = (-n) % 32
        if pad:
            # pad with sentinel > any real value so range predicates exclude it
            values = torch.cat([values, torch.full(
                (pad,), i32((1 << n_bits) - 1), dtype=torch.int32,
                device=values.device)])
        return cls(to_vertical(values, n_bits), n_bits, n)


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
