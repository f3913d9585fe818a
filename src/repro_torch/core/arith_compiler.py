"""Bit-serial arithmetic microprograms over vertical bit planes.

Buddy's triple-row activation *is* the MAJ(a, b, c) primitive that SIMDRAM
(Hajinazar et al., 2021) composes into full adders: for operands laid out
vertically (one D-group row per bit position, `ops.predicate.VerticalColumn`),
an n-bit ADD is n full-adder steps where

    sum_j   = a_j XOR b_j XOR carry      (two Fig. 8 XOR programs)
    carry'  = MAJ(a_j, b_j, carry)       (one native TRA — `maj3_program`)

and every value in the row computes simultaneously — one AAP sequence per
*bit position*, not per element. This module is the microprogram library for
that layer: ripple-carry ADD, two's-complement SUB, constant/column LESS-THAN
(as fusable `Expr` DAGs riding `compile_expr_fused`), and the plane-readout
program behind SUM aggregation. Emitted programs run unchanged through
`core.engine.execute` (single subarray or `n_banks=` bank-parallel) and are
minimized by the same dead-temp peephole as the boolean compiler.

Cost shape (pre-peephole, n-bit operands): ADD is `11 + 18*(n-2) + 14`
commands (LSB needs no carry-in, MSB no carry-out), SUB adds one NOT per
middle bit for the ~b operand; both are O(n) AAP sequences evaluating 65536
elements per row-block.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

from repro_torch.core.commands import Command, Program
from repro_torch.core.compiler import (CompileResult, Expr, and_program,
                                 compile_expr_fused, copy_program,
                                 maj3_program, not_program, optimize_program,
                                 or_program, xnor_program, xor_program,
                                 _cmd_addrs)


# Plane names generated from a prefix must stay clear of the reserved
# B/C-group *addresses* and designated rows: a prefix of "B" would generate
# "B0", which the address map resolves to designated row T0, silently
# reading control state instead of the operand plane.
_RESERVED_PLANE_RE = re.compile(r"^(B\d+|C[01]|T[0-3]|DCC[01])$")


def _check_prefix(prefix: str, n_bits: int) -> None:
    for j in (0, max(0, n_bits - 1)):
        name = f"{prefix}{j}"
        if _RESERVED_PLANE_RE.match(name):
            raise ValueError(
                f"plane prefix {prefix!r} generates reserved address "
                f"{name!r}; pick a non-colliding prefix")


@dataclasses.dataclass
class ArithResult:
    """A compiled multi-output arithmetic program.

    `outputs[j]` is the row holding result bit-plane j (LSB-first), so the
    integer result of element i is sum_j 2**j * bit(outputs[j], i).
    """

    program: Program
    outputs: List[str]
    n_temp_rows: int


def rename_rows(program: Program, mapping: dict) -> Program:
    """Rewrite D-group row names in a program (identity for B/C addresses).

    Lets one compiled microprogram serve any plane naming scheme — the
    service planner renames the library's X/Y operand planes to canonical
    IN0..IN{2n-1} so arithmetic plans share the boolean plan cache.
    """
    from repro_torch.core.commands import AAP, AP

    def m(a: str) -> str:
        return mapping.get(a, a)

    cmds: List[Command] = [
        AAP(m(c.addr1), m(c.addr2)) if isinstance(c, AAP) else AP(m(c.addr))
        for c in program.commands
    ]
    return Program(cmds, program.comment)


def _finish(commands: List[Command], outputs: List[str], comment: str,
            temp_prefix: str) -> ArithResult:
    prog = optimize_program(Program(commands, comment), temp_prefix)
    temps = {a for c in prog.commands for a in _cmd_addrs(c)
             if a.startswith(temp_prefix)}
    return ArithResult(prog, outputs, len(temps))


def ripple_add_program(n_bits: int, a_prefix: str = "X", b_prefix: str = "Y",
                       out_prefix: str = "S", sub: bool = False,
                       temp_prefix: str = "TMP") -> ArithResult:
    """n-bit ripple-carry ADD (or two's-complement SUB) over bit planes.

    Reads planes `{a_prefix}j` / `{b_prefix}j`, writes `{out_prefix}j`,
    j = 0..n_bits-1 LSB-first; the result wraps modulo 2**n_bits (the
    carry/borrow out of the MSB is dropped), which makes the same program
    correct for unsigned and for two's-complement signed operands.

    SUB computes a + ~b + 1: the carry-in of 1 cancels the LSB negation
    (a0 ^ ~b0 ^ 1 == a0 ^ b0) and the middle bits use XNOR for the sum half
    and a NOT-staged ~b_j for the MAJ carry — the dual-contact rows make
    the complement a 2-AAP affair instead of a separate pass.
    """
    if n_bits < 1:
        raise ValueError(f"n_bits must be >= 1, got {n_bits}")
    for p in (a_prefix, b_prefix, out_prefix):
        _check_prefix(p, n_bits)
    cmds: List[Command] = []
    outputs = [f"{out_prefix}{j}" for j in range(n_bits)]
    carry = f"{temp_prefix}_c0"
    carry_alt = f"{temp_prefix}_c1"
    nb = f"{temp_prefix}_nb"
    name = "sub" if sub else "add"

    # LSB: carry-in is 0 (add) / 1 (sub); either way no carry row yet.
    a0, b0 = f"{a_prefix}0", f"{b_prefix}0"
    cmds += xor_program(a0, b0, outputs[0]).commands
    if n_bits == 1:
        return _finish(cmds, outputs, f"{name}{n_bits}", temp_prefix)
    if sub:
        # borrow-free = a0 | ~b0  (MAJ(a0, ~b0, 1))
        cmds += not_program(b0, nb).commands
        cmds += or_program(a0, nb, carry).commands
    else:
        cmds += and_program(a0, b0, carry).commands

    for j in range(1, n_bits):
        aj, bj = f"{a_prefix}{j}", f"{b_prefix}{j}"
        half = f"{temp_prefix}_x{j}"            # per-bit name: peephole fuel
        mk_half = xnor_program if sub else xor_program
        cmds += mk_half(aj, bj, half).commands  # a_j ^ b_j (^1 when sub)
        cmds += xor_program(half, carry, outputs[j]).commands
        if j < n_bits - 1:                      # MSB carry-out is dropped
            if sub:
                cmds += not_program(bj, nb).commands
                cmds += maj3_program(aj, nb, carry, carry_alt).commands
            else:
                cmds += maj3_program(aj, bj, carry, carry_alt).commands
            carry, carry_alt = carry_alt, carry
    return _finish(cmds, outputs, f"{name}{n_bits}", temp_prefix)


def ripple_sub_program(n_bits: int, a_prefix: str = "X", b_prefix: str = "Y",
                       out_prefix: str = "S",
                       temp_prefix: str = "TMP") -> ArithResult:
    """a - b as a + ~b + 1 (see `ripple_add_program`)."""
    return ripple_add_program(n_bits, a_prefix, b_prefix, out_prefix,
                              sub=True, temp_prefix=temp_prefix)


def plane_readout_program(n_bits: int, in_prefix: str = "X",
                          out_prefix: str = "S") -> ArithResult:
    """Stage every input plane into an output row (one RowClone AAP each).

    The in-DRAM half of SUM aggregation: SUM(col) = sum_j 2**j *
    popcount(plane_j), so the DRAM's job is only to expose the planes (the
    bit-counting stays host-side, like the paper's §8.1 bitcount). Routing
    the copies through a program keeps SUM on the same plan-cache/
    scheduler/cost-model path as every other query shape.
    """
    if n_bits < 1:
        raise ValueError(f"n_bits must be >= 1, got {n_bits}")
    for p in (in_prefix, out_prefix):
        _check_prefix(p, n_bits)
    cmds: List[Command] = []
    outputs = [f"{out_prefix}{j}" for j in range(n_bits)]
    for j in range(n_bits):
        cmds += copy_program(f"{in_prefix}{j}", outputs[j]).commands
    return ArithResult(Program(cmds, f"readout{n_bits}"), outputs, 0)


# ---------------------------------------------------------------------------
# Comparisons: boolean DAGs over planes -> single-output fused programs
# ---------------------------------------------------------------------------


def lt_const_expr(n_bits: int, k: int,
                  prefix: str = "X") -> Optional[Expr]:
    """`v < k` over planes `{prefix}0..{prefix}{n-1}` as a fusable Expr.

    MSB-first bit-serial compare (BitWeaving §4): where k has a 1, any value
    with a 0 there (and equal above) is smaller. Returns None when the
    predicate is constant-false (k <= 0); a constant-true predicate
    (k >= 2**n_bits) raises — callers own the trivial cases, the expression
    language has no literals.
    """
    _check_prefix(prefix, n_bits)
    if k <= 0:
        return None
    if k >= (1 << n_bits):
        raise ValueError(
            f"v < {k} is constant-true for {n_bits}-bit v; handle trivially")
    lt: Optional[Expr] = None
    eq: Optional[Expr] = None
    for j in range(n_bits - 1, -1, -1):
        pj = Expr.of(f"{prefix}{j}")
        if (k >> j) & 1:
            term = ~pj if eq is None else eq & ~pj
            lt = term if lt is None else lt | term
            eq = pj if eq is None else eq & pj
        else:
            eq = ~pj if eq is None else eq & ~pj
    assert lt is not None
    return lt


def lt_columns_expr(n_bits: int, a_prefix: str = "X",
                    b_prefix: str = "Y") -> Expr:
    """`a < b` element-wise over two plane sets as a fusable Expr DAG.

    lt = OR_j (eq_above_j & ~a_j & b_j) with eq_above the running XNOR
    chain; shared sub-DAGs (each eq prefix) are CSE'd by the compiler and
    the ~a_j & b_j terms fuse to ANDNOT, so the whole compare is one
    minimized AAP program.
    """
    if n_bits < 1:
        raise ValueError(f"n_bits must be >= 1, got {n_bits}")
    for p in (a_prefix, b_prefix):
        _check_prefix(p, n_bits)
    lt: Optional[Expr] = None
    eq: Optional[Expr] = None
    for j in range(n_bits - 1, -1, -1):
        aj, bj = Expr.of(f"{a_prefix}{j}"), Expr.of(f"{b_prefix}{j}")
        term = ~aj & bj if eq is None else eq & ~aj & bj
        lt = term if lt is None else lt | term
        if j > 0:                                # eq unused after the LSB
            eqj = ~(aj ^ bj)
            eq = eqj if eq is None else eq & eqj
    assert lt is not None
    return lt


def compile_lt_const(n_bits: int, k: int, dst: str = "OUT",
                     prefix: str = "X") -> Optional[CompileResult]:
    """Fused single-output program for `v < k` (None if constant-false)."""
    e = lt_const_expr(n_bits, k, prefix)
    return None if e is None else compile_expr_fused(e, dst)


def compile_lt_columns(n_bits: int, dst: str = "OUT", a_prefix: str = "X",
                       b_prefix: str = "Y") -> CompileResult:
    """Fused single-output program for element-wise `a < b`."""
    return compile_expr_fused(lt_columns_expr(n_bits, a_prefix, b_prefix),
                              dst)
