"""Compile bitwise operations/expressions to AAP programs (paper Fig. 8).

Primitive op programs are the paper's exact command sequences. The expression
compiler lowers arbitrary boolean expression DAGs over D-group rows to AAP
sequences through temporary D-rows, with common-subexpression and dead-store
elimination (the "standard compiler techniques" of §5.2).

On top of that sits the **fusion pass** (`compile_expr_fused`): a
SIMDRAM-style minimizer that (a) applies the boolean-algebra shrink rules
(idempotence `a & a -> a`, absorption `a | (a & b) -> a`, double negation)
so degenerate inputs cost one RowClone copy instead of full programs,
(b) rewrites composite sub-DAGs into the cheapest native primitive
(`~(a^b)` -> one XNOR program instead of XOR+NOT, the 3-AND/2-OR majority
form -> one TRA, `a & ~b` -> a fused ANDNOT that rides the dual-contact
negation) and (c) runs a peephole pass over the
emitted command stream that forwards values through dead temporary D-rows so
intermediates stay in the B-group designated rows instead of bouncing
through D-group scratch. Fused programs compute bit-identical results and
are never longer than unfused ones (shorter-of-both by construction), with
strictly fewer AAPs whenever a rewrite or forwarding applies (asserted by
tests/test_compiler.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import addressing
from repro_torch.core.commands import AAP, AP, Command, Program

# ---------------------------------------------------------------------------
# Fig. 8 primitive programs
# ---------------------------------------------------------------------------


def copy_program(src: str, dst: str) -> Program:
    """RowClone-FPM copy expressed as a single AAP (§3.5)."""
    return Program([AAP(src, dst)], f"{dst} = {src}")


def zero_program(dst: str) -> Program:
    return Program([AAP("C0", dst)], f"{dst} = 0")


def one_program(dst: str) -> Program:
    return Program([AAP("C1", dst)], f"{dst} = 1")


def not_program(di: str, dk: str) -> Program:
    # §5.2: ACTIVATE Di; ACTIVATE B5; PRECHARGE; ACTIVATE B4; ACTIVATE Dk; PRE
    return Program(
        [AAP(di, "B5"),   # DCC0 = !Di  (n-wordline captures negation)
         AAP("B4", dk)],  # Dk = DCC0
        f"{dk} = not {di}",
    )


def _and_or(di: str, dj: str, dk: str, ctrl: str, name: str) -> Program:
    return Program(
        [AAP(di, "B0"),     # T0 = Di
         AAP(dj, "B1"),     # T1 = Dj
         AAP(ctrl, "B2"),   # T2 = 0 (and) / 1 (or)
         AAP("B12", dk)],   # TRA(T0,T1,T2) -> Dk
        f"{dk} = {di} {name} {dj}",
    )


def and_program(di: str, dj: str, dk: str) -> Program:
    return _and_or(di, dj, dk, "C0", "and")


def or_program(di: str, dj: str, dk: str) -> Program:
    return _and_or(di, dj, dk, "C1", "or")


def _nand_nor(di: str, dj: str, dk: str, ctrl: str, name: str) -> Program:
    return Program(
        [AAP(di, "B0"),
         AAP(dj, "B1"),
         AAP(ctrl, "B2"),
         AAP("B12", "B5"),  # DCC0 = !(TRA result)
         AAP("B4", dk)],    # Dk = DCC0
        f"{dk} = {di} {name} {dj}",
    )


def nand_program(di: str, dj: str, dk: str) -> Program:
    return _nand_nor(di, dj, dk, "C0", "nand")


def nor_program(di: str, dj: str, dk: str) -> Program:
    return _nand_nor(di, dj, dk, "C1", "nor")


def _xor_xnor(di: str, dj: str, dk: str, c_init: str, c_final: str,
              name: str) -> Program:
    # xor:  T1 = !Di & Dj ; T0 = Di & !Dj ; Dk = T0 | T1
    # xnor: T1 = !Di | Dj ; T0 = Di | !Dj ; Dk = T0 & T1
    # (same skeleton; control rows swapped — paper: "or/nor/xnor can be
    #  implemented by appropriately modifying the control rows")
    return Program(
        [AAP(di, "B8"),        # DCC0 = !Di, T0 = Di
         AAP(dj, "B9"),        # DCC1 = !Dj, T1 = Dj
         AAP(c_init, "B10"),   # T2 = T3 = 0 (xor) / 1 (xnor)
         AP("B14"),            # T1 = TRA(DCC0, T1, T2)
         AP("B15"),            # T0 = TRA(DCC1, T0, T3)
         AAP(c_final, "B2"),   # T2 = 1 (xor) / 0 (xnor)
         AAP("B12", dk)],      # Dk = TRA(T0, T1, T2)
        f"{dk} = {di} {name} {dj}",
    )


def xor_program(di: str, dj: str, dk: str) -> Program:
    return _xor_xnor(di, dj, dk, "C0", "C1", "xor")


def xnor_program(di: str, dj: str, dk: str) -> Program:
    return _xor_xnor(di, dj, dk, "C1", "C0", "xnor")


def maj3_program(da: str, db: str, dc: str, dk: str) -> Program:
    """Native TRA majority — the hardware's actual primitive, exposed.

    Not in the paper's Fig. 8 but free given the same address map; we use it
    for majority-vote gradient aggregation (k=3) and as a paper-plus op.
    """
    return Program(
        [AAP(da, "B0"),
         AAP(db, "B1"),
         AAP(dc, "B2"),
         AAP("B12", dk)],
        f"{dk} = maj({da},{db},{dc})",
    )


def andnot_program(di: str, dj: str, dk: str) -> Program:
    """Dk = Di & !Dj in one program — the bitmap-difference workhorse.

    Not a Fig. 8 entry, but free given the same address map: the DCC
    n-wordline captures !Dj on the way in, so the whole op is 5 AAPs versus
    the 6 (NOT then AND) an unfused compiler emits.
    """
    return Program(
        [AAP(di, "B0"),    # T0 = Di
         AAP(dj, "B5"),    # DCC0 = !Dj
         AAP("B4", "B1"),  # T1 = DCC0 = !Dj
         AAP("C0", "B2"),  # T2 = 0
         AAP("B12", dk)],  # Dk = TRA(Di, !Dj, 0) = Di & !Dj
        f"{dk} = {di} andnot {dj}",
    )


BINARY_PROGRAMS = {
    "and": and_program,
    "or": or_program,
    "nand": nand_program,
    "nor": nor_program,
    "xor": xor_program,
    "xnor": xnor_program,
    "andnot": andnot_program,
}


def op_program(op: str, srcs: Sequence[str], dst: str) -> Program:
    if op == "not":
        (src,) = srcs
        return not_program(src, dst)
    if op == "maj3":
        a, b, c = srcs
        return maj3_program(a, b, c, dst)
    if op == "copy":
        (src,) = srcs
        return copy_program(src, dst)
    if op in BINARY_PROGRAMS:
        a, b = srcs
        return BINARY_PROGRAMS[op](a, b, dst)
    raise ValueError(f"unknown op {op!r}")


# ---------------------------------------------------------------------------
# Expression DAG -> program, with CSE + dead-store elimination
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Expr:
    """Boolean expression node over named D-group rows."""

    op: str                       # 'row' | 'not' | 'and' | ... | 'maj3'
    args: Tuple["Expr", ...] = ()
    row: Optional[str] = None     # for op == 'row'

    #: `expr_key`'s memo, set on first use. Not a field: equality,
    #: hashing, `repr` and `dataclasses.replace` never see it.
    _key = None

    # -- sugar --
    def __and__(self, o): return Expr("and", (self, o))
    def __or__(self, o): return Expr("or", (self, o))
    def __xor__(self, o): return Expr("xor", (self, o))
    def __invert__(self): return Expr("not", (self,))

    @staticmethod
    def of(row: str) -> "Expr":
        return Expr("row", row=row)


def maj(a: Expr, b: Expr, c: Expr) -> Expr:
    return Expr("maj3", (a, b, c))


@dataclasses.dataclass
class CompileResult:
    program: Program
    n_temp_rows: int


#: keys `expr_key` built from scratch (memo misses), across the process
expr_keys_built_total = 0


def expr_key(e: Expr) -> Tuple:
    """Structural identity of an expression node (hash-consing key).

    Built once per node and kept on it: an `Expr` never changes, so its
    key cannot go stale, and a parent's key reuses its children's.
    """
    k = e._key
    if k is None:
        global expr_keys_built_total
        if e.op == "row":
            k = ("row", e.row)
        else:
            k = (e.op,) + tuple(expr_key(a) for a in e.args)
        object.__setattr__(e, "_key", k)
        expr_keys_built_total += 1
    return k


# not(X) folds into X's dual primitive — one program instead of two.
_NOT_DUAL = {"and": "nand", "or": "nor", "xor": "xnor",
             "nand": "and", "nor": "or", "xnor": "xor"}


def _or_leaves(e: Expr) -> List[Expr]:
    if e.op == "or":
        return _or_leaves(e.args[0]) + _or_leaves(e.args[1])
    return [e]


def _match_or_patterns(e: Expr) -> Optional[Expr]:
    """Recognize composite or-trees that collapse to one primitive program.

    (a&b)|(b&c)|(c&a)   -> maj3(a,b,c)      (native TRA, 4 AAPs vs 20)
    andnot(a,b)|andnot(b,a) -> xor(a,b)     (sum-of-products form)
    (a&b)|nor(a,b)      -> xnor(a,b)
    Leaves arrive already fused bottom-up, so the SOP forms appear as
    andnot/nor nodes here.
    """
    leaves = _or_leaves(e)
    if len(leaves) == 3 and all(l.op == "and" for l in leaves):
        by_key: Dict[Tuple, Expr] = {}
        pair_sets = []
        for l in leaves:
            ka, kb = expr_key(l.args[0]), expr_key(l.args[1])
            if ka == kb:
                return None
            by_key[ka], by_key[kb] = l.args[0], l.args[1]
            pair_sets.append(frozenset((ka, kb)))
        keys = sorted(set().union(*pair_sets))
        if len(keys) == 3 and len(set(pair_sets)) == 3:
            x, y, z = (by_key[k] for k in keys)
            return Expr("maj3", (x, y, z))
    if len(leaves) == 2:
        p, q = leaves
        if p.op == q.op == "andnot":
            if (expr_key(p.args[0]) == expr_key(q.args[1])
                    and expr_key(p.args[1]) == expr_key(q.args[0])):
                return Expr("xor", p.args)
        if {p.op, q.op} == {"and", "nor"}:
            a, n = (p, q) if p.op == "and" else (q, p)
            if ({expr_key(a.args[0]), expr_key(a.args[1])}
                    == {expr_key(n.args[0]), expr_key(n.args[1])}):
                return Expr("xnor", a.args)
    return None


def _absorbs(x: Expr, y: Expr, inner: str) -> bool:
    """Does `x op y` collapse to `x` by absorption? `inner` is the dual op.

    Covers the classic law (x | (x & y) = x, x & (x | y) = x) plus the
    post-fusion spelling of the and-form: x | andnot(x, z) = x | (x & ~z)
    = x. Children arrive already fused, so `x & ~z` appears as an andnot
    node here, never as an `and` over a `not`.
    """
    kx = expr_key(x)
    if y.op == inner and kx in (expr_key(y.args[0]), expr_key(y.args[1])):
        return True
    return (inner == "and" and y.op == "andnot"
            and kx == expr_key(y.args[0]))


def _rewrite_node(e: Expr) -> Expr:
    """One rewriting step at a node whose children are already fused."""
    if e.op == "not":
        (a,) = e.args
        if a.op == "not":                        # double negation
            return a.args[0]
        if a.op in _NOT_DUAL:
            return Expr(_NOT_DUAL[a.op], a.args)
    elif e.op == "and":
        x, y = e.args
        if expr_key(x) == expr_key(y):           # idempotence: a & a = a
            return x
        if _absorbs(x, y, "or"):                 # absorption: a & (a | b) = a
            return x
        if _absorbs(y, x, "or"):
            return y
        if x.op == "not" and y.op == "not":      # De Morgan beats 2x NOT
            return Expr("nor", (x.args[0], y.args[0]))
        if y.op == "not":
            return Expr("andnot", (x, y.args[0]))
        if x.op == "not":
            return Expr("andnot", (y, x.args[0]))
    elif e.op == "or":
        x, y = e.args
        if expr_key(x) == expr_key(y):           # idempotence: a | a = a
            return x
        if _absorbs(x, y, "and"):                # absorption: a | (a & b) = a
            return x
        if _absorbs(y, x, "and"):
            return y
        m = _match_or_patterns(e)
        if m is not None:
            return m
        if x.op == "not" and y.op == "not":
            return Expr("nand", (x.args[0], y.args[0]))
    return e


def fuse_expr(expr: Expr) -> Expr:
    """Fusion rewriting: collapse composite sub-DAGs into native primitives.

    Bottom-up, memoized on structural keys so shared subexpressions stay
    shared (CSE in `compile_expr` keys on the same structure). Pure DAG ->
    DAG; semantics preserved (tests assert equality on random inputs).
    """
    memo: Dict[Tuple, Expr] = {}

    def go(e: Expr) -> Expr:
        k = expr_key(e)
        if k in memo:
            return memo[k]
        if e.op != "row":
            e = Expr(e.op, tuple(go(a) for a in e.args))
            while True:
                nxt = _rewrite_node(e)
                if expr_key(nxt) == expr_key(e):
                    break
                e = nxt
        memo[k] = e
        return e

    return go(expr)


def _cmd_addrs(c: Command) -> Tuple[str, ...]:
    return (c.addr1, c.addr2) if isinstance(c, AAP) else (c.addr,)


def _addr_rows(addr: str) -> frozenset:
    return frozenset(r for r, _ in addressing.resolve(addr))


def _cmd_reads(c: Command) -> frozenset:
    # rows whose stored value feeds the sense amps (first ACTIVATE)
    return _addr_rows(c.addr1 if isinstance(c, AAP) else c.addr)


def _cmd_writes(c: Command) -> frozenset:
    # every raised wordline is overwritten with the (polarity-adjusted)
    # sensed value — the first ACTIVATE restores, the second forces
    if isinstance(c, AAP):
        return _addr_rows(c.addr1) | _addr_rows(c.addr2)
    return _addr_rows(c.addr)


def optimize_program(program: Program, temp_prefix: str = "TMP") -> Program:
    """Peephole pass: forward values through dead temporary D-rows.

    AAP(x, t) ... AAP(t, y) with t a temp row used nowhere else becomes
    AAP(x, y) — the sensed value lands in its consumer directly and the
    D-group round-trip (one full AAP, ~49ns) disappears. Safe iff no command
    in between reads or writes any wordline-row of y: the first ACTIVATE
    restores x's rows identically in both versions, t is dead by
    construction, and y's rows were untouched on the gap. Iterates to
    fixpoint so chains of temps collapse.
    """
    cmds: List[Command] = list(program.commands)
    changed = True
    while changed:
        changed = False
        occ: Dict[str, List[int]] = {}
        for idx, c in enumerate(cmds):
            for a in _cmd_addrs(c):
                if a.startswith(temp_prefix):
                    occ.setdefault(a, []).append(idx)
        for t, idxs in occ.items():
            if len(idxs) != 2:
                continue
            i, j = idxs
            ci, cj = cmds[i], cmds[j]
            if not (isinstance(ci, AAP) and isinstance(cj, AAP)):
                continue
            if ci.addr2 != t or cj.addr1 != t:
                continue
            y_rows = _addr_rows(cj.addr2)
            if any(y_rows & (_cmd_reads(c) | _cmd_writes(c))
                   for c in cmds[i + 1:j]):
                continue
            cmds[i] = AAP(ci.addr1, cj.addr2)
            del cmds[j]
            changed = True
            break
    return Program(cmds, program.comment)


def compile_expr(expr: Expr, dst: str, temp_prefix: str = "TMP",
                 fuse: bool = False) -> CompileResult:
    """Lower an expression DAG to an AAP program.

    Strategy: post-order walk with hash-consing (CSE). Each interior node is
    materialized into a temporary D-row via its Fig. 8 primitive program; the
    root is materialized directly into `dst` (dead-store elimination — no
    final copy). Temp rows are reference-counted and recycled so the peak
    temp-row footprint is reported (these consume D-group capacity).

    With `fuse=True` the DAG first goes through `fuse_expr` and the emitted
    command stream through `optimize_program` (see `compile_expr_fused`).
    Both the rewritten and the original DAG are compiled and the shorter
    program wins: a rewrite that breaks CSE sharing (e.g. a subexpression
    consumed both plain and negated) can otherwise pessimize, so the
    fused result is never longer than the unfused one by construction.
    """
    if fuse:
        fused_c = _compile_one(fuse_expr(expr), dst, temp_prefix, True)
        plain_c = _compile_one(expr, dst, temp_prefix, True)
        return fused_c if len(fused_c.program.commands) <= \
            len(plain_c.program.commands) else plain_c
    return _compile_one(expr, dst, temp_prefix, False)


def _compile_one(expr: Expr, dst: str, temp_prefix: str,
                 peephole: bool) -> CompileResult:
    commands: List[Command] = []
    memo: Dict[Tuple, str] = {}
    free_temps: List[str] = []
    n_temps = 0
    refcounts: Dict[Tuple, int] = {}

    key = expr_key

    def count(e: Expr):
        k = key(e)
        refcounts[k] = refcounts.get(k, 0) + 1
        if refcounts[k] == 1 and e.op != "row":
            for a in e.args:
                count(a)

    count(expr)

    def alloc_temp() -> str:
        nonlocal n_temps
        if free_temps:
            return free_temps.pop()
        name = f"{temp_prefix}{n_temps}"
        n_temps += 1
        return name

    def release(row: str):
        if row.startswith(temp_prefix):
            free_temps.append(row)

    def emit(e: Expr, out: Optional[str]) -> str:
        k = key(e)
        if e.op == "row":
            if out is not None and out != e.row:
                commands.extend(copy_program(e.row, out).commands)
                return out
            return e.row
        if k in memo and out is None:
            return memo[k]
        src_rows = [emit(a, None) for a in e.args]
        # rows that die after this op can host the result in-place: every
        # Fig. 8 program stages its sources into designated rows before the
        # final AAP writes the destination, so dst == src is safe.
        dying = [r for a, r in zip(e.args, src_rows)
                 if refcounts[key(a)] == 1 and r.startswith(temp_prefix)]
        if out is not None:
            dst_row = out
        elif dying:
            dst_row = dying[0]
        else:
            dst_row = alloc_temp()
        commands.extend(op_program(e.op, src_rows, dst_row).commands)
        for a, r in zip(e.args, src_rows):
            refcounts[key(a)] -= 1
            if refcounts[key(a)] == 0 and r != dst_row:
                release(r)
        if out is None:
            memo[k] = dst_row
        return dst_row

    emit(expr, dst)
    prog = Program(commands, f"{dst} = <expr>")
    if peephole:
        prog = optimize_program(prog, temp_prefix)
        n_temps = len({a for c in prog.commands for a in _cmd_addrs(c)
                       if a.startswith(temp_prefix)})
    return CompileResult(prog, n_temps)


def compile_expr_fused(expr: Expr, dst: str,
                       temp_prefix: str = "TMP") -> CompileResult:
    """Fusing compiler: `compile_expr` plus DAG rewriting + peephole.

    Never emits more commands than the unfused path (shorter-of-both by
    construction) and strictly fewer whenever a rewrite or dead-temp
    forwarding applies (e.g. `~(a^b)`: 9 -> 7, the 5-op majority form:
    20 -> 4), computing bit-identical results throughout.
    """
    return compile_expr(expr, dst, temp_prefix, fuse=True)


# ---------------------------------------------------------------------------
# Reordering / CSE hooks: DAG surgery primitives the cost-based optimizer
# (`service.optimizer`) builds on. Pure structural helpers — no costs here.
# ---------------------------------------------------------------------------

#: the associative-commutative ops whose operand chains may be reordered
#: without changing the computed value
CHAIN_OPS = ("and", "or", "xor")


def flatten_chain(e: Expr, op: str) -> List[Expr]:
    """Operands of the maximal `op`-chain rooted at `e`, left to right.

    `(a | b) | (c | d)` flattens to `[a, b, c, d]` for op="or"; a node of
    a different op is its own single-element chain. Only valid for the
    associative `CHAIN_OPS`.
    """
    if e.op != op:
        return [e]
    out: List[Expr] = []
    for a in e.args:
        out.extend(flatten_chain(a, op))
    return out


def rebuild_chain(op: str, operands: Sequence[Expr]) -> Expr:
    """Left-deep `op`-tree over `operands` (inverse of `flatten_chain`)."""
    if not operands:
        raise ValueError(f"cannot rebuild an empty {op!r} chain")
    e = operands[0]
    for o in operands[1:]:
        e = Expr(op, (e, o))
    return e


def iter_subexprs(e: Expr) -> List[Expr]:
    """Every distinct sub-DAG of `e` (post-order, deduplicated by key).

    The enumeration the cross-query CSE pass counts over: each structurally
    distinct node appears exactly once even when the DAG shares it.
    """
    seen: Dict[Tuple, None] = {}
    out: List[Expr] = []

    def go(n: Expr):
        k = expr_key(n)
        if k in seen:
            return
        seen[k] = None
        for a in n.args:
            go(a)
        out.append(n)

    go(e)
    return out


def expr_size(e: Expr) -> int:
    """Number of distinct interior (non-leaf) nodes in the DAG."""
    return sum(1 for n in iter_subexprs(e) if n.op != "row")
