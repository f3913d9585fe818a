"""Port parity: the host compile chain and the lowering pass.

The port's copies of the compiler, the arithmetic compiler, the timing and
energy models and `lower()` must give the JAX package's `Program`
commands, AAP counts, modeled latency / energy and opcode tables exactly,
over random DAGs built the same way in both packages."""
import dataclasses

import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.core import arith_compiler as rar
from repro.core import compiler as rcomp
from repro.core import energy as ren
from repro.core import lowering as rlow
from repro.core import timing as rtim
from repro.ops import predicate as rpred
from repro.service import optimizer as ropt
from repro_torch.core import arith_compiler as tar
from repro_torch.core import compiler as tcomp
from repro_torch.core import energy as ten
from repro_torch.core import lowering as tlow
from repro_torch.core import timing as ttim
from repro_torch.ops import predicate as tpred
from repro_torch.service import optimizer as topt

LEAVES = ("a", "b", "c", "d", "e")


def _rand_expr(rng, E, depth=3):
    """A random boolean DAG over LEAVES (and/or/xor/not/maj3), drawn the
    same way for either package's `Expr` class."""
    if depth <= 0 or rng.random() < 0.25:
        return E.of(str(rng.choice(LEAVES)))
    op = rng.choice(["and", "or", "xor", "not", "maj3"],
                    p=[0.3, 0.3, 0.2, 0.1, 0.1])
    if op == "not":
        return ~_rand_expr(rng, E, depth - 1)
    if op == "maj3":
        return E("maj3", tuple(_rand_expr(rng, E, depth - 1)
                               for _ in range(3)))
    return E(str(op), (_rand_expr(rng, E, depth - 1),
                       _rand_expr(rng, E, depth - 1)))


def _cmds(program):
    return [(type(c).__name__,) + dataclasses.astuple(c)
            for c in program.commands]


def _assert_same_program(r, t):
    assert _cmds(t) == _cmds(r)
    assert t.n_aap == r.n_aap and t.n_ap == r.n_ap
    assert t.comment == r.comment
    # the same Python arithmetic in the same order: exact
    assert ttim.program_latency_ns(t) == rtim.program_latency_ns(r)
    assert ten.program_energy_nj(t) == ren.program_energy_nj(r)
    lr, lt = rlow.lower(r), tlow.lower(t)
    assert lt.row_names == lr.row_names
    assert lt.reads == lr.reads and lt.writes == lr.writes
    assert lt.table.dtype == np.int32
    assert np.array_equal(lt.table, lr.table)


@pytest.mark.parametrize("seed", range(24))
def test_random_dags_compile_and_lower_identically(seed):
    er = _rand_expr(np.random.default_rng(seed), rcomp.Expr, depth=4)
    et = _rand_expr(np.random.default_rng(seed), tcomp.Expr, depth=4)
    assert repr(tcomp.expr_key(et)) == repr(rcomp.expr_key(er))
    _assert_same_program(rcomp.compile_expr_fused(er, "OUT").program,
                         tcomp.compile_expr_fused(et, "OUT").program)
    _assert_same_program(rcomp.compile_expr(er, "OUT").program,
                         tcomp.compile_expr(et, "OUT").program)
    # the optimizer's reordering pass is a copy too
    rr, tr = ropt.reorder_expr(er), topt.reorder_expr(et)
    assert repr(tcomp.expr_key(tr)) == repr(rcomp.expr_key(rr))


@pytest.mark.parametrize("n_bits", [1, 2, 5, 8, 13])
def test_arith_programs_identical(n_bits):
    for sub in (False, True):
        r = rar.ripple_add_program(n_bits, "X", "Y", "S", sub=sub)
        t = tar.ripple_add_program(n_bits, "X", "Y", "S", sub=sub)
        assert t.outputs == r.outputs and t.n_temp_rows == r.n_temp_rows
        _assert_same_program(r.program, t.program)
    r = rar.plane_readout_program(n_bits, "X", "S")
    t = tar.plane_readout_program(n_bits, "X", "S")
    _assert_same_program(r.program, t.program)
    for k in {1, (1 << n_bits) // 3 or 1, (1 << n_bits) - 1}:
        if k >= 1 << n_bits:
            continue
        _assert_same_program(
            rar.compile_lt_const(n_bits, k).program,
            tar.compile_lt_const(n_bits, k).program)
    _assert_same_program(rar.compile_lt_columns(n_bits).program,
                         tar.compile_lt_columns(n_bits).program)


@pytest.mark.parametrize("lo,hi", [(0, 255), (0, 17), (37, 201), (200, 200),
                                   (1, 254)])
def test_range_scan_programs_identical(lo, hi):
    _assert_same_program(rpred.compile_range_scan(8, lo, hi).program,
                         tpred.compile_range_scan(8, lo, hi).program)


def test_cost_model_identical():
    rng = np.random.default_rng(3)
    for _ in range(8):
        er = _rand_expr(rng, rcomp.Expr)
        pr = rcomp.compile_expr_fused(er, "OUT").program
        pt = tcomp.compile_expr_fused(_port_twin(er), "OUT").program
        cr = ropt.cost_program(pr, 3, 1, ropt.CostParams(n_blocks=5))
        ct = topt.cost_program(pt, 3, 1, topt.CostParams(n_blocks=5))
        assert dataclasses.astuple(ct) == dataclasses.astuple(cr)


def _port_twin(e):
    """The port's `Expr` with the same structure as a reference `Expr`."""
    if e.op == "row":
        return tcomp.Expr.of(e.row)
    return tcomp.Expr(e.op, tuple(_port_twin(a) for a in e.args))
