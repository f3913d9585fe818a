"""The port's cross-query CSE pass (`service/optimizer.py` `plan_group_cse`)
and the structural key it rests on (`core/compiler.py` `expr_key`).

The pass hash-conses a batch's expressions once and works on small ints;
`expr_key` builds each node's key once and keeps it on the node. Both are
held here to the pass as it was before, kept below verbatim as the oracle
(it rebuilt every key on every call), over SSB flight 1's bound
predicates and seeded random DAGs with shared sub-trees: the same
`$cse` names in the same order, bodies, uses, plans, bindings and AAP
totals, and the same plans asked for in the same order.
"""
from __future__ import annotations

import dataclasses
import pickle
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pytest
import torch

import repro_torch.service as T
from repro_torch.core import compiler
from repro_torch.core.compiler import Expr, expr_key, expr_size, iter_subexprs
from repro_torch.obs import Telemetry
from repro_torch.service import optimizer
from repro_torch.service.optimizer import (CSE_PREFIX, CseBatch, CseDef,
                                           bind_expr)

ROWS = 2048
#: SSB flight 1 (day codes from 1992-01-01): Q1.1's years, Q1.2's months
#: of 1994, Q1.3's weeks of 1994, each with its discount and quantity
YEARS = [(0, 365), (366, 730), (731, 1095), (1096, 1460), (1461, 1826),
         (1827, 2191), (2192, 2556)]
MONTHS = [(731, 761), (762, 789), (790, 820), (821, 850), (851, 881),
          (882, 911), (912, 942), (943, 973), (974, 1003), (1004, 1034),
          (1035, 1064), (1065, 1095)]
WEEKS = [(731 + 7 * w, 737 + 7 * w) for w in range(52)]
COLUMNS = {"lo_orderdate": 12, "lo_discount": 4, "lo_quantity": 6}
#: a fixed sample of (year, month, week) candidates, one batch each
TRIPLES = [(0, 0, 0), (2, 0, 0), (2, 5, 10), (6, 11, 51), (3, 3, 3),
           (1, 7, 30)]


def _shape_ranges(year: int, month: int, week: int):
    return [{"lo_orderdate": YEARS[year], "lo_discount": (1, 3),
             "lo_quantity": (0, 24)},
            {"lo_orderdate": MONTHS[month], "lo_discount": (4, 6),
             "lo_quantity": (26, 35)},
            {"lo_orderdate": WEEKS[week], "lo_discount": (5, 7),
             "lo_quantity": (26, 35)}]


def _flight1_service(enable_cse: bool = True, telemetry=None):
    svc = T.QueryService(T.ServiceConfig(device="cpu", n_banks=8,
                                         telemetry=telemetry))
    svc.optimizer.enable_cse = enable_cse
    g = torch.Generator().manual_seed(5)
    values = {}
    for name, bits in COLUMNS.items():
        hi = {"lo_orderdate": 2557, "lo_discount": 11, "lo_quantity": 51}
        v = torch.randint(0, hi[name], (ROWS,), generator=g,
                          dtype=torch.int32)
        svc.register_column(name, v, bits)
        values[name] = v.numpy()
    return svc, values


def _range_expr(svc, ranges) -> Expr:
    e = None
    for col, (lo, hi) in ranges.items():
        t = svc.range_scan_query(col, lo, hi)
        e = t if e is None else e & t
    return e


def _fresh_planner(svc) -> T.Planner:
    return T.Planner(cache=T.PlanCache(optimizer=svc.optimizer))


def _flight1_batch(triple):
    """The batch as `Scheduler._apply_cse` hands it to the pass."""
    svc, _ = _flight1_service()
    qs = [T.Query(_range_expr(svc, r)) for r in _shape_ranges(*triple)]
    bound = svc.scheduler.plan_queries(qs)
    exprs = [bind_expr(bp.plan.canon, bp.input_map()) for bp in bound]
    return svc, bound, exprs


def _fresh_copy(e: Expr, memo: Dict[int, Expr]) -> Expr:
    """`e` rebuilt from new nodes, its sharing kept."""
    got = memo.get(id(e))
    if got is None:
        got = Expr(e.op, tuple(_fresh_copy(a, memo) for a in e.args), e.row)
        memo[id(e)] = got
    return got


def _random_batch(seed: int):
    """Queries over a seeded pool of shared sub-DAGs; some rebuilt from
    new nodes of equal structure, and one ineligible (None) query."""
    rng = random.Random(seed)
    pool = [Expr.of(f"r{i}") for i in range(6)]
    for _ in range(14):
        op = rng.choice(["and", "or", "xor", "not", "maj3"])
        arity = {"not": 1, "maj3": 3}.get(op, 2)
        pool.append(Expr(op, tuple(rng.sample(pool, arity))))
    exprs: List[Optional[Expr]] = []
    for _ in range(rng.randint(3, 6)):
        a, b, c = rng.sample(pool[6:], 3)
        e = Expr(rng.choice(["and", "or"]), (Expr("or", (a, b)), c))
        exprs.append(_fresh_copy(e, {}) if rng.random() < 0.3 else e)
    exprs.insert(rng.randrange(len(exprs) + 1), None)
    svc, _ = _flight1_service()
    planner = _fresh_planner(svc)
    bound = [planner._plan(e if e is not None else pool[0], None)
             for e in exprs]
    return svc, bound, exprs


def _run(pass_fn, svc, bound, exprs):
    """One pass with a fresh plan cache: its outcome, and the keys of the
    expressions it planned, in order."""
    planner = _fresh_planner(svc)
    asked: List[Tuple] = []

    def plan_fn(e):
        asked.append(expr_key(e))
        return planner._plan(e, None)

    cse = pass_fn(bound, exprs, plan_fn)
    if cse is None:
        return None, asked
    return ([(d.name, expr_key(d.expr), d.uses, d.bound.plan.key,
              tuple(d.bound.bindings), d.bound.cache_hit)
             for d in cse.defs],
            [(bp.plan.key, tuple(bp.bindings), bp.cache_hit)
             for bp in cse.bound],
            cse.baseline_aaps, cse.optimized_aaps), asked


# ---------------------------------------------------------------------------
# The oracle: the pass as it was before it was made linear, verbatim.
# ---------------------------------------------------------------------------


def _rewrite(e: Expr, picked: Dict[Tuple, str]) -> Expr:
    """Top-down replacement of picked sub-DAGs by their plane leaves.

    Outermost match wins — a picked region nested inside another picked
    region survives only inside the outer region's definition.
    """
    name = picked.get(expr_key(e))
    if name is not None:
        return Expr.of(name)
    if e.op == "row":
        return e
    return Expr(e.op, tuple(_rewrite(a, picked) for a in e.args))


def _cse_leaves(e: Expr, acc: Optional[set] = None) -> set:
    """The `$cse` plane names an expression references."""
    if acc is None:
        acc = set()
    if e.op == "row":
        if e.row.startswith(CSE_PREFIX):
            acc.add(e.row)
    else:
        for a in e.args:
            _cse_leaves(a, acc)
    return acc



def plan_group_cse(bound: Sequence[object],
                   exprs: Sequence[Optional[Expr]],
                   plan_fn: Callable[[Expr], object],
                   ) -> Optional[CseBatch]:
    """Share sub-DAGs appearing in >= 2 of a batch's bound queries.

    `bound` are the batch's original BoundPlans, `exprs` the bound boolean
    DAGs over actual catalog rows (None = ineligible query: arithmetic,
    multi-output), `plan_fn` plans an Expr through the normal pipeline.

    Candidates are counted with per-query set semantics, picked outermost
    -first (largest saving), then iterated to a fixpoint dropping any pick
    that ends up referenced by fewer than two containers. The rewrite is
    abandoned wholesale unless the exact re-costed AAP total (defs once +
    rewritten consumers) is strictly below the unshared baseline — the
    optimizer never emits more AAPs than the current pipeline.
    """
    count: Dict[Tuple, int] = {}
    node_of: Dict[Tuple, Expr] = {}
    n_eligible = 0
    for e in exprs:
        if e is None:
            continue
        n_eligible += 1
        for n in iter_subexprs(e):
            if n.op == "row":
                continue
            k = expr_key(n)
            count[k] = count.get(k, 0) + 1
            node_of.setdefault(k, n)
    if n_eligible < 2:
        return None
    cands = [k for k, c in count.items() if c >= 2]
    if not cands:
        return None
    # outermost-first pick order; names assigned once, deterministically
    cands.sort(key=lambda k: (-expr_size(node_of[k]), repr(k)))
    picked: Dict[Tuple, str] = {k: f"{CSE_PREFIX}{i}"
                                for i, k in enumerate(cands)}

    uses: Dict[str, int] = {}
    rewritten: List[Optional[Expr]] = []
    bodies: Dict[Tuple, Expr] = {}
    while True:
        rewritten = [(_rewrite(e, picked) if e is not None else None)
                     for e in exprs]
        bodies = {}
        for k in picked:
            node = node_of[k]
            bodies[k] = (Expr(node.op,
                              tuple(_rewrite(a, picked) for a in node.args))
                         if node.op != "row" else node)
        uses = {name: 0 for name in picked.values()}
        for e in rewritten:
            if e is None:
                continue
            for name in _cse_leaves(e):
                if name in uses:
                    uses[name] += 1
        for k, body in bodies.items():
            for name in _cse_leaves(body):
                if name in uses:
                    uses[name] += 1
        drop = [k for k, name in picked.items() if uses[name] < 2]
        if not drop:
            break
        for k in drop:
            del picked[k]
        if not picked:
            return None

    # topological order: a def lands after every plane it references
    by_name = {picked[k]: k for k in picked}
    order: List[Tuple] = []
    state: Dict[Tuple, int] = {}

    def visit(k: Tuple):
        if state.get(k) == 2:
            return
        assert state.get(k) != 1, "cyclic $cse dependency"
        state[k] = 1
        for name in sorted(_cse_leaves(bodies[k])):
            if name in by_name:
                visit(by_name[name])
        state[k] = 2
        order.append(k)

    for k in sorted(picked, key=lambda k: picked[k]):
        visit(k)

    defs = [CseDef(name=picked[k], expr=bodies[k],
                   bound=plan_fn(bodies[k]), uses=uses[picked[k]])
            for k in order]
    new_bound: List[object] = []
    for orig, e, r in zip(bound, exprs, rewritten):
        if e is None or r is None or expr_key(r) == expr_key(e):
            new_bound.append(orig)
        else:
            new_bound.append(plan_fn(r))

    baseline = sum(bp.plan.n_aaps for bp in bound)
    optimized = (sum(d.bound.plan.n_aaps for d in defs)
                 + sum(bp.plan.n_aaps for bp in new_bound))
    if optimized >= baseline:
        return None
    return CseBatch(bound=new_bound, defs=defs,
                    baseline_aaps=baseline, optimized_aaps=optimized)



# ---------------------------------------------------------------------------


def _tree_key(e: Expr) -> Tuple:
    """`expr_key` as it was: rebuilt by recursion on every call."""
    if e.op == "row":
        return ("row", e.row)
    return (e.op,) + tuple(_tree_key(a) for a in e.args)


CASES = ([("flight1", i) for i in range(len(TRIPLES))]
         + [("random", seed) for seed in range(8)])


@pytest.mark.parametrize("kind,index", CASES)
def test_cse_pass_matches_the_quadratic_oracle(kind, index):
    if kind == "flight1":
        svc, bound, exprs = _flight1_batch(TRIPLES[index])
    else:
        svc, bound, exprs = _random_batch(index)
    got, got_asked = _run(optimizer.plan_group_cse, svc, bound, exprs)
    want, want_asked = _run(plan_group_cse, svc, bound, exprs)
    assert got == want
    assert got_asked == want_asked
    if kind == "flight1":
        # the flight-1 batches share date planes: the pass has work
        assert got is not None and len(got[0]) > 10


def test_cse_on_and_off_answer_alike():
    on, values = _flight1_service(enable_cse=True)
    off, _ = _flight1_service(enable_cse=False)
    n_planes = 0
    for triple in TRIPLES:
        shapes = _shape_ranges(*triple)
        for mode in (T.POPCOUNT, T.MATERIALIZE):
            reps = [svc.query_batch([T.Query(_range_expr(svc, r), mode)
                                     for r in shapes]) for svc in (on, off)]
            n_planes += reps[0].n_cse_planes
            assert reps[1].n_cse_planes == 0
            for r_on, r_off, ranges in zip(reps[0].results,
                                           reps[1].results, shapes):
                want = np.ones(ROWS, bool)
                for col, (lo, hi) in ranges.items():
                    want &= (values[col] >= lo) & (values[col] <= hi)
                assert r_on.scalar == r_off.scalar == int(want.sum())
                if mode == T.MATERIALIZE:
                    assert np.array_equal(np.asarray(r_on.value),
                                          np.asarray(r_off.value))
    assert n_planes > 0


def test_expr_key_is_built_once_per_node_and_kept():
    a = Expr.of("x") & ~(Expr.of("y") | Expr.of("z"))
    b = Expr.of("x") & ~(Expr.of("y") | Expr.of("z"))
    n0 = compiler.expr_keys_built_total
    ka = expr_key(a)
    assert compiler.expr_keys_built_total - n0 == 6
    assert expr_key(a) is ka and compiler.expr_keys_built_total - n0 == 6
    # built child-first instead: the same value
    expr_key(b.args[1])
    assert expr_key(b) == ka == _tree_key(a) and expr_key(b) is not ka
    assert compiler.expr_keys_built_total - n0 == 12
    # a parent's key holds its children's
    assert ka[2] is expr_key(a.args[1])


def test_cached_key_leaves_expr_equality_hashing_and_copies_alone():
    a = maj = compiler.maj(Expr.of("p"), Expr.of("q") ^ Expr.of("r"),
                           ~Expr.of("p"))
    b = compiler.maj(Expr.of("p"), Expr.of("q") ^ Expr.of("r"),
                     ~Expr.of("p"))
    h, r = hash(a), repr(a)
    expr_key(a)
    assert a == b and hash(a) == hash(b) == h and repr(a) == repr(b) == r
    assert [f.name for f in dataclasses.fields(Expr)] == ["op", "args",
                                                          "row"]
    c = dataclasses.replace(maj, op="and")
    assert c._key is None and expr_key(c) == ("and",) + expr_key(a)[1:]
    for copy in (pickle.loads(pickle.dumps(a)), pickle.loads(pickle.dumps(b))):
        assert copy == a and expr_key(copy) == expr_key(a)
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.op = "or"


def test_expr_keys_built_grow_with_the_nodes_made_not_their_product(
        monkeypatch):
    svc, bound, exprs = _flight1_batch(TRIPLES[2])
    inputs: Dict[int, Expr] = {}

    def walk(e):
        if id(e) not in inputs:
            inputs[id(e)] = e
            for a in e.args:
                walk(a)

    for e in exprs:
        walk(e)
    made = [0]
    real_init = Expr.__init__

    def counting_init(self, *args, **kwargs):
        made[0] += 1
        real_init(self, *args, **kwargs)

    monkeypatch.setattr(Expr, "__init__", counting_init)
    # the pass alone (planning stubbed): a key per node at most, and a
    # bounded number of new nodes per distinct input node
    n0 = compiler.expr_keys_built_total
    cse = optimizer.plan_group_cse(bound, exprs, lambda e: bound[0])
    built = compiler.expr_keys_built_total - n0
    assert cse is None        # the stub's plans never beat the baseline
    assert 0 < built <= len(inputs) + made[0]
    assert made[0] <= 2 * len(inputs)
    # with the defs and consumers planned for real, compiles included
    planner = _fresh_planner(svc)
    made[0] = 0
    n0 = compiler.expr_keys_built_total
    cse = optimizer.plan_group_cse(bound, exprs,
                                   lambda e: planner._plan(e, None))
    built = compiler.expr_keys_built_total - n0
    assert cse is not None and planner.compile_count > 0
    assert 0 < built <= len(inputs) + made[0]


def test_registry_counts_the_pass_and_the_keys_built():
    svc, _ = _flight1_service(telemetry=Telemetry(trace=False))
    shapes = _shape_ranges(*TRIPLES[2])
    qs = [T.Query(_range_expr(svc, r)) for r in shapes]
    bound = svc.scheduler.plan_queries(qs)
    distinct = set()
    for bp in bound:
        e = bind_expr(bp.plan.canon, bp.input_map())
        distinct |= {expr_key(n) for n in iter_subexprs(e) if n.op != "row"}
    n0 = compiler.expr_keys_built_total
    rep = svc.query_batch(qs)
    snap = svc.telemetry.metrics.snapshot()
    assert rep.n_cse_planes > 0
    assert snap["cse_subexprs_total"] == len(distinct)
    keys = snap["expr_keys_built_total"]
    assert keys >= compiler.expr_keys_built_total - n0 > 0
    svc.query_batch(qs)
    snap = svc.telemetry.metrics.snapshot()
    assert snap["cse_subexprs_total"] == 2 * len(distinct)
    assert snap["expr_keys_built_total"] > keys
    # explain() plans a batch but moves no serving counter
    svc.explain(qs)
    assert svc.telemetry.metrics.snapshot()["cse_subexprs_total"] == \
        2 * len(distinct)
