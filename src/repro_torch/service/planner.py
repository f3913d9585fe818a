"""Query planner: parse -> canonicalize -> optimize -> cost -> bind.

The planner turns a query string over catalog names (`"(mon | tue) & male"`)
into a `core.compiler.Expr` DAG, *canonicalizes* the leaf names to
positional inputs `IN0..INk`, and runs the canonical DAG through the
cost-based optimizer (`service.optimizer`): the plan cache compiles both
the original and the cost-reordered candidate with `compile_expr_fused`
and keeps whichever needs fewer AAPs — so the optimized pipeline can never
emit more AAPs than the unoptimized one. Plans are memoized in a bounded
LRU `PlanCache` keyed by the structural `expr_key` of the *winning*
canonical DAG (a route table maps as-written keys to it), so

  * the same query twice compiles once (hit counter-verified by tests),
  * structurally identical queries over *different* catalog vectors share
    one plan — e.g. every tenant's 7-way weekly OR-tree is one cached
    program, which is also what lets the scheduler batch them into one
    bank-group dispatch (the controller broadcasts a single AAP sequence;
    each bank holds a different tenant's rows), and
  * operand-order variants (`c & (a|b)` vs `(b|a) & c`) converge on one
    reordered shape and share that single compiled plan.

A `Plan` carries the compiled program plus its derived costs: AAP count,
per-row-block modeled latency (`core.timing`) and energy (`core.energy`),
the full `PlanCost` breakdown, and the backend the optimizer chose for
dispatch (`cuda` / `interp` / `torch`).

Beyond boolean queries, the grammar covers the bit-serial arithmetic layer
(`core.arith_compiler`) over registered integer columns:

  * `col < 17` / `colA < colB` — comparison predicates, expanded into
    boolean DAGs over the columns' bit planes (usable anywhere a bitvector
    name is: `age < 30 & male`);
  * `colA + colB` / `colA - colB` — element-wise wrap-around add/sub,
    compiled to the maj3+xor ripple microprogram with multi-plane outputs;
  * `sum(col)` / `sum(colA + colB)` / `sum(colA - colB)` — SUM aggregation
    (the scheduler's `aggregate` result mode).

Expanding these needs the column-name -> bit-width map, which the catalog
owns (`Catalog.columns`); pass it as `columns=`. Arithmetic plans ride the
same `PlanCache`, keyed on (op, width), so every tenant's `sum(col)` over
an 8-bit column is ONE cached microprogram.
"""
from __future__ import annotations

import dataclasses
import re
from collections import OrderedDict
from typing import (Container, Dict, List, Mapping, Optional, Tuple,
                    Union)

from repro_torch.core import arith_compiler
from repro_torch.core import energy as energy_model
from repro_torch.core import lowering
from repro_torch.core import timing as timing_model
from repro_torch.core.commands import Program
from repro_torch.core.compiler import (CompileResult, Expr, compile_expr_fused,
                                 expr_key)
from repro_torch.service.catalog import plane_name
from repro_torch.service.optimizer import PlanCost, QueryOptimizer

DST = "OUT"
_IN_PREFIX = "IN"


class QueryParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Parser: `<` > `~` > `&` > `^` > `|`, parens, maj(a,b,c); names may contain
# word chars plus . / : - (tenant-scoped names like "t3/wed"). Integer
# literals appear only as the right-hand side of `<`.
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"\s*([A-Za-z_][\w./:-]*|\d+|[()&|^~,<])")


def _tokenize(text: str) -> List[str]:
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip():
                raise QueryParseError(
                    f"bad character {text[pos:].strip()[0]!r} in query "
                    f"{text!r}")
            break
        tokens.append(m.group(1))
        pos = m.end()
    return tokens


def _expand_lt(lhs: Expr, rhs: str, columns: Optional[Mapping[str, int]],
               text: str) -> Expr:
    """Expand `col < K` / `colA < colB` into a plane-level boolean DAG."""
    if lhs.op != "row":
        raise QueryParseError(
            f"left side of '<' must be a column name in {text!r}")
    if not columns or lhs.row not in columns:
        raise QueryParseError(
            f"{lhs.row!r} is not a registered integer column in {text!r}")
    n_bits = columns[lhs.row]
    if rhs.isdigit():
        k = int(rhs)
        if k <= 0 or k >= (1 << n_bits):
            raise QueryParseError(
                f"{lhs.row} < {k} is constant for a {n_bits}-bit column "
                f"in {text!r}")
        e = arith_compiler.lt_const_expr(n_bits, k, prefix=f"{lhs.row}.b")
        assert e is not None
        return e
    if rhs not in columns:
        raise QueryParseError(
            f"{rhs!r} is not a registered integer column in {text!r}")
    if columns[rhs] != n_bits:
        raise QueryParseError(
            f"width mismatch in {text!r}: {lhs.row} is {n_bits}-bit, "
            f"{rhs} is {columns[rhs]}-bit")
    return arith_compiler.lt_columns_expr(n_bits, f"{lhs.row}.b",
                                          f"{rhs}.b")


def parse_query(text: str,
                columns: Optional[Mapping[str, int]] = None) -> Expr:
    """Parse a query string over catalog names into an Expr DAG.

    `columns` (column name -> bit width, `Catalog.columns`) enables the
    comparison forms `col < K` and `colA < colB`, which expand to boolean
    DAGs over the columns' bit planes.
    """
    tokens = _tokenize(text)
    idx = 0

    def peek() -> Optional[str]:
        return tokens[idx] if idx < len(tokens) else None

    def take(expected: Optional[str] = None) -> str:
        nonlocal idx
        if idx >= len(tokens):
            raise QueryParseError(f"unexpected end of query {text!r}")
        tok = tokens[idx]
        if expected is not None and tok != expected:
            raise QueryParseError(
                f"expected {expected!r} but got {tok!r} in {text!r}")
        idx += 1
        return tok

    def atom() -> Expr:
        tok = take()
        if tok == "(":
            e = or_level()
            take(")")
            return e
        if tok == "~":
            return ~atom()
        if tok == "maj" and peek() == "(":
            take("(")
            a = or_level()
            take(",")
            b = or_level()
            take(",")
            c = or_level()
            take(")")
            return Expr("maj3", (a, b, c))
        if re.match(r"^[A-Za-z_]", tok):
            return Expr.of(tok)
        raise QueryParseError(f"unexpected token {tok!r} in {text!r}")

    def cmp_atom() -> Expr:
        e = atom()
        if peek() == "<":
            take()
            return _expand_lt(e, take(), columns, text)
        return e

    def and_level() -> Expr:
        e = cmp_atom()
        while peek() == "&":
            take()
            e = e & cmp_atom()
        return e

    def xor_level() -> Expr:
        e = and_level()
        while peek() == "^":
            take()
            e = e ^ and_level()
        return e

    def or_level() -> Expr:
        e = xor_level()
        while peek() == "|":
            take()
            e = e | xor_level()
        return e

    e = or_level()
    if idx != len(tokens):
        raise QueryParseError(f"trailing tokens {tokens[idx:]} in {text!r}")
    return e


# ---------------------------------------------------------------------------
# Arithmetic query forms: sum(col), col + col, col - col
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArithQuery:
    """A parsed arithmetic query over registered integer columns.

    op: 'read' (a bare column inside sum()), 'add', or 'sub'.
    cols: the 1 or 2 column names involved.
    aggregate: True for sum(...) — the result is the scalar
        sum_j 2**j * popcount(result plane j); False for a bare
        `a + b`, whose materialized value is the result plane stack.
    """

    op: str
    cols: Tuple[str, ...]
    aggregate: bool


_NAME = r"[A-Za-z_][\w./:-]*"
# `-` is a legal name character ("weekly-total" is ONE catalog name). A
# whitespace-preceded `-` always subtracts (`a - b`); a tight `a-b`
# tokenizes as one hyphenated name and is disambiguated by longest-match
# against the catalog (`_hyphen_sub`): a fully registered name stays a
# boolean leaf, otherwise a split whose sides are both registered integer
# columns reads as subtraction. `+` is never a name char.
_OP = r"(?P<op>\+|(?<=\s)-)"
_SUM_RE = re.compile(
    rf"^\s*sum\s*\(\s*(?P<a>{_NAME})\s*(?:{_OP}\s*(?P<b>{_NAME})\s*)?\)\s*$")
_ADDSUB_RE = re.compile(
    rf"^\s*(?P<a>{_NAME})\s*{_OP}\s*(?P<b>{_NAME})\s*$")
_BARE_NAME_RE = re.compile(rf"^{_NAME}$")


def _hyphen_sub(name: str, columns: Optional[Mapping[str, int]],
                names: Optional[Container[str]]) -> Optional[ArithQuery]:
    """Longest-match disambiguation of a tight hyphenated name.

    A fully registered bitvector (`names`, usually the catalog) or column
    name always wins — `weekly-total` stays ONE leaf even if `weekly` and
    `total` happen to be columns. Otherwise try each `-` split point,
    longest left operand first, and read `colA-colB` as subtraction when
    both sides are registered integer columns.
    """
    if names is not None and name in names:
        return None
    if not columns or name in columns or "-" not in name:
        return None
    cuts = [i for i, ch in enumerate(name) if ch == "-"]
    for i in reversed(cuts):
        a, b = name[:i], name[i + 1:]
        if a in columns and b in columns:
            if columns[a] != columns[b]:
                raise QueryParseError(
                    f"width mismatch in {name!r}: {columns[a]} vs "
                    f"{columns[b]}")
            return ArithQuery("sub", (a, b), False)
    return None


def parse_any(text: str, columns: Optional[Mapping[str, int]] = None,
              names: Optional[Container[str]] = None
              ) -> Union[Expr, ArithQuery]:
    """Parse either a boolean query or an arithmetic form.

    `sum(...)` is always arithmetic. A bare `a + b` / `a - b` is
    arithmetic only when both names are registered columns — names may
    legally contain `-`, so `weekly-total` (one hyphenated catalog name,
    checked against `names`) stays a boolean leaf; a tight `colA-colB`
    that is NOT itself registered but splits into two registered columns
    reads as subtraction (`_hyphen_sub` longest-match).
    """
    m = _SUM_RE.match(text)
    if m:
        a, op, b = m.group("a"), m.group("op"), m.group("b")
        cols = columns or {}
        if op is not None:
            if a not in cols or b not in cols:
                raise QueryParseError(
                    f"sum() needs registered integer columns in {text!r}")
            if cols[a] != cols[b]:
                raise QueryParseError(
                    f"width mismatch in {text!r}: {cols[a]} vs {cols[b]}")
            return ArithQuery("add" if op == "+" else "sub", (a, b), True)
        if a in cols:
            return ArithQuery("read", (a,), True)
        hy = _hyphen_sub(a, cols, names)
        if hy is not None:
            return ArithQuery(hy.op, hy.cols, True)
        raise QueryParseError(
            f"sum() needs registered integer columns in {text!r}")
    m = _ADDSUB_RE.match(text)
    if m and columns:
        a, op, b = m.group("a"), m.group("op"), m.group("b")
        if a in columns and b in columns:
            if columns[a] != columns[b]:
                raise QueryParseError(
                    f"width mismatch in {text!r}: {columns[a]} vs "
                    f"{columns[b]}")
            return ArithQuery("add" if op == "+" else "sub", (a, b), False)
    bare = text.strip()
    if "-" in bare and _BARE_NAME_RE.match(bare):
        hy = _hyphen_sub(bare, columns, names)
        if hy is not None:
            return hy
    return parse_query(text, columns)


# ---------------------------------------------------------------------------
# Canonicalization: leaf rows -> IN0..INk in first-visit order
# ---------------------------------------------------------------------------


def canonicalize(expr: Expr) -> Tuple[Expr, List[str]]:
    """Rename leaves to positional IN-names; returns (canonical, bindings).

    `bindings[i]` is the catalog row that canonical input `IN{i}` stands
    for. Repeated leaves map to the same input, so structure is preserved
    and the compiler's CSE still sees shared subexpressions. A node the
    DAG shares is renamed once, so the canonical DAG shares it too.
    """
    order: Dict[str, int] = {}
    done: Dict[int, Expr] = {}      # id(node) -> its canonical node

    def go(e: Expr) -> Expr:
        got = done.get(id(e))
        if got is None:
            if e.op == "row":
                if e.row not in order:
                    order[e.row] = len(order)
                got = Expr.of(f"{_IN_PREFIX}{order[e.row]}")
            else:
                got = Expr(e.op, tuple(go(a) for a in e.args))
            done[id(e)] = got
        return got

    canon = go(expr)
    return canon, list(order)


def _canon_leaves(e: Expr, acc: Optional[set] = None) -> set:
    """Distinct leaf row names of a (canonical) expression DAG."""
    if acc is None:
        acc = set()
    if e.op == "row":
        acc.add(e.row)
    else:
        for a in e.args:
            _canon_leaves(a, acc)
    return acc


@dataclasses.dataclass(frozen=True)
class Plan:
    """A compiled, costed query plan over canonical inputs IN0..INk.

    Boolean plans write the single row DST; arithmetic plans write one row
    per result bit plane (`outputs`, LSB-first). Whether a query's served
    value is the plane stack or the weighted popcount scalar is the
    scheduler's per-query result mode, not a plan property — `sum(a + b)`
    and a bare `a + b` share one cached plan.

    `lowered` is the plan's register-machine form (`core.lowering`): row
    names resolved to plane indices plus the static opcode table. Caching
    it here means the scheduler dispatches a plan-group straight into the
    VM with zero per-batch lowering work.

    The optimizer records its decisions here: `backend` is the per-plan
    dispatch choice ("cuda"/"interp"/"torch"; None = scheduler default),
    `cost` the full `PlanCost` breakdown, `n_aaps_unopt` what the
    unoptimized pipeline would have spent (always >= `n_aaps` — the
    original candidate competes in every compile-off), and `canon` the
    winning canonical DAG (what the scheduler's cross-query CSE pass
    rebinds; None for arithmetic plans, which it never rewrites).
    """

    key: Tuple                      # expr_key of the canonical DAG
    program: Program                # writes `outputs`, reads IN0..INk
    n_inputs: int
    n_temp_rows: int
    latency_ns_per_block: float     # one 8KB-row-block execution
    energy_nj_per_block: float
    outputs: Tuple[str, ...] = (DST,)
    lowered: Optional[lowering.LoweredProgram] = None
    backend: Optional[str] = None
    cost: Optional[PlanCost] = None
    n_aaps_unopt: Optional[int] = None
    canon: Optional[Expr] = None

    @property
    def n_aaps(self) -> int:
        return self.program.n_aap


@dataclasses.dataclass
class PlanCache:
    """Bounded LRU expr_key -> Plan memo, with the optimize/cost stages.

    Two tables: `_plans` maps the *winning* canonical key to its compiled
    `Plan` (bounded at `capacity`, LRU-evicted, `evictions`-counted), and
    `_route` maps as-written canonical keys to (winner key, binding
    permutation) so operand-order variants land on one shared plan without
    recompiling. On a route miss the cache reorders the DAG through the
    attached `QueryOptimizer`, compiles BOTH candidates, and keeps the one
    with fewer AAPs — `compiles` counts these compile events (a structural
    hit on the reordered key is a miss that compiles nothing).

    The legacy integer counters (`hits`/`misses`) are always maintained;
    when a `repro_torch.obs.MetricsRegistry` is attached (`attach_metrics`, wired
    by the scheduler from `QueryService(telemetry=...)`) every hit/miss/
    eviction also lands on the registry's `plan_cache_{hits,misses,
    evictions}_total` counters — the single stat surface
    `QueryService.stats()` reads.
    """

    timing: timing_model.DramTiming = timing_model.DDR3_1600
    energy: energy_model.EnergyModel = energy_model.DEFAULT_ENERGY
    optimizer: Optional[QueryOptimizer] = None
    capacity: Optional[int] = 1024

    def __post_init__(self):
        self._plans: "OrderedDict[Tuple, Plan]" = OrderedDict()
        # as-written key -> (winner key, perm); new_bindings[i] =
        # old_bindings[perm[i]]. Bounded at 4x capacity; stale entries
        # (winner evicted) are dropped lazily on lookup.
        self._route: "OrderedDict[Tuple, Tuple[Tuple, Tuple[int, ...]]]" \
            = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.evictions = 0
        from repro_torch.obs.metrics import _NULL_INSTRUMENT

        self._m_hits = _NULL_INSTRUMENT
        self._m_misses = _NULL_INSTRUMENT
        self._m_evictions = _NULL_INSTRUMENT

    def attach_metrics(self, registry) -> None:
        """Mirror hit/miss/eviction counts onto `registry` from now on."""
        self._m_hits = registry.counter("plan_cache_hits_total")
        self._m_misses = registry.counter("plan_cache_misses_total")
        self._m_evictions = registry.counter("plan_cache_evictions_total")

    def __len__(self) -> int:
        return len(self._plans)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def _insert(self, key: Tuple, plan: Plan) -> None:
        self._plans[key] = plan
        self._plans.move_to_end(key)
        if self.capacity is not None:
            while len(self._plans) > self.capacity:
                self._plans.popitem(last=False)
                self.evictions += 1
                self._m_evictions.inc()

    def _set_route(self, key0: Tuple, wkey: Tuple,
                   perm: Tuple[int, ...]) -> None:
        self._route[key0] = (wkey, perm)
        self._route.move_to_end(key0)
        if self.capacity is not None:
            while len(self._route) > 4 * self.capacity:
                self._route.popitem(last=False)

    def _finish(self, canon: Expr, res: CompileResult, key: Tuple,
                n_aaps_unopt: int) -> Plan:
        # n_inputs counts the *bound* canonical leaves, not the rows the
        # compiled program happens to activate: algebraic simplification can
        # eliminate a leaf entirely (`IN0 | (IN0 & IN1)` compiles to a copy
        # of IN0), and scanning the command stream for the IN prefix would
        # then disagree with the planner's bindings and break the
        # scheduler's input placement. The canonical DAG always carries
        # every leaf, so its leaf count == len(bindings) by construction
        # (asserted in BoundPlan).
        n_inputs = len(_canon_leaves(canon))
        program = res.program
        opt = self.optimizer
        plan = Plan(
            key=key,
            program=program,
            n_inputs=n_inputs,
            n_temp_rows=res.n_temp_rows,
            latency_ns_per_block=timing_model.program_latency_ns(
                program, self.timing),
            energy_nj_per_block=energy_model.program_energy_nj(
                program, self.energy),
            lowered=lowering.lower(program),
            backend=opt.backend(program) if opt is not None else None,
            cost=(opt.cost(program, n_inputs, 1)
                  if opt is not None else None),
            n_aaps_unopt=n_aaps_unopt,
            canon=canon,
        )
        self._insert(key, plan)
        return plan

    def lookup(self, canon: Expr) -> Tuple[Plan, bool, Tuple[int, ...]]:
        """Return (plan, was_hit, perm); optimizes + compiles on miss.

        `perm` maps the caller's first-visit bindings onto the winning
        plan's canonical inputs: bind IN{i} to `bindings[perm[i]]`. The
        reordered candidate can also *drop* leaves (XOR parity, chain
        idempotence), in which case len(perm) < len(bindings).
        """
        key0 = expr_key(canon)
        route = self._route.get(key0)
        if route is not None:
            wkey, perm = route
            plan = self._plans.get(wkey)
            if plan is not None:
                self._plans.move_to_end(wkey)
                self._route.move_to_end(key0)
                self.hits += 1
                self._m_hits.inc()
                return plan, True, perm
            del self._route[key0]       # stale: winner was evicted
        self.misses += 1
        self._m_misses.inc()
        ident = tuple(range(len(_canon_leaves(canon))))
        canon2, perm = canon, ident
        opt = self.optimizer
        if opt is not None:
            re2 = opt.reorder(canon)
            if expr_key(re2) != key0:
                canon2, names2 = canonicalize(re2)
                perm = tuple(int(n[len(_IN_PREFIX):]) for n in names2)
        key2 = expr_key(canon2)
        if key2 != key0:
            plan = self._plans.get(key2)
            if plan is not None:
                # structural hit: the reordered shape is already compiled
                # (an operand-order variant got here first) — a miss that
                # costs no compile.
                self._plans.move_to_end(key2)
                self._set_route(key0, key2, perm)
                return plan, False, perm
        # Compile-off: the as-written candidate always competes, so the
        # optimized pipeline can never emit more AAPs than the plain one.
        self.compiles += 1
        res1: CompileResult = compile_expr_fused(canon, DST)
        wkey, wcanon, wres, wperm = key0, canon, res1, ident
        if key2 != key0:
            res2 = compile_expr_fused(canon2, DST)
            if res2.program.n_aap <= res1.program.n_aap:
                # ties go to the reordered shape: it is the convergent key
                # that operand-order variants of this query also reach
                wkey, wcanon, wres, wperm = key2, canon2, res2, perm
        plan = self._finish(wcanon, wres, wkey,
                            n_aaps_unopt=res1.program.n_aap)
        self._set_route(key0, wkey, wperm)
        return plan, False, wperm

    def lookup_arith(self, op: str, n_bits: int) -> Tuple[Plan, bool]:
        """Memoized arithmetic microprogram plan, keyed on (op, width).

        The canonical shape binds the first operand's planes to
        IN0..IN{n-1} and (for add/sub) the second's to IN{n}..IN{2n-1};
        outputs are OUT0..OUT{n-1} LSB-first. Every tenant's `sum(col)`
        over an equal-width column — and sum-wrapped vs bare forms of the
        same op — hit the same entry.
        """
        key = ("arith", op, n_bits)
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            self.hits += 1
            self._m_hits.inc()
            return plan, True
        self.misses += 1
        self._m_misses.inc()
        self.compiles += 1
        if op == "read":
            res = arith_compiler.plane_readout_program(
                n_bits, _IN_PREFIX, DST)
            program = res.program
            n_inputs = n_bits
        elif op in ("add", "sub"):
            res = arith_compiler.ripple_add_program(
                n_bits, "XA", "XB", DST, sub=(op == "sub"))
            rename = {f"XA{j}": f"{_IN_PREFIX}{j}" for j in range(n_bits)}
            rename.update({f"XB{j}": f"{_IN_PREFIX}{n_bits + j}"
                           for j in range(n_bits)})
            program = arith_compiler.rename_rows(res.program, rename)
            n_inputs = 2 * n_bits
        else:
            raise ValueError(f"unknown arithmetic op {op!r}")
        opt = self.optimizer
        plan = Plan(
            key=key,
            program=program,
            n_inputs=n_inputs,
            n_temp_rows=res.n_temp_rows,
            latency_ns_per_block=timing_model.program_latency_ns(
                program, self.timing),
            energy_nj_per_block=energy_model.program_energy_nj(
                program, self.energy),
            outputs=tuple(res.outputs),
            lowered=lowering.lower(program),
            backend=opt.backend(program) if opt is not None else None,
            cost=(opt.cost(program, n_inputs, len(res.outputs))
                  if opt is not None else None),
            n_aaps_unopt=program.n_aap,
        )
        self._insert(key, plan)
        return plan, False


@dataclasses.dataclass
class BoundPlan:
    """A cached plan bound to one query's actual catalog rows."""

    plan: Plan
    bindings: List[str]             # bindings[i] backs IN{i}
    cache_hit: bool

    def __post_init__(self):
        # Eliminated leaves stay bound (the scheduler still places their
        # rows), so the plan's input arity and the bindings must agree.
        assert self.plan.n_inputs == len(self.bindings), (
            f"plan expects {self.plan.n_inputs} inputs but query bound "
            f"{len(self.bindings)} rows")

    def input_map(self) -> Dict[str, str]:
        return {f"{_IN_PREFIX}{i}": row
                for i, row in enumerate(self.bindings)}


@dataclasses.dataclass
class Planner:
    """Parse + canonicalize + compile-with-memo front half of the service.

    `telemetry` (a `repro_torch.obs.Telemetry`, wired by the scheduler) makes
    `plan` emit the parse -> plan_cache -> bind span chain of each query's
    trace; the default `NULL_TELEMETRY` path does no tracing work.
    """

    cache: PlanCache = dataclasses.field(default_factory=PlanCache)
    telemetry: object = None

    def __post_init__(self):
        if self.telemetry is None:
            from repro_torch.obs.telemetry import NULL_TELEMETRY

            self.telemetry = NULL_TELEMETRY

    @property
    def compile_count(self) -> int:
        """Compile events actually performed (<= cache misses: a miss
        that structurally hits the reordered key compiles nothing)."""
        return self.cache.compiles

    def plan(self, query: Union[str, Expr, ArithQuery],
             columns: Optional[Mapping[str, int]] = None,
             names: Optional[Container[str]] = None) -> BoundPlan:
        tel = self.telemetry
        if not tel.spans_on():
            return self._plan(query, columns, names)
        with tel.span("plan"):
            return self._plan(query, columns, names, tel)

    def _plan(self, query: Union[str, Expr, ArithQuery],
              columns: Optional[Mapping[str, int]],
              names: Optional[Container[str]] = None,
              tel=None) -> BoundPlan:
        """Parse, look up or compile, and bind; with ``tel`` (spans on)
        each stage is a span, and when tracing the cache's answer an
        instant event."""
        if tel is not None:
            tel.begin("parse")
        if isinstance(query, str):
            parsed: Union[Expr, ArithQuery] = parse_any(query, columns,
                                                        names)
        else:
            parsed = query
        if tel is not None:
            tel.end()
            tel.begin("plan_cache")
        if isinstance(parsed, ArithQuery):
            bp = self._plan_arith(parsed, columns or {})
            if tel is not None:
                tel.end()
                if tel.tracing:
                    tel.tracer.instant("cache_hit" if bp.cache_hit
                                       else "cache_miss")
            return bp
        canon, bindings = canonicalize(parsed)
        plan, hit, perm = self.cache.lookup(canon)
        # the winning plan's canonical input i binds the as-written
        # query's perm[i]-th first-visit leaf (identity when the original
        # candidate won; a reordering/leaf-dropping map otherwise)
        bindings = [bindings[p] for p in perm]
        if tel is not None:
            tel.end()
            if tel.tracing:
                tel.tracer.instant("cache_hit" if hit else "cache_miss")
            tel.begin("bind", n_inputs=plan.n_inputs)
        bp = BoundPlan(plan=plan, bindings=bindings, cache_hit=hit)
        if tel is not None:
            tel.end()
        return bp

    def _plan_arith(self, aq: ArithQuery,
                    columns: Mapping[str, int]) -> BoundPlan:
        widths = []
        for c in aq.cols:
            if c not in columns:
                raise QueryParseError(
                    f"unknown integer column {c!r} in arithmetic query")
            widths.append(columns[c])
        if len(set(widths)) != 1:
            raise QueryParseError(
                f"width mismatch in arithmetic query over {aq.cols}")
        n_bits = widths[0]
        bindings = [plane_name(c, j) for c in aq.cols for j in range(n_bits)]
        plan, hit = self.cache.lookup_arith(aq.op, n_bits)
        return BoundPlan(plan=plan, bindings=bindings, cache_hit=hit)
