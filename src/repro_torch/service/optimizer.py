"""Cost-based query optimizer: one pricing model from Expr DAG to backend.

The planning pipeline is `parse -> canonicalize -> optimize -> cost ->
bind -> dispatch`; this module owns the `optimize` and `cost` stages plus
the cross-query sharing pass the scheduler applies per batch. It follows
the compiler/allocator story of the 2019 in-DRAM bulk-bitwise execution
engine (arXiv:1905.09822 §4) on top of the Buddy substrate: every
alternative is priced in AAPs x `core.timing` latency x `core.energy`
energy, and the cheapest wins — never-worse by construction, because the
unoptimized candidate always competes.

Three decisions are made here:

  * **predicate reordering** (`reorder_expr`): associative-commutative
    chains (`and`/`or`/`xor`) are flattened, deduplicated (idempotence
    across non-adjacent operands, XOR parity cancellation — cases the
    pairwise fusion rules cannot see) and re-built left-deep in
    (estimated-cost, structural-key) order. The deterministic order also
    makes differently-written queries converge on one canonical shape, so
    they share a single cached plan. The plan cache compiles both the
    original and the reordered DAG and keeps whichever costs fewer AAPs.
  * **backend selection** (`choose_backend`): per plan, recorded on the
    `Plan` — the CUDA VM kernel for every program on a CUDA device; on
    the CPU the eager interpreter for degenerate 1-2 command programs
    and the plain PyTorch VM otherwise.
  * **cross-query CSE** (`plan_group_cse`): within one batch, bound
    sub-DAGs that appear in >= 2 queries compile once into ephemeral
    "$cse{k}" planes; consumers reference the plane as an input leaf
    (a RowClone copy on the modeled bus) instead of recomputing it. The
    rewrite is kept only when the exact re-costed AAP total is lower
    than the unshared baseline.

`ExplainReport` is the user-facing surface of all three decisions,
reachable through `QueryService.explain()` and `launch/serve_bitwise.py
--explain`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import energy as energy_model
from repro_torch.core import timing as timing_model
from repro_torch.core.commands import Program
from repro_torch.core.compiler import (CHAIN_OPS, Expr, expr_key,
                                       flatten_chain, iter_subexprs,
                                       rebuild_chain)

#: leaf-name prefix of batch-ephemeral shared planes. Starts with "$" so it
#: can never collide with a catalog name (`catalog._NAME_RE` requires a
#:  letter/underscore first character).
CSE_PREFIX = "$cse"

#: pre-fusion AAP cost of each raw Expr op — the structural estimate the
#: reordering sort key uses (the authoritative number is always a real
#: compile; this only has to rank operands consistently).
_OP_AAPS = {"not": 2, "and": 4, "or": 4, "maj3": 4, "xor": 7}


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Everything the cost model is parameterized by.

    `n_blocks` is the operand size in 8KB row-blocks (`ceil(domain /
    ROW_BITS)`), `n_banks`/`n_chips` the parallelism the amortized view
    divides by. `device` is the torch device type the service runs on
    ("cuda" / "cpu"; "" = the card when one is present, else the CPU).
    """

    timing: timing_model.DramTiming = timing_model.DDR3_1600
    energy: energy_model.EnergyModel = energy_model.DEFAULT_ENERGY
    n_banks: int = 8
    n_chips: int = 1
    n_blocks: int = 1
    device: str = ""

    def resolved_device(self) -> str:
        if self.device:
            return self.device
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Price of one plan execution under a `CostParams`.

    `latency_ns`/`energy_nj` are per row-block program costs, `xfer_ns`
    the serialized operand+result bus transfers per block, `total_ns` /
    `total_energy_nj` the all-blocks single-bank serial view, and
    `amortized_ns` the per-query share when a full batch keeps every
    (chip, bank) busy.
    """

    n_aaps: int
    n_aps: int
    latency_ns: float
    energy_nj: float
    xfer_ns: float
    total_ns: float
    total_energy_nj: float
    amortized_ns: float


def cost_program(program: Program, n_inputs: int, n_outputs: int,
                 params: CostParams = CostParams()) -> PlanCost:
    """Price one compiled program: AAPs x latency x energy x transfers."""
    lat = timing_model.program_latency_ns(program, params.timing)
    en = energy_model.program_energy_nj(program, params.energy)
    xfer = params.timing.aap_ns * (n_inputs + n_outputs)
    blocks = max(1, params.n_blocks)
    total_ns = blocks * (xfer + lat)
    return PlanCost(
        n_aaps=program.n_aap, n_aps=program.n_ap, latency_ns=lat,
        energy_nj=en, xfer_ns=xfer, total_ns=total_ns,
        total_energy_nj=blocks * en,
        amortized_ns=total_ns / max(1, params.n_banks * params.n_chips))


def cost_programs(programs: Sequence[Program],
                  arities: Sequence[Tuple[int, int]],
                  params: CostParams = CostParams()) -> List[PlanCost]:
    """Batched costing: one timing/energy query for a whole plan set."""
    lats = timing_model.programs_latency_ns(programs, params.timing)
    ens = energy_model.programs_energy_nj(programs, params.energy)
    blocks = max(1, params.n_blocks)
    slots = max(1, params.n_banks * params.n_chips)
    out: List[PlanCost] = []
    for prog, (n_in, n_out), lat, en in zip(programs, arities, lats, ens):
        xfer = params.timing.aap_ns * (n_in + n_out)
        total_ns = blocks * (xfer + lat)
        out.append(PlanCost(
            n_aaps=prog.n_aap, n_aps=prog.n_ap, latency_ns=lat,
            energy_nj=en, xfer_ns=xfer, total_ns=total_ns,
            total_energy_nj=blocks * en, amortized_ns=total_ns / slots))
    return out


# ---------------------------------------------------------------------------
# Stage: optimize (predicate / AND-OR-XOR chain reordering)
# ---------------------------------------------------------------------------


def _est_cost(e: Expr, memo: Dict[Tuple, int]) -> int:
    """Structural AAP estimate: distinct interior ops weighted by their
    primitive program cost (DAG sharing counted once, like the compiler)."""
    k = expr_key(e)
    got = memo.get(k)
    if got is not None:
        return got
    cost = sum(_OP_AAPS.get(n.op, 4) for n in iter_subexprs(e)
               if n.op != "row")
    memo[k] = cost
    return cost


def reorder_expr(expr: Expr) -> Expr:
    """Cost-ordered, deduplicated rewrite of every a-c chain in the DAG.

    Bottom-up over the DAG (memoized on structural keys so sharing is
    preserved): each maximal `and`/`or`/`xor` chain is flattened,
    duplicate operands are removed (`a & x & a -> a & x`; XOR keeps the
    parity, `a ^ b ^ a -> b`), and the survivors are re-built left-deep
    sorted by (estimated AAP cost, structural key). Cheap operands first
    and a deterministic total order — so operand-order variants of one
    query converge on a single canonical shape. Semantics are preserved;
    a chain that cancels to nothing (`a ^ a`) is left untouched for the
    compiler's own rules to handle.
    """
    memo: Dict[Tuple, Expr] = {}
    cost_memo: Dict[Tuple, int] = {}

    def go(e: Expr) -> Expr:
        k = expr_key(e)
        got = memo.get(k)
        if got is not None:
            return got
        if e.op == "row":
            memo[k] = e
            return e
        node = Expr(e.op, tuple(go(a) for a in e.args))
        if e.op in CHAIN_OPS:
            ops = flatten_chain(node, e.op)
            if e.op == "xor":
                parity: Dict[Tuple, int] = {}
                first: Dict[Tuple, Expr] = {}
                order: List[Tuple] = []
                for o in ops:
                    ko = expr_key(o)
                    if ko not in parity:
                        parity[ko] = 0
                        first[ko] = o
                        order.append(ko)
                    parity[ko] ^= 1
                uniq = [first[ko] for ko in order if parity[ko]]
            else:
                seen: Dict[Tuple, None] = {}
                uniq = []
                for o in ops:
                    ko = expr_key(o)
                    if ko not in seen:
                        seen[ko] = None
                        uniq.append(o)
            if uniq:
                uniq.sort(key=lambda o: (_est_cost(o, cost_memo),
                                         repr(expr_key(o))))
                node = rebuild_chain(e.op, uniq)
        memo[k] = node
        return node

    return go(expr)


# ---------------------------------------------------------------------------
# Stage: backend selection
# ---------------------------------------------------------------------------

#: on the CPU, below this command count the eager interpreter beats a VM
#: run of the plain PyTorch loop
_INTERP_MAX_CMDS = 2


def choose_backend(program: Program, device: str) -> str:
    """Per-plan dispatch backend: "cuda" | "interp" | "torch".

    On a CUDA device every program takes the VM kernel ("cuda"): the
    reference's command-count thresholds priced a TPU kernel's launch
    and its CPU interpret mode, and on the card the alternatives are the
    plain PyTorch versions. On the CPU the map is the reference's
    ("interp" for 1-2 command programs, the VM loop otherwise), and a
    count-only dispatch chooses the same way as any other.
    """
    if device == "cuda":
        return "cuda"
    if len(program.commands) <= _INTERP_MAX_CMDS:
        return "interp"
    return "torch"


# ---------------------------------------------------------------------------
# The optimizer object the plan cache drives
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QueryOptimizer:
    """Bundles the cost model with the per-plan optimization decisions.

    Owned by the `PlanCache` (`service.planner`): `reorder` supplies the
    alternative candidate DAG, `cost` prices the winner, `backend` records
    the dispatch choice on the `Plan`. `enable_cse` gates the scheduler's
    batch-level sharing pass.
    """

    params: CostParams = CostParams()
    enable_reorder: bool = True
    enable_cse: bool = True

    def __post_init__(self):
        self._device = self.params.resolved_device()

    def reorder(self, canon: Expr) -> Expr:
        return reorder_expr(canon) if self.enable_reorder else canon

    def cost(self, program: Program, n_inputs: int,
             n_outputs: int) -> PlanCost:
        return cost_program(program, n_inputs, n_outputs, self.params)

    def backend(self, program: Program) -> str:
        return choose_backend(program, self._device)


# ---------------------------------------------------------------------------
# Cross-query CSE within one plan-group batch
# ---------------------------------------------------------------------------


def bind_expr(canon: Expr, input_map: Dict[str, str]) -> Expr:
    """Substitute canonical IN-leaves back to actual catalog rows; a node
    the DAG shares is bound once and stays shared."""
    done: Dict[int, Expr] = {}      # id(node) -> its bound node

    def go(e: Expr) -> Expr:
        got = done.get(id(e))
        if got is None:
            if e.op == "row":
                got = Expr.of(input_map.get(e.row, e.row))
            else:
                got = Expr(e.op, tuple(go(a) for a in e.args))
            done[id(e)] = got
        return got

    return go(canon)


@dataclasses.dataclass
class CseDef:
    """One shared subexpression: computed once, referenced as a leaf."""

    name: str                 # "$cse{k}" plane leaf
    expr: Expr                # bound body (may reference earlier planes)
    bound: object             # the def's own BoundPlan
    uses: int                 # containers (queries or defs) referencing it


@dataclasses.dataclass
class CseBatch:
    """Outcome of the batch sharing pass (only produced when it wins)."""

    bound: List[object]       # per query: rewritten or original BoundPlan
    defs: List[CseDef]        # topologically ordered (dependencies first)
    baseline_aaps: int        # sum of the unshared per-query plan AAPs
    optimized_aaps: int       # defs once + rewritten consumers


class _BatchDag:
    """A batch's expressions hash-consed: one small int per distinct
    structure (equal ints exactly where `expr_key` is equal).

    A node's signature is its row, or its op and its children's ints: a
    flat tuple, so interning hashes a few small ints and never a nested
    key. `node[i]` is the first node seen of structure i, `kids[i]` its
    children's ints, and `below[i]` the bit set of the distinct interior
    structures in its DAG, itself included (0 for a leaf): so
    `expr_size(node[i]) == below[i].bit_count()`. Nodes are also indexed
    by identity, which holds while the caller keeps the expressions.
    """

    def __init__(self):
        self.node: List[Expr] = []
        self.kids: List[Tuple[int, ...]] = []
        self.below: List[int] = []
        self._sig: Dict[object, int] = {}
        self._of: Dict[int, int] = {}

    def add(self, e: Expr) -> int:
        """The structure of `e`, interning its DAG bottom-up."""
        i = self._of.get(id(e))
        if i is not None:
            return i
        if e.op == "row":
            kids: Tuple[int, ...] = ()
            sig: object = e.row
        else:
            kids = tuple(self.add(a) for a in e.args)
            sig = (e.op,) + kids
        i = self._sig.get(sig)
        if i is None:
            i = len(self.node)
            self._sig[sig] = i
            self.node.append(e)
            self.kids.append(kids)
            below = 0
            if e.op != "row":
                below = 1 << i
                for c in kids:
                    below |= self.below[c]
            self.below.append(below)
        self._of[id(e)] = i
        return i

    def interior(self, root: int) -> List[int]:
        """The distinct interior structures of `root`'s DAG."""
        out = []
        seen = set()
        stack = [root]
        while stack:
            i = stack.pop()
            if i in seen or not self.below[i]:
                continue
            seen.add(i)
            out.append(i)
            stack.extend(self.kids[i])
        return out


def plan_group_cse(bound: Sequence[object],
                   exprs: Sequence[Optional[Expr]],
                   plan_fn: Callable[[Expr], object],
                   subexprs=None) -> Optional[CseBatch]:
    """Share sub-DAGs appearing in >= 2 of a batch's bound queries.

    `bound` are the batch's original BoundPlans, `exprs` the bound boolean
    DAGs over actual catalog rows (None = ineligible query: arithmetic,
    multi-output), `plan_fn` plans an Expr through the normal pipeline.
    `subexprs`, a counter (`inc`), if given, gets the number of distinct
    interior sub-DAGs the pass counted.

    Candidates are counted with per-query set semantics, picked outermost
    -first (largest saving), then iterated to a fixpoint dropping any pick
    that ends up referenced by fewer than two containers. The rewrite is
    abandoned wholesale unless the exact re-costed AAP total (defs once +
    rewritten consumers) is strictly below the unshared baseline — the
    optimizer never emits more AAPs than the current pipeline.

    The pass walks each distinct sub-DAG a bounded number of times: the
    batch is hash-consed once (`_BatchDag`), the fixpoint rounds work on
    its ints, and only the final rewrite builds new nodes.
    """
    dag = _BatchDag()
    roots = [None if e is None else dag.add(e) for e in exprs]
    count: Dict[int, int] = {}
    for r in roots:
        if r is not None:
            for i in dag.interior(r):
                count[i] = count.get(i, 0) + 1
    if subexprs is not None:
        subexprs.inc(len(count))
    if sum(r is not None for r in roots) < 2:
        return None
    cands = [i for i, c in count.items() if c >= 2]
    if not cands:
        return None
    # outermost-first pick order; names assigned once, deterministically
    cands.sort(key=lambda i: (-dag.below[i].bit_count(),
                              repr(expr_key(dag.node[i]))))
    picked: Dict[int, str] = {i: f"{CSE_PREFIX}{n}"
                              for n, i in enumerate(cands)}

    while True:
        # planes[i]: the `$cse` planes the rewrite of structure i
        # references; outermost match wins, so a pick nested inside
        # another survives only inside the outer one's definition
        planes: Dict[int, frozenset] = {}

        def planes_of(i: int) -> frozenset:
            got = planes.get(i)
            if got is None:
                name = picked.get(i)
                got = (frozenset((name,)) if name is not None
                       else planes_below(i))
                planes[i] = got
            return got

        def planes_below(i: int) -> frozenset:
            got = frozenset()
            for c in dag.kids[i]:
                got = got | planes_of(c)
            return got

        body_planes = {i: planes_below(i) for i in picked}
        uses = {name: 0 for name in picked.values()}
        for r in roots:
            if r is not None:
                for name in planes_of(r):
                    uses[name] += 1
        for names in body_planes.values():
            for name in names:
                uses[name] += 1
        drop = [i for i, name in picked.items() if uses[name] < 2]
        if not drop:
            break
        for i in drop:
            del picked[i]
        if not picked:
            return None

    # the final round's `planes_of` holds for the final picks
    built: Dict[int, Expr] = {}

    def rewrite(i: int) -> Expr:
        got = built.get(i)
        if got is None:
            name = picked.get(i)
            if name is not None:
                got = Expr.of(name)
            elif planes_of(i):
                got = Expr(dag.node[i].op,
                           tuple(rewrite(c) for c in dag.kids[i]))
            else:
                got = dag.node[i]
            built[i] = got
        return got

    rewritten = [None if r is None else rewrite(r) for r in roots]
    bodies = {i: Expr(dag.node[i].op, tuple(rewrite(c) for c in dag.kids[i]))
              for i in picked}

    # topological order: a def lands after every plane it references
    by_name = {name: i for i, name in picked.items()}
    order: List[int] = []
    state: Dict[int, int] = {}

    def visit(i: int):
        if state.get(i) == 2:
            return
        assert state.get(i) != 1, "cyclic $cse dependency"
        state[i] = 1
        for name in sorted(body_planes[i]):
            visit(by_name[name])
        state[i] = 2
        order.append(i)

    for i in sorted(picked, key=picked.get):
        visit(i)

    defs = [CseDef(name=picked[i], expr=bodies[i],
                   bound=plan_fn(bodies[i]), uses=uses[picked[i]])
            for i in order]
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
# explain(): the human-readable decision record
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanExplain:
    """One query's planning outcome inside an `ExplainReport`."""

    index: int
    query: str
    backend: str
    cache_hit: bool
    n_aaps: int
    n_aaps_unopt: int
    latency_ns: float
    energy_nj: float
    xfer_ns: float
    n_inputs: int
    shared: Tuple[str, ...] = ()    # $cse planes this query consumes
    rewritten: bool = False


@dataclasses.dataclass
class CseExplain:
    """One shared plane inside an `ExplainReport`."""

    name: str
    n_aaps: int
    uses: int


@dataclasses.dataclass
class ExplainReport:
    """Per-plan cost breakdown + backend choice + sharing report."""

    plans: List[PlanExplain]
    cse: List[CseExplain]
    n_plan_groups: int
    total_aaps: int
    baseline_aaps: int
    makespan_ns: float
    n_banks: int = 8
    n_chips: int = 1

    @property
    def aap_reduction(self) -> float:
        """How many times fewer AAPs than the unoptimized pipeline."""
        if self.total_aaps <= 0:
            return 1.0
        return self.baseline_aaps / self.total_aaps

    def __str__(self) -> str:
        head = (f"{'q':>4} {'backend':<8}{'hit':<5}{'aaps':>6} "
                f"{'(unopt)':>8} {'latency':>10} {'energy':>9}  shared")
        lines = ["-- explain " + "-" * max(8, len(head) - 11), head]
        for p in self.plans:
            q = p.query if len(p.query) <= 34 else p.query[:31] + "..."
            lines.append(
                f"{p.index:>4} {p.backend:<8}"
                f"{('yes' if p.cache_hit else 'no'):<5}"
                f"{p.n_aaps:>6} {p.n_aaps_unopt:>8} "
                f"{p.latency_ns:>8.0f}ns {p.energy_nj:>7.1f}nj  "
                f"{','.join(p.shared) or '-':<10} {q}")
        for d in self.cse:
            lines.append(f"   shared plane {d.name}: {d.n_aaps} AAPs, "
                         f"{d.uses} uses (computed once)")
        lines.append(
            f"   {len(self.plans)} queries -> {self.n_plan_groups} plan "
            f"groups on {self.n_chips} chip(s) x {self.n_banks} banks")
        lines.append(
            f"   total {self.total_aaps} AAPs vs {self.baseline_aaps} "
            f"unoptimized ({self.aap_reduction:.2f}x fewer); modeled "
            f"makespan {self.makespan_ns / 1e3:.1f} us")
        return "\n".join(lines)
