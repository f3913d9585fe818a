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
from repro_torch.core.compiler import (CHAIN_OPS, Expr, expr_key, expr_size,
                                 flatten_chain, iter_subexprs, rebuild_chain)

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
    """Substitute canonical IN-leaves back to actual catalog rows."""
    if canon.op == "row":
        return Expr.of(input_map.get(canon.row, canon.row))
    return Expr(canon.op, tuple(bind_expr(a, input_map) for a in canon.args))


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
