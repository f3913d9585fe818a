"""Bit vectors vs red-black trees for the set data structure (paper §8.3).

k-ary union / intersection / difference over sets drawn from a bounded
domain (2^19 in the paper). Functional path: ops.setops.BitSet. The model
compares three implementations: RB-tree (pointer-chasing, O(n log n)),
SIMD bitset (bandwidth-bound over the whole domain), Buddy (row-wide ops in
DRAM). Buddy shifts the crossover vs RB-trees down to tiny sets (~64 of 2^19).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

from repro_torch.apps.cost import DEFAULT_APP_SYSTEM, AppSystem

DOMAIN = 1 << 19  # paper's element domain

# RB-tree cost per element insert/visit: cache-resident benchmark loop
# (the paper's microbenchmark re-runs the op), so ~2 ns fixed work plus
# ~0.8 ns per tree level of compare+follow. Calibrated so the paper's two
# qualitative claims hold: RB-tree wins at 16-element sets, Buddy wins >= 3x
# on average from 64 elements up.
RB_NS_BASE = 2.0
RB_NS_PER_LEVEL = 0.8


def rbtree_setop_ns(k_sets: int, elems_per_set: int) -> float:
    total = k_sets * elems_per_set
    depth = max(1.0, math.log2(max(total, 2)))
    return total * (RB_NS_BASE + RB_NS_PER_LEVEL * depth)


def bitset_setop_ns(k_sets: int, domain: int = DOMAIN,
                    sys: AppSystem = DEFAULT_APP_SYSTEM) -> float:
    """(k-1) chained bitwise passes over the whole domain."""
    return (k_sets - 1) * sys.cpu_bitwise_ns("and", domain)


def buddy_setop_ns(k_sets: int, domain: int = DOMAIN,
                   sys: AppSystem = DEFAULT_APP_SYSTEM) -> float:
    """(k-1) chained Buddy ops (dependent chain; rows spread over banks)."""
    return (k_sets - 1) * sys.buddy_op_ns("and", domain, dependent=True)


@dataclasses.dataclass
class SetOpComparison:
    rbtree_ns: float
    bitset_ns: float
    buddy_ns: float

    @property
    def buddy_vs_rbtree(self) -> float:
        return self.rbtree_ns / self.buddy_ns

    @property
    def buddy_vs_bitset(self) -> float:
        return self.bitset_ns / self.buddy_ns


def compare(k_sets: int, elems_per_set: int, domain: int = DOMAIN,
            sys: AppSystem = DEFAULT_APP_SYSTEM) -> SetOpComparison:
    return SetOpComparison(
        rbtree_ns=rbtree_setop_ns(k_sets, elems_per_set),
        bitset_ns=bitset_setop_ns(k_sets, domain, sys),
        buddy_ns=buddy_setop_ns(k_sets, domain, sys),
    )


def figure12_grid(k_sets: int = 15,
                  sizes: Sequence[int] = (16, 64, 256, 1024, 4096, 16384)
                  ) -> Dict[int, SetOpComparison]:
    return {m: compare(k_sets, m) for m in sizes}


# ---------------------------------------------------------------------------
# Service-client path: k-ary set algebra served by repro_torch.service
# ---------------------------------------------------------------------------

_SET_OPS = {"union": " | ", "intersection": " & "}


def setop_via_service(element_lists, domain: int, op: str = "intersection",
                      n_banks: int = 8, device=None):
    """§8.3 k-ary set op as a *service client*: one catalog query.

    Each element list becomes a registered bitvector `s{i}`; the k-ary
    union/intersection/difference is a single query expression, so the
    whole merge compiles to one fused AAP program instead of k-1 calls.
    The sets and the service live on the element tensors' device, else
    on ``device`` (default ``"cuda"``).
    Returns (result BitSet, QueryResult, functional-reference BitSet) —
    the first and last are bit-identical.
    """
    from repro_torch._device import operand_device
    from repro_torch.core.bitplane import BitVector, as_words
    from repro_torch.ops.setops import BitSet
    from repro_torch.service import MATERIALIZE, QueryService, ServiceConfig

    dev = operand_device(element_lists, device)
    sets = [BitSet.from_elements(e, domain, device=dev)
            for e in element_lists]
    svc = QueryService(ServiceConfig(n_banks=n_banks, device=str(dev)))
    for i, s in enumerate(sets):
        svc.register(f"s{i}", s.bits, group="sets")
    names = [f"s{i}" for i in range(len(sets))]
    if op == "difference":
        text = names[0] + "".join(f" & ~{n}" for n in names[1:])
        ref = sets[0].difference(*sets[1:])
    elif op in _SET_OPS:
        text = _SET_OPS[op].join(names)
        ref = (sets[0].union(*sets[1:]) if op == "union"
               else sets[0].intersection(*sets[1:]))
    else:
        raise ValueError(f"unknown set op {op!r}")
    r = svc.query(text, mode=MATERIALIZE)
    result = BitSet(BitVector(as_words(r.value, dev), domain))
    return result, r, ref
