"""Row-aligned, subarray-aware allocation (paper §6.2.4 OS support).

The OS maps pages likely to participate in bitwise ops so that (1) they are
row-aligned and (2) co-located in the same subarray, enabling all-FPM staging.
This module provides that placement logic for the simulator/cost model: a
simple bump allocator over (bank, subarray, data-row) coordinates with an
affinity-group API — allocations in one group land in one subarray while
capacity lasts, spilling to sibling subarrays otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.addressing import SubarrayGeometry
from repro_torch.core.rowclone import CopyMode, classify_copy


@dataclasses.dataclass(frozen=True)
class RowHandle:
    name: str
    bank: int
    subarray: int
    row: int            # D-group index within the subarray
    n_rows: int = 1     # multi-row allocations are contiguous


@dataclasses.dataclass
class DramAllocator:
    n_banks: int = 16
    subarrays_per_bank: int = 64
    geometry: SubarrayGeometry = dataclasses.field(default_factory=SubarrayGeometry)

    def __post_init__(self):
        self._cursor: Dict[Tuple[int, int], int] = {}
        self._groups: Dict[str, Tuple[int, int]] = {}
        self._handles: Dict[str, RowHandle] = {}
        self._next_sub = 0

    def _free_rows(self, bank: int, sub: int) -> int:
        return self.geometry.n_data_rows - self._cursor.get((bank, sub), 0)

    def _pick_subarray(self, group: Optional[str], n_rows: int) -> Tuple[int, int]:
        if group is not None and group in self._groups:
            bank, sub = self._groups[group]
            if self._free_rows(bank, sub) >= n_rows:
                return bank, sub
        # round-robin across (bank, subarray) to spread bank-level parallelism
        for _ in range(self.n_banks * self.subarrays_per_bank):
            idx = self._next_sub
            self._next_sub = (self._next_sub + 1) % (
                self.n_banks * self.subarrays_per_bank)
            bank, sub = divmod(idx, self.subarrays_per_bank)
            if self._free_rows(bank, sub) >= n_rows:
                if group is not None:
                    self._groups[group] = (bank, sub)
                return bank, sub
        raise MemoryError("DRAM allocator exhausted")

    def alloc(self, name: str, n_bits: int, group: Optional[str] = None) -> RowHandle:
        """Allocate ceil(n_bits/row_bits) contiguous rows, row-aligned."""
        n_rows = max(1, -(-n_bits // self.geometry.row_bits))
        bank, sub = self._pick_subarray(group, n_rows)
        row = self._cursor.get((bank, sub), 0)
        self._cursor[(bank, sub)] = row + n_rows
        h = RowHandle(name, bank, sub, row, n_rows)
        self._handles[name] = h
        return h

    def handle(self, name: str) -> RowHandle:
        return self._handles[name]

    def copy_mode(self, src: str, dst: str) -> CopyMode:
        a, b = self._handles[src], self._handles[dst]
        return classify_copy(a.subarray, a.bank, b.subarray, b.bank)

    def psm_copies_for_op(self, srcs: List[str], dst: str) -> int:
        """How many of the operand/result movements need PSM (§6.2.2)."""
        subs = {(self._handles[s].bank, self._handles[s].subarray) for s in srcs}
        subs.add((self._handles[dst].bank, self._handles[dst].subarray))
        # all in one subarray -> 0 PSM; each extra distinct subarray costs one
        return len(subs) - 1
