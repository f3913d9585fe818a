"""Row-address grouping (paper §5.1, Table 2).

Each subarray's row-address space splits into three groups:

  B-group ("bitwise"): 16 reserved addresses B0..B15 controlling 8 physical
      wordlines — four designated rows T0..T3 (TRA operands) and the d-/n-
      wordlines of two dual-contact-cell rows DCC0/DCC1.
  C-group ("control"): C0 (all zeros), C1 (all ones), pre-initialized.
  D-group ("data"): everything else (1006 of 1024 rows) — what the OS sees.

The published Table 2 loses the overline typography on n-wordlines; the
mapping below is reconstructed so every Fig. 8 program is correct (verified by
`tests/test_engine.py` against jnp oracles):

  B0..B3  -> single d-wordline of T0..T3
  B4 / B6 -> d-wordline of DCC0 / DCC1
  B5 / B7 -> n-wordline of DCC0 / DCC1   (captures NOT of the sensed value)
  B8  -> {DCC0.n, T0.d}    B9  -> {DCC1.n, T1.d}
  B10 -> {T2.d, T3.d}      B11 -> {T0.d, T3.d}
  B12 -> {T0,T1,T2}.d      B13 -> {T1,T2,T3}.d
  B14 -> {DCC0.d, T1, T2}  B15 -> {DCC1.d, T0, T3}

Area accounting (paper §5.4): B-group = 4 designated rows + 2 DCC rows (each
DCC ~ 2 cells => 4 row-equivalents) and C-group = 2 rows => 10 row-equivalents
per 1024-row subarray ~= 1% capacity loss.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# Physical wordline identifiers. For DCC rows, (row, polarity) where polarity
# 'd' connects the cell to the bitline and 'n' to bitline-bar.
D_WL = "d"
N_WL = "n"

T0, T1, T2, T3 = "T0", "T1", "T2", "T3"
DCC0, DCC1 = "DCC0", "DCC1"
C0, C1 = "C0", "C1"

B_GROUP_ROWS = (T0, T1, T2, T3, DCC0, DCC1)
C_GROUP_ROWS = (C0, C1)

# Address -> list of (row, polarity). Reconstructed Table 2.
B_ADDRESS_MAP: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "B0": ((T0, D_WL),),
    "B1": ((T1, D_WL),),
    "B2": ((T2, D_WL),),
    "B3": ((T3, D_WL),),
    "B4": ((DCC0, D_WL),),
    "B5": ((DCC0, N_WL),),
    "B6": ((DCC1, D_WL),),
    "B7": ((DCC1, N_WL),),
    "B8": ((DCC0, N_WL), (T0, D_WL)),
    "B9": ((DCC1, N_WL), (T1, D_WL)),
    "B10": ((T2, D_WL), (T3, D_WL)),
    "B11": ((T0, D_WL), (T3, D_WL)),
    "B12": ((T0, D_WL), (T1, D_WL), (T2, D_WL)),
    "B13": ((T1, D_WL), (T2, D_WL), (T3, D_WL)),
    "B14": ((DCC0, D_WL), (T1, D_WL), (T2, D_WL)),
    "B15": ((DCC1, D_WL), (T0, D_WL), (T3, D_WL)),
}


@dataclasses.dataclass(frozen=True)
class SubarrayGeometry:
    """Geometry of one subarray (paper defaults; tests shrink these)."""

    n_rows: int = 1024          # physical rows incl. reserved
    row_bits: int = 65536       # 8 KB per row across the rank
    n_b_group_row_equiv: int = 8  # 4 designated + 2 DCC rows (2 cells each)

    @property
    def n_data_rows(self) -> int:
        # 1024 - (8 B-group row equivalents + 2 C-group rows)
        return self.n_rows - self.n_b_group_row_equiv - len(C_GROUP_ROWS)

    @property
    def row_words(self) -> int:
        return self.row_bits // 32

    @property
    def row_bytes(self) -> int:
        return self.row_bits // 8

    @property
    def capacity_loss(self) -> float:
        """Fraction of rows unavailable to the OS (paper: ~1%)."""
        return 1.0 - self.n_data_rows / self.n_rows


def resolve(addr: str) -> Tuple[Tuple[str, str], ...]:
    """Resolve a row address to its raised wordlines.

    D-group / C-group addresses raise a single d-wordline of that row.
    """
    if addr in B_ADDRESS_MAP:
        return B_ADDRESS_MAP[addr]
    return ((addr, D_WL),)


def is_b_group(addr: str) -> bool:
    return addr in B_ADDRESS_MAP


def is_c_group(addr: str) -> bool:
    return addr in C_GROUP_ROWS


def is_d_group(addr: str) -> bool:
    return not is_b_group(addr) and not is_c_group(addr)


def wordlines_raised(addr: str) -> int:
    return len(resolve(addr))


def data_addresses(geom: SubarrayGeometry) -> List[str]:
    return [f"D{i}" for i in range(geom.n_data_rows)]
