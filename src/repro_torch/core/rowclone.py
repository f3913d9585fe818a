"""RowClone cost model (paper §3.5) + placement-aware copy planning.

RowClone-FPM (Fast Parallel Mode): intra-subarray copy via back-to-back
ACTIVATEs — in Buddy this *is* an AAP (49/80 ns).
RowClone-PSM (Pipelined Serial Mode): inter-bank copy over the shared internal
bus — ~1 KB granule reads overlapped with writes; ~1.28 us for an 8 KB row
(the paper's "copy ~ 1 us" and the §6.2.2 dispatch threshold both use this).
"""
from __future__ import annotations

import dataclasses
from enum import Enum


class CopyMode(Enum):
    FPM = "fpm"   # same subarray
    PSM = "psm"   # cross-bank via internal bus
    CHANNEL = "channel"  # different module: plain DDR read+write


@dataclasses.dataclass(frozen=True)
class RowCloneModel:
    fpm_ns: float = 49.0          # one (optimized) AAP
    psm_internal_bus_gbps: float = 6.4   # 64-bit @ 800 MHz
    row_bytes: int = 8192
    channel_bw_gbps: float = 12.8

    def copy_ns(self, mode: CopyMode) -> float:
        if mode == CopyMode.FPM:
            return self.fpm_ns
        if mode == CopyMode.PSM:
            return self.row_bytes / self.psm_internal_bus_gbps  # 1280 ns
        return 2 * self.row_bytes / self.channel_bw_gbps


DEFAULT_ROWCLONE = RowCloneModel()


def classify_copy(src_subarray: int, src_bank: int,
                  dst_subarray: int, dst_bank: int) -> CopyMode:
    if src_bank == dst_bank and src_subarray == dst_subarray:
        return CopyMode.FPM
    return CopyMode.PSM


def op_latency_with_placement(n_fpm_aap: int, n_psm_copies: int,
                              model: RowCloneModel = DEFAULT_ROWCLONE,
                              aap_ns: float = 49.0) -> float:
    """Latency of a Buddy op whose operand staging needs PSM copies.

    §3.5: with 3 PSM copies Buddy is slower than the CPU — §6.2.2 dispatches
    those to the CPU instead (see `core.isa`)."""
    return n_fpm_aap * aap_ns + n_psm_copies * model.copy_ns(CopyMode.PSM)
