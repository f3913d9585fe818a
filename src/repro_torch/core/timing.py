"""DDR3 timing model for Buddy command sequences (paper §5.3, §7).

Derived, not hard-coded: latency of an operation = f(command counts) with
DDR3-1600 (8-8-8) parameters. The paper's headline numbers fall out:

  naive AAP      = 2*tRAS + tRP             = 80 ns
  optimized AAP  = tRAS + t_overlap + tRP   = 49 ns   (split row decoder)
  AP             = tRAS + tRP               = 45 ns

Throughput of an op = row_bytes / latency(program), scaling linearly with the
number of banks (each Buddy op is contained in one bank) up to the tFAW
activation-power constraint (§5.4).

Baselines (Skylake / GTX 745) are modeled as bandwidth-bound streaming:
throughput = effective_bandwidth / bytes_moved_per_output_byte, with
effective bandwidths calibrated once against the paper's own reported
speedup ranges (§7) and documented here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.commands import Program


@dataclasses.dataclass(frozen=True)
class DramTiming:
    """DDR3-1600 8-8-8 (JEDEC [30]) — times in ns."""

    tRAS: float = 35.0
    tRP: float = 10.0
    tRCD: float = 10.0
    t_overlap_margin: float = 4.0   # §5.3: second ACTIVATE finishes 4ns after tRAS
    tFAW: float = 30.0              # four-activate window
    row_bytes: int = 8192
    split_decoder: bool = True      # the §5.3 optimization

    @property
    def aap_ns(self) -> float:
        if self.split_decoder:
            return self.tRAS + self.t_overlap_margin + self.tRP  # 49 ns
        return 2 * self.tRAS + self.tRP  # 80 ns

    @property
    def ap_ns(self) -> float:
        return self.tRAS + self.tRP  # 45 ns


DDR3_1600 = DramTiming()


def program_latency_ns(prog: Program, timing: DramTiming = DDR3_1600) -> float:
    return prog.n_aap * timing.aap_ns + prog.n_ap * timing.ap_ns


def programs_latency_ns(progs, timing: DramTiming = DDR3_1600):
    """Batched `program_latency_ns`: one cost query for a whole plan set.

    The cost-based optimizer (`service.optimizer`) prices every candidate
    of a plan-group batch in one call; the timing parameters are resolved
    once instead of per program.
    """
    aap, ap = timing.aap_ns, timing.ap_ns
    return [p.n_aap * aap + p.n_ap * ap for p in progs]


def program_activates(prog: Program) -> int:
    return 2 * prog.n_aap + prog.n_ap


def buddy_throughput_gbps(prog: Program, banks: int = 1,
                          timing: DramTiming = DDR3_1600,
                          respect_tfaw: bool = False) -> float:
    """GB/s of *output* produced (one row of output per program execution).

    Buddy ops in different banks proceed concurrently (§1); with B banks the
    ACTIVATE issue rate is B * activates/program / latency. tFAW caps the
    rate at 4 activates per tFAW window.
    """
    lat = program_latency_ns(prog, timing)
    tput = banks * timing.row_bytes / lat  # bytes/ns == GB/s
    if respect_tfaw:
        act_rate = banks * program_activates(prog) / lat  # activates/ns
        max_rate = 4.0 / timing.tFAW
        if act_rate > max_rate:
            tput *= max_rate / act_rate
    return tput


# ---------------------------------------------------------------------------
# Baseline systems (paper §7): bandwidth-bound bulk bitwise ops.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BaselineSystem:
    """A processor whose bulk-bitwise throughput is memory-bandwidth bound.

    effective_bw_gbps is the *achieved streaming* bandwidth. Calibration
    (documented in benchmarks/fig9_throughput.py): Skylake 2ch DDR3-2133 has
    34.1 GB/s peak; achieved read-modify-write streaming with RFO lands at
    ~54%. GTX 745 has 28.8 GB/s peak (128-bit DDR3-1800); GPUs stream at
    ~90% of peak. These two scalars are the only fitted constants, chosen so
    the modeled Buddy-vs-baseline ratios land inside the paper's reported
    ranges (3.8-9.1x vs Skylake, 2.7-6.4x vs GTX; abstract 10.9-25.6x for
    4 banks) — then *every* per-op number is derived.
    """

    name: str
    peak_bw_gbps: float
    efficiency: float

    @property
    def effective_bw_gbps(self) -> float:
        return self.peak_bw_gbps * self.efficiency


SKYLAKE = BaselineSystem("skylake-i7", peak_bw_gbps=34.1, efficiency=0.54)
GTX745 = BaselineSystem("gtx-745", peak_bw_gbps=28.8, efficiency=0.90)


def bytes_moved_per_output_byte(op: str) -> int:
    """Channel traffic for out = op(in...) in a cache-based system.

    Unary (not/copy): read src + write dst (write-allocate RFO read of dst is
    ~overlapped for streaming stores) -> 2. Binary: read 2 srcs + write -> 3.
    """
    return 2 if op in ("not", "copy") else 3


def baseline_throughput_gbps(op: str, system: BaselineSystem) -> float:
    return system.effective_bw_gbps / bytes_moved_per_output_byte(op)


def throughput_table(banks_list=(1, 2, 4),
                     respect_tfaw: bool = False) -> Dict[str, Dict[str, float]]:
    """Fig. 9: throughput (GB/s) per op for baselines and Buddy @ N banks."""
    from repro_torch.core import compiler

    ops = ["not", "and", "or", "nand", "nor", "xor", "xnor"]
    table: Dict[str, Dict[str, float]] = {}
    for op in ops:
        row: Dict[str, float] = {
            "skylake": baseline_throughput_gbps(op, SKYLAKE),
            "gtx745": baseline_throughput_gbps(op, GTX745),
        }
        srcs = ["D0"] if op == "not" else ["D0", "D1"]
        prog = compiler.op_program(op, srcs, "D2")
        for b in banks_list:
            row[f"buddy_{b}bank"] = buddy_throughput_gbps(
                prog, banks=b, respect_tfaw=respect_tfaw)
        table[op] = row
    return table
