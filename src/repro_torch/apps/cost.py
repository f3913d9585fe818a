"""Shared cost model for the §8 application studies (Gem5 replaced by an
analytical model — see DESIGN.md §8 'honest gaps').

System under test mirrors the paper's Table 4: DDR4-2400, 1 channel, 16
banks. Baseline CPU bulk-bitwise streaming is bandwidth-bound; bitcount is a
popcnt dependency chain. Buddy executes AAP programs at DDR3-1600-class
timing, one op per bank concurrently for independent rows, serialized for
dependent op chains.

Calibrated constants (each justified in comments; paper-reported end-to-end
speedups then *derive*): see benchmarks/fig10/11/12 for the validation.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import compiler, timing


@dataclasses.dataclass(frozen=True)
class AppSystem:
    # DDR4-2400 x64: 19.2 GB/s peak.
    peak_bw_gbps: float = 19.2
    rmw_efficiency: float = 0.54    # read-modify-write streams w/ RFO
    stream_efficiency: float = 0.80 # pure streaming reads
    l2_bytes: int = 2 * 1024 * 1024
    l2_bw_gbps: float = 50.0
    # popcnt loop: ~0.8 bytes/cycle effective at 4 GHz when cache-resident is
    # irrelevant (dependency chain) -> ~3 GB/s; memory-streaming variant used
    # by BitWeaving baselines hits the stream bandwidth instead.
    bitcount_chain_gbps: float = 3.0
    banks: int = 16
    row_bits: int = 65536  # 8 KB row

    # -- baseline CPU -------------------------------------------------------
    def cpu_bitwise_ns(self, op: str, n_bits: int) -> float:
        bytes_out = n_bits / 8
        traffic = timing.bytes_moved_per_output_byte(op)
        ws = bytes_out * traffic
        bw = self.l2_bw_gbps if ws <= self.l2_bytes else \
            self.peak_bw_gbps * self.rmw_efficiency
        return bytes_out * traffic / bw

    def cpu_stream_ns(self, n_bytes: float, cache_resident: bool = False
                      ) -> float:
        bw = self.l2_bw_gbps if cache_resident else \
            self.peak_bw_gbps * self.stream_efficiency
        return n_bytes / bw

    def cpu_bitcount_ns(self, n_bits: int, streaming: bool = False,
                        cache_resident: bool = False) -> float:
        if streaming:
            return self.cpu_stream_ns(n_bits / 8, cache_resident)
        return (n_bits / 8) / self.bitcount_chain_gbps

    # -- Buddy --------------------------------------------------------------
    def buddy_op_ns(self, op: str, n_bits: int, dependent: bool = True
                    ) -> float:
        """One bulk op over an n_bits-wide operand.

        The operand spans ceil(n_bits/row_bits) DRAM rows; row-slices are
        independent, so they spread over the banks. `dependent` chains (the
        common case inside a query) cannot overlap *across* ops.
        """
        srcs = ["D0"] if op in ("not", "copy") else ["D0", "D1"]
        prog = compiler.op_program(op if op != "copy" else "copy", srcs, "D2")
        lat = timing.program_latency_ns(prog)
        rows = max(1, math.ceil(n_bits / self.row_bits))
        waves = math.ceil(rows / self.banks)
        return waves * lat if dependent else rows * lat / self.banks


DEFAULT_APP_SYSTEM = AppSystem()
