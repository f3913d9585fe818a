"""The `bop` instruction layer (paper §6.2): dispatch Buddy vs CPU.

bop(dst, src1, [src2], size): the microarchitecture checks row alignment and
size, counts required RowClone-PSM staging copies, and executes on Buddy
unless (a) operands are misaligned/too small or (b) 3 PSM copies are needed
(where the CPU path is faster, §3.5). This module implements that dispatch
against the allocator's placement and executes both paths functionally so
results are bit-identical.

The counterpart of `repro.core.isa`. Rows are int32 word tensors on the
device's ``device`` (default ``"cuda"``, which raises where there is no
card). The Buddy path runs the op's AAP program through `core.engine`
(the VM kernel on the card); the CPU path is the plain tensor op on the
device that holds the rows, so nothing moves to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core import compiler, engine, timing
from repro_torch.core.allocator import DramAllocator
from repro_torch.core.bitplane import as_words
from repro_torch.core.rowclone import op_latency_with_placement
from repro_torch.core.timing import DDR3_1600


@dataclasses.dataclass
class BopResult:
    value: torch.Tensor       # packed int32 words (uint32 bit patterns)
    path: str                 # 'buddy' | 'cpu'
    latency_ns: float
    n_psm: int


class BuddyDevice:
    """Holds named packed rows + their DRAM placement; executes bop()s."""

    def __init__(self, allocator: Optional[DramAllocator] = None,
                 row_bits: Optional[int] = None, device="cuda"):
        self.alloc = allocator or DramAllocator()
        if row_bits is not None:
            geom = dataclasses.replace(self.alloc.geometry, row_bits=row_bits)
            self.alloc.geometry = geom
        self.device = resolve_device(device)
        self.rows: Dict[str, torch.Tensor] = {}

    @property
    def row_bits(self) -> int:
        return self.alloc.geometry.row_bits

    def store(self, name: str, words, group: Optional[str] = None):
        if words.shape[-1] * 32 != self.row_bits:
            raise ValueError(f"bop operands must be row-sized "
                             f"({self.row_bits} bits)")
        self.alloc.alloc(name, self.row_bits, group=group)
        self.rows[name] = as_words(words, self.device)

    def bop(self, op: str, dst: str, srcs: List[str],
            group: Optional[str] = None) -> BopResult:
        if dst not in self.rows:
            self.store(dst, torch.zeros_like(self.rows[srcs[0]]), group=group)
        n_psm = self.alloc.psm_copies_for_op(srcs, dst)
        use_cpu = n_psm >= 3  # §6.2.2 dispatch rule
        if use_cpu:
            from repro_torch.kernels.ref import BITWISE_OPS

            value = BITWISE_OPS[op](*[self.rows[s] for s in srcs])
            lat = _cpu_latency_ns(op, self.row_bits)
            path = "cpu"
        else:
            prog = compiler.op_program(op, srcs, dst)
            out = engine.execute(prog, {s: self.rows[s] for s in srcs},
                                 outputs=[dst], device=self.device)
            value = out[dst]
            lat = op_latency_with_placement(
                n_fpm_aap=prog.n_aap, n_psm_copies=n_psm,
                aap_ns=DDR3_1600.aap_ns) + prog.n_ap * DDR3_1600.ap_ns
            path = "buddy"
        self.rows[dst] = value
        return BopResult(value=value, path=path, latency_ns=lat, n_psm=n_psm)


def _cpu_latency_ns(op: str, row_bits: int) -> float:
    bytes_out = row_bits // 8
    gbps = timing.baseline_throughput_gbps(op, timing.SKYLAKE)
    return bytes_out / gbps
