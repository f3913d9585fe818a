"""Functional simulator of the Buddy subarray (paper §3-§5 semantics).

Executes AAP/AP command programs against a subarray state with the *exact*
hardware semantics, including the destructive nature of triple-row activation
(all connected cells are overwritten with the sensed result, Fig. 4 state 3)
and the negation capture of dual-contact-cell n-wordlines (Fig. 6).

The state is a dict of packed int32 word tensors; every step builds new
tensors (no in-place update), so rows may alias one another freely. This
micro-op interpreter is the port's in-package oracle and its ``"interp"``
backend; `execute(lowered=True)` runs the opcode-table VM of
`core.lowering` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch._device import operand_device
from repro_torch.core import addressing
from repro_torch.core.addressing import D_WL, resolve
from repro_torch.core.bitplane import WORD_DTYPE, as_words
from repro_torch.core.commands import Activate, Precharge, Program
from repro_torch.obs.telemetry import get_telemetry

RowState = Dict[str, torch.Tensor]


class BuddyError(RuntimeError):
    pass


def _maj3(a, b, c):
    return (a & b) | (b & c) | (c & a)


@dataclasses.dataclass
class Subarray:
    """One subarray: named rows -> packed int32 words (same shape each).

    `rows` always contains T0..T3, DCC0, DCC1, C0, C1 plus any D-group rows
    the caller installs. C0/C1 are pre-initialized (paper §3.5).
    """

    rows: RowState
    row_words: int
    strict: bool = True  # raise on analog-undefined sequences

    @classmethod
    def create(cls, row_words: int, data: Optional[RowState] = None,
               batch: Tuple[int, ...] = (),
               device: Optional[torch.device] = None) -> "Subarray":
        if device is None and data:
            device = as_words(next(iter(data.values()))).device
        shape = batch + (row_words,)
        zeros = torch.zeros(shape, dtype=WORD_DTYPE, device=device)
        ones = torch.full(shape, -1, dtype=WORD_DTYPE, device=device)
        rows: RowState = {
            "T0": zeros, "T1": zeros, "T2": zeros, "T3": zeros,
            "DCC0": zeros, "DCC1": zeros,
            "C0": zeros, "C1": ones,
        }
        if data:
            for k, v in data.items():
                rows[k] = as_words(v, device)
        return cls(rows=rows, row_words=row_words)

    # -- micro-op semantics -------------------------------------------------

    def run(self, program: Program) -> "Subarray":
        """Execute a program; returns the post-state (functional)."""
        rows = dict(self.rows)
        sense: Optional[torch.Tensor] = None  # latched bitline, None = precharged

        for op in program.micro_ops():
            if isinstance(op, Precharge):
                sense = None
                continue
            assert isinstance(op, Activate)
            wls = resolve(op.addr)
            for r, _ in wls:
                if r not in rows:
                    raise BuddyError(f"activate of unknown row {r!r}")

            if sense is None:
                # First ACTIVATE after precharge: charge sharing + sensing.
                if len(wls) == 2 and self.strict:
                    # Dual addresses (B8-B11) sense two cells: ties are
                    # analog-undefined; hardware only uses them as the second
                    # ACTIVATE of an AAP.
                    raise BuddyError(
                        f"{op.addr} raises 2 wordlines from precharged state; "
                        "majority of 2 is undefined on disagreement")
                # Effective bitline contribution: cells on bitline-bar
                # (n-wordline) contribute their complement.
                vals = [rows[r] if pol == D_WL else ~rows[r] for r, pol in wls]
                if len(vals) == 3:
                    sense = _maj3(*vals)  # TRA (§3.1)
                else:
                    sense = vals[0]
                # Sense amplification restores/overwrites every raised cell
                # with the (polarity-adjusted) result — TRA is destructive.
                for r, pol in wls:
                    rows[r] = sense if pol == D_WL else ~sense
            else:
                # Second ACTIVATE while the bank is active (split decoder,
                # §5.3): the sense amps force the raised cells to the
                # already-latched result.
                for r, pol in wls:
                    rows[r] = sense if pol == D_WL else ~sense

        return Subarray(rows=rows, row_words=self.row_words, strict=self.strict)

    # -- convenience --------------------------------------------------------

    def read(self, addr: str) -> torch.Tensor:
        return self.rows[addr]

    def write(self, addr: str, value) -> "Subarray":
        rows = dict(self.rows)
        rows[addr] = as_words(value)
        return Subarray(rows=rows, row_words=self.row_words, strict=self.strict)


def _check_outputs(outputs: List[str], available, program: Program) -> None:
    """Outputs must name rows the execution produces — not a bare KeyError."""
    missing = [k for k in outputs if k not in available]
    if missing:
        from repro_torch.core import lowering

        produced = lowering.lower(program).writes
        raise BuddyError(
            f"outputs {missing} are never written and not present in the "
            f"input data; the program writes rows {list(produced)}")


def execute(program: Program, data: RowState, row_words: Optional[int] = None,
            outputs: Optional[List[str]] = None, n_banks: int = 1,
            n_chips: int = 1, lowered: bool = True,
            backend: str = "cuda", device=None) -> RowState:
    """One-shot helper: run `program` over `data` rows, return named rows.

    Rows referenced by the program but missing from `data` (e.g. destination
    or temp rows) are implicitly created as zero rows.

    By default the program is compiled to a `core.lowering.LoweredProgram`
    and executed by the opcode-table VM wrapper (`kernels.vm`): the CUDA
    kernel for tensors on the card, its plain PyTorch loop for tensors on
    the CPU. ``backend="torch"`` asks for the plain loop and raises for
    tensors on the card (`core.lowering.execute_lowered`).
    ``lowered=False`` runs the micro-op interpreter above (the oracle).

    `n_banks > 1` partitions each operand row word-wise across that many
    independent subarray states and runs the program on all of them in
    one dispatch (`core.bankgroup.execute_banked`) — bit-identical
    results, bank-parallel schedule. `n_chips > 1` additionally spreads
    the slots over a chip cluster (`core.cluster.get_cluster`, lowered VM
    only): ``["cpu"] * n_chips`` for rows on the host, the first
    `n_chips` cards for rows on a card — still bit-identical.
    Tensor rows keep their device; host arrays go to ``device`` (default
    ``"cuda"``, see `repro_torch._device.operand_device`).

    Executions are wall-clock spans when a tracing `repro_torch.obs.Telemetry`
    is installed process-wide (`set_telemetry`; the scheduler does so per
    batch) or a profiler runs — otherwise one flag test.
    """
    tel = get_telemetry()
    if tel.spans_on():
        with tel.span("engine.execute", n_aaps=program.n_aap,
                      n_banks=n_banks, n_chips=n_chips,
                      backend=backend, lowered=lowered):
            return _execute(program, data, row_words, outputs, n_banks,
                            n_chips, lowered, backend, device)
    return _execute(program, data, row_words, outputs, n_banks, n_chips,
                    lowered, backend, device)


def _execute(program: Program, data: RowState, row_words: Optional[int],
             outputs: Optional[List[str]], n_banks: int, n_chips: int,
             lowered: bool, backend: str, device) -> RowState:
    if n_chips > 1:
        if not lowered:
            raise ValueError(
                "n_chips > 1 dispatches through the lowered VM; the "
                "micro-op interpreter is single-process (lowered=False)")
        if row_words is not None:
            raise ValueError(
                "row_words cannot be overridden with n_chips > 1: the "
                "sharded layout derives per-slot widths from the data rows")
    dev = operand_device(data.values(), device)
    data = {k: as_words(v, dev) for k, v in data.items()}
    if n_chips > 1:
        from repro_torch.core import cluster

        cl = cluster.get_cluster(n_chips, n_banks, device=dev)
        return cl.execute(program, data, outputs, backend=backend)
    if n_banks > 1:
        from repro_torch.core import bankgroup

        return bankgroup.execute_banked(program, data, n_banks, outputs,
                                        lowered=lowered, backend=backend)
    if lowered:
        from repro_torch.core import lowering

        lp = lowering.lower(program)
        if outputs is not None:
            _check_outputs(outputs, set(lp.row_names) | set(data), program)
        return lowering.execute_lowered(lp, data, row_words, outputs,
                                        backend=backend)
    sample = next(iter(data.values()))
    if row_words is None:
        row_words = sample.shape[-1]
    batch = tuple(sample.shape[:-1])
    full: RowState = dict(data)
    for addr in program.activates():
        for r, _ in resolve(addr):
            if r not in full and r not in addressing.B_GROUP_ROWS \
                    and r not in addressing.C_GROUP_ROWS:
                full[r] = torch.zeros(batch + (row_words,), dtype=WORD_DTYPE,
                                      device=sample.device)
    sub = Subarray.create(row_words, full, batch=batch, device=sample.device)
    out = sub.run(program)
    if outputs is None:
        return out.rows
    _check_outputs(outputs, out.rows, program)
    return {k: out.rows[k] for k in outputs}
