"""Multi-bank parallel execution of AAP programs (paper §1, §5.4, §7).

A Buddy operation is contained entirely inside one subarray, so every bank
(and every subarray within a bank) can run its own program concurrently —
this internal parallelism is where the paper's 10.9x-25.6x 4-bank numbers
come from. This module is the software seam for that scaling lever:

  * `BankGroup` holds N independent subarray states as one row dict in
    which every named row gains a leading bank axis, and runs a compiled
    program on all banks at once: the bank axis is a leading batch axis
    of the lowered VM's plane (or of the micro-op interpreter's rows), the
    SIMD-across-banks shape of the hardware.
  * `shard_words` / `unshard_words` partition a bulk operand's words
    across banks (zero pad to a multiple of the bank count) and
    reassemble results.
  * `pipeline_latency_ns` models the controller schedule: per-block operand
    placement ("inter-bank copy" over the shared internal bus, serialized)
    overlapped with per-bank AAP compute (parallel) — a classic software
    pipeline whose makespan is reported for 1 vs N banks.

Tensor rows keep their device; host arrays go to ``device`` (default
``"cuda"``), as in `core.engine`. The functional result of banked execution is bit-identical
to single-bank execution; only the schedule differs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch._device import operand_device
from repro_torch.core import addressing
from repro_torch.core.bitplane import WORD_DTYPE, as_words
from repro_torch.core.commands import Program
from repro_torch.core.engine import RowState, Subarray
from repro_torch.core.timing import DDR3_1600, DramTiming, program_latency_ns
from repro_torch.obs.telemetry import get_telemetry


def shard_words(x, n_banks: int, device=None) -> torch.Tensor:
    """Split a (..., W) operand into per-bank word slices: (B, ..., W/B).

    W is zero-padded up to a multiple of `n_banks` — zero words are inert
    for every bitwise program and `unshard_words` strips them back off.
    The result is contiguous (bank ``k``'s words are one run). A tensor
    keeps its device; a host array goes to ``device`` (default ``"cuda"``).
    """
    if n_banks < 1:
        raise ValueError(f"n_banks must be >= 1, got {n_banks}")
    x = as_words(x, operand_device([x], device))
    pad = (-x.shape[-1]) % n_banks
    if pad:
        x = F.pad(x, (0, pad))
    per = x.shape[-1] // n_banks
    split = x.reshape(x.shape[:-1] + (n_banks, per))
    # bank axis leads: (B, ..., W/B)
    return split.movedim(-2, 0).contiguous()


def unshard_words(x: torch.Tensor, n_words: int) -> torch.Tensor:
    """Inverse of `shard_words`: (B, ..., W/B) -> (..., n_words)."""
    merged = x.movedim(0, -2)
    flat = merged.reshape(merged.shape[:-2] + (-1,))
    return flat[..., :n_words]


def _bank_aligned(rows: RowState) -> RowState:
    """Give every row the full rank, with singleton dims after the bank
    axis: the built-in rows are (B, W) while batched operands may be
    (B, ..., W), and right-aligned broadcasting would pair the bank axis
    with a batch axis (per bank, the reference's `vmap` broadcasts
    ``(W,)`` against ``(..., W)`` instead)."""
    ndim = max(v.dim() for v in rows.values())
    return {k: (v if v.dim() == ndim else
                v.reshape(v.shape[:1] + (1,) * (ndim - v.dim())
                          + v.shape[1:]))
            for k, v in rows.items()}


@dataclasses.dataclass
class BankGroup:
    """N subarrays (one per bank) as a single stacked row state.

    `rows[name]` has shape (n_banks, ..., row_words): bank b's subarray is
    the slice `rows[name][b]`. All banks share one program counter — the
    memory controller broadcasts the same AAP sequence and each bank applies
    it to its own data (how bulk ops actually scale across banks; per-bank
    distinct programs would just be a second `BankGroup`).
    """

    rows: RowState
    n_banks: int
    row_words: int

    @classmethod
    def create(cls, n_banks: int, row_words: int,
               data: Optional[RowState] = None,
               device=None) -> "BankGroup":
        """Build a group whose per-bank rows are already bank-sliced.

        `data` values must carry the leading bank axis (use `shard_words`
        to produce them from flat operands). The group lives on the data
        tensors' device; host data, or no data, goes to ``device``
        (default ``"cuda"``).
        """
        data = data or {}
        dev = operand_device(data.values(), device)
        words = {k: as_words(v, dev) for k, v in data.items()}
        sub = Subarray.create(row_words, None, batch=(n_banks,), device=dev)
        rows = dict(sub.rows)
        for k, v in words.items():
            if v.shape[0] != n_banks:
                raise ValueError(
                    f"row {k!r}: leading axis {v.shape[0]} != n_banks "
                    f"{n_banks}; shard operands with shard_words()")
            rows[k] = v
        return cls(rows=rows, n_banks=n_banks, row_words=row_words)

    @classmethod
    def from_flat(cls, n_banks: int, data: RowState,
                  device=None) -> "BankGroup":
        """Partition flat (..., W) operand rows across banks and build
        (devices as in `create`)."""
        dev = operand_device(data.values(), device)
        sharded = {k: shard_words(v, n_banks, dev) for k, v in data.items()}
        row_words = next(iter(sharded.values())).shape[-1]
        return cls.create(n_banks, row_words, sharded, dev)

    def run(self, program: Program, lowered: bool = True,
            backend: str = "cuda") -> "BankGroup":
        """Execute one program on every bank concurrently.

        D-group rows the program references but no bank holds yet
        (destinations, temps) are created as zero rows, as in
        `engine.execute`.

        With ``lowered=True`` (default) the program is compiled once to a
        `core.lowering.LoweredProgram` and the banks execute as ONE plane
        ``(n_banks * ..., rows, row_words)`` through the VM wrapper (the
        CUDA kernel on the card, its plain loop on the CPU) — the bank
        axis is just a batch axis of the plane. ``lowered=False`` runs the
        micro-op interpreter (the oracle) with the bank axis as a leading
        batch axis of every row.
        """
        if lowered:
            from repro_torch.core import lowering

            lp = lowering.lower(program)
            out = lowering.execute_lowered(
                lp, _bank_aligned(self.rows), row_words=self.row_words,
                backend=backend)
            rows = dict(self.rows)
            written = set(lp.writes)
            for name, v in out.items():
                if name in written or name not in rows:
                    rows[name] = v
            return BankGroup(rows=rows, n_banks=self.n_banks,
                             row_words=self.row_words)
        stacked = _bank_aligned(self.rows)
        # the widest row shape wins: batched operands are (B, ..., W) while
        # the built-in B/C rows are (B, 1, ..., W)
        shape = torch.broadcast_shapes(*(v.shape for v in stacked.values()))
        device = next(iter(stacked.values())).device
        for a in program.activates():
            for r, _ in addressing.resolve(a):
                if r not in stacked:
                    stacked[r] = torch.zeros(shape, dtype=WORD_DTYPE,
                                             device=device)
        sub = Subarray(rows=stacked, row_words=self.row_words)
        return BankGroup(rows=sub.run(program).rows, n_banks=self.n_banks,
                         row_words=self.row_words)

    def read(self, addr: str) -> torch.Tensor:
        """Per-bank view of a row: (n_banks, ..., row_words)."""
        return self.rows[addr]

    def gather(self, addr: str, n_words: Optional[int] = None
               ) -> torch.Tensor:
        """Reassemble a row's bank slices into one flat (..., W) vector."""
        v = self.rows[addr]
        if n_words is None:
            n_words = v.shape[0] * v.shape[-1]
        return unshard_words(v, n_words)


def execute_banked(program: Program, data: RowState, n_banks: int,
                   outputs: Optional[List[str]] = None,
                   lowered: bool = True, backend: str = "cuda",
                   reduce: Optional[str] = None,
                   mask=None, device=None) -> RowState:
    """Bank-parallel analog of `engine.execute`.

    Flat (..., W) operand rows are partitioned word-wise across `n_banks`
    banks, the program runs on all banks in one dispatch (the lowered VM by
    default — the bank axis is a batch axis of the plane — or the
    micro-op interpreter with ``lowered=False``), and the requested output
    rows come back reassembled to their original width. Bit-identical to
    `engine.execute(program, data)` for every program and backend.

    ``reduce="popcount"`` (lowered only) requests the fused count epilogue
    instead: each output maps to its total popcount across all banks —
    computed per bank inside the VM launch and summed over the bank axis,
    so no output plane is ever gathered. ``mask`` optionally ANDs a
    per-word ``(W,)`` mask first; the word padding `shard_words` adds is
    always masked off, so programs that drive pad words to 1 never
    miscount. ``reduce="aggregate"`` returns the weighted sum
    ``sum_j 2**j * popcount(OUT_j)`` over the outputs instead.

    Tensor rows (and ``mask``) keep their device; host arrays go to
    ``device`` (default ``"cuda"``).

    A wall-clock span when a tracing telemetry is installed process-wide
    (`repro_torch.obs.set_telemetry`) or a profiler runs; otherwise one
    flag test.
    """
    tel = get_telemetry()
    if tel.spans_on():
        with tel.span("bankgroup.execute", n_banks=n_banks,
                      n_aaps=program.n_aap, backend=backend,
                      lowered=lowered):
            return _execute_banked(program, data, n_banks, outputs,
                                   lowered, backend, reduce, mask, device)
    return _execute_banked(program, data, n_banks, outputs, lowered, backend,
                           reduce, mask, device)


def _execute_banked(program: Program, data: RowState, n_banks: int,
                    outputs: Optional[List[str]], lowered: bool,
                    backend: str, reduce: Optional[str], mask,
                    device) -> RowState:
    operands = list(data.values()) + ([] if mask is None else [mask])
    dev = operand_device(operands, device)
    words = {k: as_words(v, dev) for k, v in data.items()}
    n_words = next(iter(words.values())).shape[-1]
    sharded = {k: shard_words(v, n_banks) for k, v in words.items()}
    sample = next(iter(sharded.values()))
    row_words = sample.shape[-1]
    if reduce not in (None, "popcount", "aggregate"):
        raise ValueError(f"unknown reduce mode {reduce!r}")
    if reduce is not None and not lowered:
        raise ValueError("reduce= requires lowered=True (the fused count "
                         "epilogue lives in the lowered VM dispatch)")
    if lowered:
        from repro_torch.core import lowering
        from repro_torch.core.engine import _check_outputs

        lp = lowering.lower(program)
        if outputs is not None:
            _check_outputs(outputs, set(lp.row_names) | set(sharded),
                           program)
        if reduce is not None:
            # per-bank fused counts, then one sum over the bank axis —
            # the pad words shard_words appended carry a zero mask
            base = (torch.full((n_words,), -1, dtype=WORD_DTYPE, device=dev)
                    if mask is None else as_words(mask, dev))
            mask_sh = shard_words(base, n_banks)
            if mask_sh.dim() == 2:     # (B, W/B): align with (B, ..., W/B)
                batch_ndim = max(v.dim() for v in sharded.values()) - 1
                mask_sh = mask_sh.reshape(mask_sh.shape[:1]
                                          + (1,) * (batch_ndim - 1)
                                          + mask_sh.shape[1:])
            counts = lowering.execute_lowered(
                lp, sharded, row_words, outputs, backend=backend,
                reduce="popcount", mask=mask_sh)
            names = outputs if outputs is not None else list(counts)
            totals = {k: counts[k].sum(0) for k in names}
            if reduce == "popcount":
                return totals
            return lowering.weight_counts(
                torch.stack([totals[k] for k in names]))
        out_rows = lowering.execute_lowered(lp, sharded, row_words, outputs,
                                            backend=backend)
        names = outputs if outputs is not None else list(out_rows)
        return {k: unshard_words(out_rows[k], n_words) for k in names}
    group = BankGroup.create(n_banks, row_words, sharded)
    out = group.run(program, lowered=False)  # creates missing dst/temp rows
    if outputs is not None:
        from repro_torch.core.engine import _check_outputs

        _check_outputs(outputs, out.rows, program)
    names = outputs if outputs is not None else list(out.rows)
    return {k: unshard_words(out.rows[k], n_words) for k in names}


# ---------------------------------------------------------------------------
# Controller schedule: overlap inter-bank operand copy with compute
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BankSchedule:
    """Makespan of a bulk op split into row-blocks across banks.

    `copy_ns` is the serialized inter-bank transfer (the shared internal
    bus moves one row-block at a time); `compute_ns` sums per-bank program
    time; `total_ns` is the pipelined makespan with copy overlapped under
    compute of other banks.
    """

    n_blocks: int
    n_banks: int
    copy_ns: float
    compute_ns: float
    total_ns: float

    @property
    def serial_ns(self) -> float:
        """The no-overlap baseline: every block pays copy then compute."""
        return self.copy_ns + self.compute_ns


def partition_blocks(n_blocks: int, n_banks: int) -> List[range]:
    """Round-robin-balanced contiguous assignment of row-blocks to banks."""
    base, extra = divmod(n_blocks, n_banks)
    out: List[range] = []
    start = 0
    for b in range(n_banks):
        size = base + (1 if b < extra else 0)
        out.append(range(start, start + size))
        start += size
    return out


def pipeline_latency_ns(n_blocks: int, n_banks: int, program: Program,
                        timing: DramTiming = DDR3_1600,
                        xfer_ns_per_block: Optional[float] = None
                        ) -> BankSchedule:
    """Event-driven makespan of `n_blocks` row-block ops over `n_banks`.

    Model: placing one row-block's operands in its bank costs one
    inter-bank RowClone-PSM-ish transfer (`xfer_ns_per_block`, default one
    serialized AAP) on the shared bus; the bank then executes the compiled
    program (`program_latency_ns`) independently. Transfers serialize,
    compute overlaps — so N banks hide compute behind the transfer stream
    and the makespan drops from n*(x+c) toward n*x + c.
    """
    if xfer_ns_per_block is None:
        xfer_ns_per_block = timing.aap_ns
    exec_ns = program_latency_ns(program, timing)
    bus_free = 0.0
    bank_free = [0.0] * n_banks
    makespan = 0.0
    for blk in range(n_blocks):
        b = blk % n_banks
        start_xfer = max(bus_free, bank_free[b])
        bus_free = start_xfer + xfer_ns_per_block
        done = bus_free + exec_ns
        bank_free[b] = done
        makespan = max(makespan, done)
    return BankSchedule(
        n_blocks=n_blocks, n_banks=n_banks,
        copy_ns=n_blocks * xfer_ns_per_block,
        compute_ns=n_blocks * exec_ns,
        total_ns=makespan,
    )


def banked_throughput_gbps(n_blocks: int, n_banks: int, program: Program,
                           timing: DramTiming = DDR3_1600) -> float:
    """End-to-end GB/s of output for a multi-block bulk op (Fig. 9 e2e)."""
    sched = pipeline_latency_ns(n_blocks, n_banks, program, timing)
    if sched.total_ns == 0.0:
        return 0.0
    return n_blocks * timing.row_bytes / sched.total_ns
