"""Lowering: AAP `Program` -> register-machine `LoweredProgram` + VM dispatch.

The paper's controller (§7) drives a *dumb sequencer* over a fixed command
encoding. This module is that lowering:

  * row names are resolved to indices in a single **plane tensor** (fixed
    layout: T0..T3, DCC0, DCC1, C0, C1 at indices 0..7, a write sink at 8,
    D-group rows after, in first-reference order), and
  * each AAP/AP command becomes one row of a static ``(n_cmds, 5)`` int32
    **opcode table** ``(kind, src0, src1, src2, aux)`` encoding the full
    activate semantics — n-wordline negation polarity on every source and
    destination, and the destructive write-back of triple-row activation.

The table is identical to the JAX package's (`lower` is a copy of its
lowering pass). It runs through the VM wrapper `kernels.vm.vm_megakernel`,
which launches the CUDA kernel for tensors on the card and runs its plain
PyTorch loop for tensors on the CPU. The plane is built here directly in
the kernel's ``(batch, rows, words)`` layout; both VMs are bit-identical
to the interpreter (`core.engine.Subarray.run`).

Command encoding
----------------

``kind`` packs the sense arity and source polarities:
  bit 0      1 = TRA (3-wordline sense, digital majority), 0 = single sense
  bits 2..4  polarity of src0/src1/src2 (1 = n-wordline: complement feeds
             the bitline)

Single-sense commands replicate src0 into src1/src2 so the VM step computes
``maj3`` unconditionally (``maj3(x, x, x) == x``) — no data-dependent branch.

``aux`` packs the write set:
  bits 0..7   pos mask over fixed rows 0..7: row <- sensed value
  bits 8..15  neg mask over fixed rows 0..7: row <- ~sensed value
  bits 16..   index of the (at most one) D/C-group destination row; the
              sink row when the command writes no D/C row

The destructive first-ACTIVATE restore lands in the masks first and the
second ACTIVATE's targets override them at lowering time, preserving the
interpreter's write order. Single-wordline first activates restore their own
sensed value and are elided as the no-ops they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.addressing import D_WL, resolve
from repro_torch.core.bitplane import WORD_DTYPE, as_words
from repro_torch.core.commands import AAP, AP, Program
from repro_torch.core.engine import BuddyError
from repro_torch.obs.telemetry import get_telemetry

# Fixed plane layout: the 8 B/C-group rows, then the write sink, then
# D-group rows in first-reference order.
FIXED_ROWS: Tuple[str, ...] = ("T0", "T1", "T2", "T3", "DCC0", "DCC1",
                               "C0", "C1")
SINK = "__SINK__"
SINK_IDX = len(FIXED_ROWS)          # 8
N_RESERVED = SINK_IDX + 1           # fixed rows + sink
C1_IDX = FIXED_ROWS.index("C1")

KIND_TRA = 1                        # bit 0 of the kind column

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True, eq=False)
class LoweredProgram:
    """A `Program` compiled to plane indices + a static opcode table.

    ``row_names[i]`` names plane row ``i``; ``table`` is the ``(n_cmds, 5)``
    int32 command stream (see module docstring for the encoding). ``reads``
    are the rows whose initial contents the program observes (they must be
    seeded in the plane); ``writes`` are every row the program ever stores
    to (what `engine.execute` validates ``outputs`` against).
    """

    row_names: Tuple[str, ...]
    table: np.ndarray
    reads: Tuple[str, ...]
    writes: Tuple[str, ...]
    comment: str = ""

    @property
    def n_rows(self) -> int:
        return len(self.row_names)

    @property
    def n_cmds(self) -> int:
        return int(self.table.shape[0])

    def row_index(self, name: str) -> int:
        return self.row_names.index(name)


class LoweringError(BuddyError):
    """Raised at lowering time for analog-undefined command sequences —
    the same sequences `Subarray.run` rejects at run time."""


def _sense_wordlines(addr: str) -> Tuple[Tuple[str, str], ...]:
    wls = resolve(addr)
    if len(wls) == 2:
        # Dual addresses (B8-B11) sense two cells from precharged state:
        # majority of 2 is analog-undefined on disagreement — the
        # interpreter raises at run time, the lowerer at compile time.
        raise LoweringError(
            f"{addr} raises 2 wordlines from precharged state; "
            "majority of 2 is undefined on disagreement")
    return wls


def lower(program: Program) -> LoweredProgram:
    """Compile a `Program` into a `LoweredProgram` (memoized on commands)."""
    key = tuple(program.commands)
    cached = _LOWER_CACHE.get(key)
    if cached is not None:
        return cached
    lp = _lower_uncached(program)
    if len(_LOWER_CACHE) > 512:
        _LOWER_CACHE.clear()
    _LOWER_CACHE[key] = lp
    return lp


_LOWER_CACHE: Dict[Tuple, LoweredProgram] = {}


def _lower_uncached(program: Program) -> LoweredProgram:
    names: List[str] = list(FIXED_ROWS) + [SINK]
    index: Dict[str, int] = {n: i for i, n in enumerate(names)}

    def idx_of(row: str) -> int:
        if row not in index:
            index[row] = len(names)
            names.append(row)
        return index[row]

    rows_table: List[Tuple[int, int, int, int, int]] = []
    written: set = set()
    reads: List[str] = []

    def note_read(row: str) -> None:
        if row not in written and row not in reads:
            reads.append(row)

    for cmd in program.commands:
        if isinstance(cmd, AAP):
            addr1, addr2 = cmd.addr1, cmd.addr2
        else:
            assert isinstance(cmd, AP), cmd
            addr1, addr2 = cmd.addr, None
        wls = _sense_wordlines(addr1)

        # sources: polarity-adjusted sensed cells; single sense replicates
        # src0 so maj3(s0, s0, s0) == s0 needs no branch in the VM step
        srcs = [(idx_of(r), pol != D_WL) for r, pol in wls]
        for r, _ in wls:
            note_read(r)
        if len(srcs) == 1:
            srcs = srcs * 3
        kind = (KIND_TRA if len(wls) == 3 else 0) \
            | (srcs[0][1] << 2) | (srcs[1][1] << 3) | (srcs[2][1] << 4)

        # write set: the restore of a multi-wordline first ACTIVATE is
        # destructive (TRA); a single-wordline restore rewrites the value
        # it just sensed and is elided. The second ACTIVATE's targets are
        # forced to the latched result and override on overlap.
        write_pol: Dict[str, bool] = {}
        if len(wls) > 1:
            for r, pol in wls:
                write_pol[r] = pol != D_WL
        if addr2 is not None:
            for r, pol in resolve(addr2):
                write_pol[r] = pol != D_WL
        pos_mask = neg_mask = 0
        dst_idx = SINK_IDX
        for r, negated in write_pol.items():
            written.add(r)
            i = idx_of(r)
            if i < len(FIXED_ROWS):
                if negated:
                    neg_mask |= 1 << i
                else:
                    pos_mask |= 1 << i
            else:
                # D/C-group addresses raise exactly one d-wordline, so at
                # most one non-fixed destination exists per command
                assert dst_idx == SINK_IDX and not negated, (r, cmd)
                dst_idx = i
        aux = (dst_idx << 16) | (neg_mask << 8) | pos_mask
        rows_table.append((kind, srcs[0][0], srcs[1][0], srcs[2][0], aux))

    table = np.asarray(rows_table, dtype=np.int32).reshape(-1, 5)
    return LoweredProgram(
        row_names=tuple(names), table=table, reads=tuple(reads),
        writes=tuple(sorted(written)), comment=program.comment)


# ---------------------------------------------------------------------------
# One-shot lowered execution (the engine's default path)
# ---------------------------------------------------------------------------


def _coalesce(idx: Tuple[int, ...]) -> Tuple[Tuple[int, int], ...]:
    """Consecutive index runs -> (start, stop) slices (order-preserving)."""
    runs: List[Tuple[int, int]] = []
    for i in idx:
        if runs and runs[-1][1] == i:
            runs[-1] = (runs[-1][0], i + 1)
        else:
            runs.append((i, i + 1))
    return tuple(runs)


@dataclasses.dataclass(frozen=True, eq=False)
class _Layout:
    """A lowered program re-laid-out for one (data rows, outputs) binding.

    Plane rows are renumbered so the seeded data rows form one contiguous
    block right after the reserved rows and the output rows coalesce into
    as few contiguous runs as possible. The plane handed to the VM is then
    just the stacked data rows: the reserved rows start in their reset
    state and every row after the data block starts zero, so neither is
    built or copied.
    """

    table: np.ndarray               # opcode table over renumbered rows
    val_names: Tuple[str, ...]      # data rows, in plane-block order
    out_runs: Tuple[Tuple[int, int], ...]   # coalesced output row slices
    out_names: Tuple[str, ...]
    n_rows: int

    @property
    def out_idx(self) -> Tuple[int, ...]:
        return tuple(i for a, b in self.out_runs for i in range(a, b))


_LAYOUT_CACHE: Dict[Tuple, Tuple[LoweredProgram, _Layout]] = {}


def _layout(lp: LoweredProgram, data_names: Tuple[str, ...],
            outputs: Optional[Tuple[str, ...]]) -> _Layout:
    key = (id(lp), data_names, outputs)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None and hit[0] is lp:
        return hit[1]
    index = {n: i for i, n in enumerate(lp.row_names)}
    present = set(data_names)
    seeded = [n for n in lp.row_names[N_RESERVED:] if n in present]
    out_names = (tuple(o for o in outputs if o in index)
                 if outputs is not None
                 else tuple(n for n in lp.row_names if n != SINK))
    # renumber: reserved rows keep indices 0..8 (the fixed-row write masks
    # and the sink are hard-coded there), data rows next, then output rows
    # not already seeded, then the rest
    order = list(range(N_RESERVED))
    order += [index[n] for n in seeded]
    taken = set(order)
    for o in out_names:
        if index[o] not in taken:
            order.append(index[o])
            taken.add(index[o])
    order += [i for i in range(lp.n_rows) if i not in taken]
    remap = np.empty(lp.n_rows, dtype=np.int32)
    remap[np.asarray(order, dtype=np.int32)] = np.arange(lp.n_rows,
                                                         dtype=np.int32)
    table = lp.table.copy()
    table[:, 1:4] = remap[table[:, 1:4]]
    aux = table[:, 4]
    table[:, 4] = (remap[aux >> 16] << 16) | (aux & 0xFFFF)
    layout = _Layout(
        table=table, val_names=tuple(seeded),
        out_runs=_coalesce(tuple(int(remap[index[o]]) for o in out_names)),
        out_names=out_names, n_rows=lp.n_rows)
    if len(_LAYOUT_CACHE) > 1024:
        _LAYOUT_CACHE.clear()
    _LAYOUT_CACHE[key] = (lp, layout)
    return layout


# ---------------------------------------------------------------------------
# Plane tensor construction / readout
# ---------------------------------------------------------------------------


def make_plane(lp: LoweredProgram, data: Optional[Dict[str, object]],
               row_words: int, batch: Tuple[int, ...] = (),
               device=None) -> torch.Tensor:
    """Build the ``(n_rows,) + batch + (row_words,)`` int32 plane tensor
    (the reference's uint32 bit patterns).

    C1 is pre-initialized to all-ones (paper §3.5); every other row not
    present in ``data`` starts zero, matching `engine.Subarray.create`.
    Each row of ``data`` broadcasts to ``batch + (row_words,)``. The plane
    lies on the rows' device (`_device.operand_device`: host arrays go to
    ``device``, default ``"cuda"``).
    """
    from repro_torch._device import operand_device

    data = data or {}
    dev = operand_device(list(data.values()), device)
    shape = tuple(batch) + (row_words,)
    plane = torch.zeros((lp.n_rows,) + shape, dtype=WORD_DTYPE, device=dev)
    plane[C1_IDX] = -1
    for i, name in enumerate(lp.row_names):
        if name in data:
            plane[i] = as_words(data[name], dev).expand(shape)
    return plane


def read_rows(lp: LoweredProgram, plane: torch.Tensor,
              names: List[str]) -> Dict[str, torch.Tensor]:
    """The named rows of a ``(n_rows, ...)`` plane (views)."""
    return {n: plane[lp.row_index(n)] for n in names}


def weight_counts(counts: torch.Tensor) -> torch.Tensor:
    """``sum_j 2**j * counts[j]`` over the leading plane axis, in float32.

    Exact-big-integer consumers weight ``reduce="popcount"`` counts on the
    host with Python ints instead (see `service.scheduler`)."""
    n_out = counts.shape[0]
    weights = torch.tensor([float(1 << j) for j in range(n_out)],
                           dtype=torch.float32, device=counts.device)
    weights = weights.reshape((n_out,) + (1,) * (counts.dim() - 1))
    return (counts.to(torch.float32) * weights).sum(0)


def _flat_errors(errors, n_cmds: int, batch: Tuple[int, ...], row_words: int,
                 device: torch.device) -> torch.Tensor:
    """``(n_cmds, 4[, *batch], words)`` fault masks -> ``(B, 4*n_cmds, W)``."""
    e = as_words(errors, device)
    target = (n_cmds, 4) + batch + (row_words,)
    if tuple(e.shape) != target:    # un-batched masks broadcast per query
        e = e.reshape(tuple(e.shape[:2]) + (1,) * (len(target) - e.dim())
                      + tuple(e.shape[2:])).expand(target)
    return e.movedim((0, 1), (-3, -2)).reshape(-1, 4 * n_cmds, row_words)


def _flat_mask(mask, batch: Tuple[int, ...], row_words: int,
               device: torch.device) -> torch.Tensor:
    """A per-word mask of shape ``(W,)`` / ``(1, W)`` / ``batch + (W,)``
    -> ``(1, W)`` shared or ``(B, W)`` per batch."""
    m = as_words(mask, device)
    if m.shape[-1] != row_words:
        raise ValueError(
            f"mask word axis {m.shape[-1]} != plane words {row_words}")
    if all(d == 1 for d in m.shape[:-1]):
        return m.reshape(1, row_words)
    return m.expand(batch + (row_words,)).reshape(-1, row_words)


@dataclasses.dataclass(frozen=True)
class VmCall:
    """One VM launch's arguments, in the kernel's ``(B, rows, W)`` layout.

    ``plane`` stacks the data rows in the `_Layout`'s block order. Rows
    below ``first_row`` start in the reset state (C1 all-ones, the rest
    zero) and rows past the data block start zero, so only seeded reserved
    rows (rare) make the reserved block part of the plane.
    """

    lay: _Layout
    plane: torch.Tensor
    first_row: int
    errors: Optional[torch.Tensor]   # (B, 4 * n_cmds, W)
    mask: Optional[torch.Tensor]     # (1 | B, W)
    batch: Tuple[int, ...]
    row_words: int

    def run(self, vm_fn, reduce: Optional[str] = None) -> torch.Tensor:
        """``vm_fn`` (`kernels.vm.vm_megakernel` or `vm_plain`) on these
        arguments: ``(B, n_out, W)`` rows, or ``(B, n_out)`` counts.

        Every VM launch passes here: with a metering telemetry published
        (`obs.set_telemetry`) it counts ``vm_launches_total`` and
        ``vm_bytes_total``, the stacked plane read plus what the launch
        writes (the rows, or the counts of the fused popcount)."""
        if not self.lay.out_idx:
            shape = (self.plane.shape[0], 0) + (
                () if reduce else (self.row_words,))
            return torch.zeros(shape, dtype=WORD_DTYPE,
                               device=self.plane.device)
        out = vm_fn(self.lay.table, self.plane, self.lay.out_idx,
                    n_rows=self.lay.n_rows, first_row=self.first_row,
                    errors=self.errors, reduce=reduce, mask=self.mask)
        tel = get_telemetry()
        if tel.metering:
            m = tel.metrics
            m.counter("vm_launches_total").inc()
            m.counter("vm_bytes_total").inc(
                self.plane.numel() * self.plane.element_size()
                + out.numel() * out.element_size())
        return out


def _is_row_list(v) -> bool:
    return isinstance(v, (list, tuple))


def _as_rows(v) -> torch.Tensor:
    """A named row as one tensor (a per-batch row list is stacked)."""
    return torch.stack([as_words(r) for r in v]) if _is_row_list(v) \
        else as_words(v)


def vm_call(lp: LoweredProgram, data: Dict[str, object],
            row_words: Optional[int] = None,
            outputs: Optional[List[str]] = None,
            errors=None, mask=None) -> VmCall:
    """Lay a program's named rows out as VM arguments (see
    `execute_lowered` for the meaning of every argument).

    A row of ``data`` may also be a list of ``(W,)`` rows, one per batch
    slice (the scheduler's per-query operands); each is then copied once,
    straight into the plane, with no intermediate stacked tensor."""
    words = {k: ([as_words(r) for r in v] if _is_row_list(v)
                 else as_words(v)) for k, v in data.items()}
    shapes = []
    for k, v in words.items():
        if _is_row_list(v):
            if not v or any(r.dim() != 1 for r in v):
                raise ValueError(f"row list {k!r} must hold (W,) rows")
            shapes.append((len(v),) + tuple(v[0].shape))
        else:
            shapes.append(tuple(v.shape))
    sample = next(iter(words.values()))
    device = (sample[0] if _is_row_list(sample) else sample).device
    # the plane's batch shape is the broadcast of every row's batch shape
    # (right-aligned, like the interpreter's per-op broadcasting): batched
    # operands may be (..., X, W) while other rows are (W,)
    if row_words is None:
        row_words = int(max(s[-1] for s in shapes))
    batch = tuple(np.broadcast_shapes(*(s[:-1] for s in shapes)))
    n_batch = math.prod(batch)
    lay = _layout(lp, tuple(sorted(data)),
                  tuple(outputs) if outputs is not None else None)
    shape = batch + (row_words,)

    for k, v in words.items():
        if _is_row_list(v) and len(v) != n_batch:
            raise ValueError(f"row list {k!r} holds {len(v)} rows, the "
                             f"batch is {n_batch}")

    def flat(name: str):
        """``(n_batch, W)`` rows: a tensor view, or the per-batch list."""
        v = words[name]
        if _is_row_list(v):
            return v
        return v.expand(shape).reshape(n_batch, row_words)

    seeded_fixed = tuple(n for n in FIXED_ROWS if n in data)
    rows = [flat(k) for k in lay.val_names]
    first_row = N_RESERVED
    if seeded_fixed:
        head = torch.zeros((n_batch, N_RESERVED, row_words),
                           dtype=WORD_DTYPE, device=device)
        head[:, C1_IDX] = -1
        for n in seeded_fixed:
            head[:, FIXED_ROWS.index(n)] = _as_rows(flat(n))
        rows = list(head.unbind(1)) + rows
        first_row = 0
    if not rows:
        plane = torch.empty((n_batch, 0, row_words), dtype=WORD_DTYPE,
                            device=device)
    elif any(_is_row_list(r) for r in rows):
        # one copy of every (W,) row, batch-major, into the plane
        plane = torch.stack([r[b] for b in range(n_batch) for r in rows]
                            ).view(n_batch, len(rows), row_words)
    else:
        plane = torch.stack(rows, dim=1)
    return VmCall(
        lay=lay, plane=plane, first_row=first_row,
        errors=(None if errors is None else
                _flat_errors(errors, lp.n_cmds, batch, row_words, device)),
        mask=(None if mask is None else
              _flat_mask(mask, batch, row_words, device)),
        batch=batch, row_words=row_words)


def execute_lowered(lp: LoweredProgram, data: Dict[str, object],
                    row_words: Optional[int] = None,
                    outputs: Optional[List[str]] = None,
                    backend: str = "cuda",
                    errors=None,
                    reduce: Optional[str] = None,
                    mask=None):
    """Run a lowered program over named rows; returns named rows.

    Mirrors `engine.execute`: rows the program references but ``data`` does
    not provide are implicitly zero; rows in ``data`` the program never
    touches pass through unchanged; with ``outputs=None`` the returned dict
    covers exactly the rows the interpreter would return. Every row of
    ``data`` must lie on one device; the VM runs there, always through
    the wrapper `kernels.vm.vm_megakernel`: the CUDA kernel on the card,
    its plain PyTorch loop on the CPU. ``backend`` names what the caller
    expects: ``"cuda"`` (the default) either of them, ``"torch"`` the
    plain loop, which serves CPU tensors only and raises for tensors on
    the card, where the main path never runs the plain version.

    ``errors`` injects TRA fault masks (shape
    ``(n_cmds, 4[, *batch], row_words)``, as `repro.core.errors`
    produces them) at compute time; masks are indexed by command position,
    so the `_Layout` row renumbering never changes where a fault lands.

    ``reduce`` requests the fused count epilogue instead of output rows:
      * ``"popcount"`` — the dict maps each output name to its per-plane
        int32 popcount (shape ``batch``); on the CUDA kernel NO output
        plane is written to device memory.
      * ``"aggregate"`` — returns (not a dict) the ``batch``-shaped
        float32 ``sum_j 2**j * popcount(OUT_j)`` over the requested
        outputs in order (`weight_counts`).
    ``mask`` (reduce modes only) ANDs a per-word mask into every counted
    row before popcounting — the catalog tail mask, or any shape
    broadcastable against the output rows.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown lowered backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if reduce not in (None, "popcount", "aggregate"):
        raise ValueError(f"unknown reduce mode {reduce!r}")
    if mask is not None and reduce is None:
        raise ValueError("mask= is only meaningful with a reduce mode")
    from repro_torch.kernels import vm

    call = vm_call(lp, data, row_words, outputs, errors, mask)
    if backend == "torch" and call.plane.device.type != "cpu":
        raise ValueError(
            f"backend='torch' is the plain VM for CPU tensors; on "
            f"{call.plane.device} the VM runs as the CUDA kernel "
            "(backend='cuda')")
    out = call.run(vm.vm_megakernel, None if reduce is None else "popcount")
    n_out, batch = len(call.lay.out_idx), call.batch
    if reduce is None:
        out_rows = out.movedim(1, 0).reshape(
            (n_out,) + batch + (call.row_words,))
    else:
        out_rows = out.movedim(1, 0).reshape((n_out,) + batch)
        if reduce == "aggregate":
            return weight_counts(out_rows)   # (batch,) float32 weighted sum
    result = {o: out_rows[k] for k, o in enumerate(call.lay.out_names)}
    passthrough = outputs if outputs is not None else data
    for name in passthrough:
        if name not in result and name in data:
            row = _as_rows(data[name])
            if reduce == "popcount":
                # count passthrough rows the same way the VM epilogue
                # counts written rows (rare: a requested output the
                # program never writes)
                from repro_torch.ops.popcount import popcount_words

                row = popcount_words(
                    row if mask is None else row & as_words(mask, row.device),
                    axis=-1)
            result[name] = row
    return result
