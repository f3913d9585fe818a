"""Opcode-table VM: a whole lowered program in one kernel launch.

Port of the Pallas megakernel `repro.kernels.vm._vm_call` (body
`_vm_kernel`). `vm_megakernel` launches ``csrc/vm.cu`` for CUDA tensors;
`vm_plain` beside it is the same function in plain PyTorch — the CPU
path, the ``"torch"`` lowered backend, and the oracle the kernel is held
to on the card.

Both take the plane in the kernel's layout: ``plane`` is
``(B, n_in, W)`` int32 and holds plane rows ``first_row .. first_row +
n_in - 1`` of every batch slice. Rows below ``first_row`` start in the
subarray's reset state (C1 all-ones, every other row zero) and rows past
the given block start zero, so the caller builds only the rows it seeds
(`core.lowering.execute_lowered` passes the stacked operands with
``first_row=9``). Per command: sense ``maj3(src ^ polarity)``, optionally
XOR one of the four TRA fault-class masks in, then write fixed rows 0-7
through the pos/neg masks and one D/C row (`core.lowering` documents the
encoding).

Epilogues (``reduce``):
  * ``None`` — the output rows, ``(B, n_out, W)`` int32;
  * ``"popcount"`` — per-row popcounts of ``row & mask``, ``(B, n_out)``
    int32; the kernel never writes the output rows to device memory.
``errors`` is ``(B, 4 * n_cmds, W)``: rows ``4i .. 4i+3`` are command i's
fault masks. ``mask`` is ``(1, W)`` (shared) or ``(B, W)`` (per batch).

The kernel does not walk the raw table: `program` pre-decodes it once per
plan (`decode`: constants folded, register forwarding, dead writes and
commands dropped, rows renumbered into the shared slots a tile needs),
picks the block shape (`block_cols`) and keeps the encoded words
(`encode`) on the device.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.ops.popcount import popcount_u32

N_FIXED = 8                 # fixed rows T0..T3, DCC0, DCC1, C0, C1
C1_ROW = 7
REDUCE_MODES = (None, "popcount")

#: shared memory one thread block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
#: shared memory of one SM (228 KB); each resident block also takes 1 KB
SMEM_PER_SM = 233472
#: block shapes ``(threads, words per thread, blocks that must fit one
#: SM)``, first fit wins. Without fault masks a thread owns two 16-byte
#: quads while two such blocks fit an SM, else one quad (more warps, to
#: hide each command's latency, matter more than fewer instructions on
#: long programs); with masks the kernel streams them, which wants many
#: threads in flight more than wide ones, so a thread owns one word.
BLOCK_SHAPES = {False: ((128, 8, 2), (128, 4, 2), (64, 4, 2), (32, 4, 2),
                        (32, 4, 1), (32, 1, 1)),
                True: ((256, 1, 1), (128, 1, 1), (64, 1, 1), (32, 1, 1))}

# The encoded program's words, shared with csrc/vm.cu (see `encode`). A
# source word is a shared-row word offset, REG (the previous command's
# sensed value), CONST (zero) or DUP (the first source's value), XORed
# with all-ones when POL is set; a write word is an offset and POL. A
# command header holds the command's table row (its fault masks) and its
# write count. REG and DUP occur only with fault masks.
POL = 1 << 31
REG = 1 << 30
CONST = 1 << 29
DUP = 1 << 28
SLOT = DUP - 1
INDEX = (1 << 18) - 1
WRITES_SHIFT = 18


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def block_cols(n_rows: int, prog_ints: int, n_out: int,
               faulty: bool = False) -> Tuple[int, int]:
    """``(threads, words per thread)`` of the first block shape whose
    ``n_rows`` shared rows, program and count slots fit shared memory as
    often per SM as the shape asks; the tile is ``threads x words``
    columns wide."""
    fixed = 4 * (prog_ints + _round4(n_out))
    for threads, words, per_sm in BLOCK_SHAPES[bool(faulty)]:
        smem = fixed + 4 * n_rows * threads * words
        if smem <= SMEM_LIMIT and per_sm * (smem + 1024) <= SMEM_PER_SM:
            return threads, words
    raise ValueError(
        f"a {n_rows}-row plane with a {prog_ints}-word program does not "
        f"fit one thread block's shared memory even at one word a "
        f"thread")


@dataclasses.dataclass(frozen=True)
class Decoded:
    """An opcode table pre-decoded for ``csrc/vm.cu``, slots unscaled.

    ``cmds`` are the commands the kernel runs, each ``(table row, three
    sources, writes)``: a source is ``(kind, slot, polarity)`` with kind S
    (a shared row), R, C or D as above, a write ``(slot, polarity)``.
    ``loads`` are the ``(slot, plane row)`` pairs copied in per tile;
    ``outs`` one source per output row; ``n_slots`` the shared rows a tile
    holds (the count mode's mask row comes after them)."""

    cmds: Tuple[Tuple[int, tuple, Tuple[Tuple[int, int], ...]], ...]
    loads: Tuple[Tuple[int, int], ...]
    outs: Tuple[Tuple[str, int, int], ...]
    n_slots: int

    def _slots(self) -> int:
        return sum(1 + _round4(len(w)) // 4 for _, _, w in self.cmds)

    def prog_ints(self) -> int:
        return (_round4(2 * len(self.loads)) + _round4(len(self.outs))
                + 4 * self._slots())

    def shared_bytes_per_word(self, words: int, masked: bool) -> float:
        """Shared-memory bytes the kernel moves per plane word: every
        async row copy, source and output read and write of a word, the
        mask row's copy and read, and the program's broadcast reads (one
        128-byte wavefront per 16-byte slot and warp, over its
        ``32 x words`` columns)."""
        reads = sum(k == "S" for _, srcs, _ in self.cmds for k, _, _ in srcs)
        writes = sum(len(w) for _, _, w in self.cmds)
        outs = sum(k == "S" for k, _, _ in self.outs)
        return (4.0 * (len(self.loads) + reads + writes + outs
                       + (2 if masked else 0))
                + 128.0 * (self._slots() + len(self.outs) + len(self.loads))
                / (32 * words))


def decode(table: np.ndarray, out_idx: Tuple[int, ...], n_rows: int,
           first_row: int, n_in: int, faulty: bool) -> Decoded:
    """Pre-decode ``table`` for the kernel; bit-identical to `vm_plain`.

    A forward pass tracks what each row holds: a constant (the reset
    state, or a constant sensed value), a seeded row, or a command's
    sensed value, each up to its polarity. A source on a constant becomes
    CONST, the rest read their row. Without fault masks a command whose
    sources are all constant runs nowhere (its writes only change the
    tracked constants), and maj3 with two equal (or complementary)
    sources is the one source it must be (or the third), run as maj3(x,
    0, ~0), and polarities are moved so that only the first source is
    ever inverted. With masks every command senses anew (only three equal
    sources become one, the other two DUP), and a source on the value the
    previous run command sensed becomes REG: the kernel streams the masks
    there and has cycles to spare for the select. A backward pass keeps a
    write only if a later shared read or output reads it, and a command
    only if it keeps a write or the next run command reads its value from
    the register; rows read before any write are the loads.
    """
    const = ("c",)
    state = [(("i", r), 0) if first_row <= r < first_row + n_in
             else (const, int(r == C1_ROW and r < first_row))
             for r in range(n_rows)]
    prev = None                 # what the kernel's register holds
    run = []                    # (j, sources, writes) in order

    def resolve(val, row):
        base, pol = val
        if base == const:
            return ("C", None, pol)
        if faulty and prev is not None and base == prev[0]:
            return ("R", None, pol ^ prev[1])
        return ("S", row, pol ^ state[row][1])

    for j, (kind, a, b, c, aux) in enumerate(np.asarray(table).tolist()):
        rows = (a, b, c)
        vals = [(state[r][0], state[r][1] ^ ((kind >> (2 + k)) & 1))
                for k, r in enumerate(rows)]
        pick = 0 if vals[0] == vals[1] == vals[2] else None
        if pick is None and not faulty:
            for x, y, z in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
                if vals[x][0] == vals[y][0]:
                    pick = x if vals[x][1] == vals[y][1] else z
                    break
        v = (("v", j), 0) if faulty or pick is None else vals[pick]
        writes = {r: 1 if (aux >> 8 >> r) & 1 else 0 for r in range(N_FIXED)
                  if (aux >> r) & 0x101}
        writes[aux >> 16] = 0                  # D/C destination or sink
        if v[0] != const:
            used = range(3) if pick is None else (pick,)
            run.append((j, [resolve(vals[k], rows[k]) for k in used],
                        list(writes.items())))
            prev = v
        for r, p in writes.items():
            state[r] = (v[0], v[1] ^ p)
    outs = [resolve(state[o], o) for o in out_idx]

    live = {s[1] for s in outs if s[0] == "S"}
    need_reg = any(s[0] == "R" for s in outs)
    kept = []
    for j, srcs, writes in reversed(run):
        kw = [(r, p) for r, p in writes if r in live]
        if not kw and not need_reg:
            continue
        live.difference_update(r for r, _ in kw)
        live.update(s[1] for s in srcs if s[0] == "S")
        need_reg = any(s[0] == "R" for s in srcs)
        kept.append((j, srcs, kw))
    kept.reverse()
    assert all(first_row <= r < first_row + n_in for r in live)
    used_rows = set(live) | {s[1] for s in outs if s[0] == "S"}
    for _, srcs, kw in kept:
        used_rows.update(s[1] for s in srcs if s[0] == "S")
        used_rows.update(r for r, _ in kw)
    slot = {r: i for i, r in enumerate(sorted(used_rows))}

    def src(s):
        return (s[0], slot.get(s[1], 0), s[2])

    cmds = []
    for j, srcs, kw in kept:
        srcs = [src(s) for s in srcs]
        if faulty:
            srcs += [("D", 0, 0)] * (3 - len(srcs))
        else:
            srcs += [("C", 0, 0), ("C", 0, 1)] * (len(srcs) == 1)
            # maj3(~a, ~b, ~c) == ~maj3(a, b, c): at most one source
            # inverted, and it first, so the kernel inverts s0 alone
            if sum(p for _, _, p in srcs) >= 2:
                srcs = [(k, sl, 1 - p) for k, sl, p in srcs]
                kw = [(r, 1 - p) for r, p in kw]
            srcs.sort(key=lambda s: -s[2])
        cmds.append((j, tuple(srcs), tuple((slot[r], p) for r, p in kw)))
    return Decoded(
        cmds=tuple(cmds),
        loads=tuple((slot[r], r - first_row) for r in sorted(live)),
        outs=tuple(src(s) for s in outs), n_slots=len(slot))


def encode(dec: Decoded, unit: int) -> np.ndarray:
    """The kernel's int32 program: ``[loads | outs | commands]``, each
    section padded to 16 bytes, every slot scaled to ``unit`` words (a
    tile's width: ``threads x words per thread``). Loads are ``(word
    offset, plane row)`` pairs; a command is a ``[header, s0, s1, s2]``
    slot, then its writes four to a slot."""

    def word(kind, slot, pol):
        return ({"S": slot * unit, "R": REG, "C": CONST, "D": DUP}[kind]
                | (POL if pol else 0))

    out = [x for s, r in dec.loads for x in (s * unit, r)]
    out += [0] * (_round4(len(out)) - len(out))
    out += [word(*s) for s in dec.outs]
    out += [0] * (_round4(len(out)) - len(out))
    for index, srcs, writes in dec.cmds:
        out += [index | len(writes) << WRITES_SHIFT, *(word(*s) for s in srcs)]
        out += [word("S", *w) for w in writes]
        out += [0] * (_round4(len(writes)) - len(writes))
    return np.asarray(out, dtype=np.int64).astype(np.uint32).view(np.int32)


def _check(table: np.ndarray, plane: torch.Tensor, out_idx: Tuple[int, ...],
           n_rows: int, first_row: int, errors, reduce, mask) -> None:
    if reduce not in REDUCE_MODES:
        raise ValueError(f"unknown reduce mode {reduce!r}; "
                         f"expected one of {REDUCE_MODES}")
    if mask is not None and reduce is None:
        raise ValueError("mask= is only meaningful with a reduce mode")
    if plane.dtype != torch.int32 or plane.dim() != 3:
        raise ValueError(f"plane must be (B, rows, W) int32, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    batch, n_in, words = plane.shape
    if first_row < 0 or first_row + n_in > n_rows:
        raise ValueError(f"plane rows {first_row}..{first_row + n_in} "
                         f"exceed the program's {n_rows} rows")
    if table.ndim != 2 or table.shape[1] != 5:
        raise ValueError(f"table must be (n_cmds, 5), got {table.shape}")
    if table.size and (table[:, 1:4].min() < 0
                       or table[:, 1:4].max() >= n_rows
                       or (table[:, 4] >> 16).max() >= n_rows):
        raise ValueError("opcode table indexes rows outside the plane")
    if any(not 0 <= i < n_rows for i in out_idx):
        raise ValueError(f"output rows {out_idx} outside the plane")
    for name, t, shape in (
            ("errors", errors, (batch, 4 * table.shape[0], words)),
            ("mask", mask, (None, words))):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.device != plane.device:
            raise ValueError(f"{name} must be int32 on {plane.device}")
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if mask is not None and mask.shape[0] not in (1, batch):
        raise ValueError(f"mask rows {mask.shape[0]} must be 1 or {batch}")


def vm_plain(table: np.ndarray, plane: torch.Tensor, out_idx: Sequence[int], *,
             n_rows: int, first_row: int = 0,
             errors: Optional[torch.Tensor] = None,
             reduce: Optional[str] = None,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The VM in plain PyTorch: one Python step per command.

    Updates its own full plane in place (it is built here, so no caller
    state is touched); each step reads its sources before any write.
    """
    table = np.asarray(table, dtype=np.int32)
    out_idx = tuple(int(i) for i in out_idx)
    _check(table, plane, out_idx, n_rows, first_row, errors, reduce, mask)
    batch, n_in, words = plane.shape
    full = torch.zeros((batch, n_rows, words), dtype=torch.int32,
                       device=plane.device)
    if first_row > C1_ROW:
        full[:, C1_ROW] = -1
    full[:, first_row:first_row + n_in] = plane
    for i, (kind, a, b, c, aux) in enumerate(table.tolist()):
        s0 = full[:, a] ^ -((kind >> 2) & 1)
        s1 = full[:, b] ^ -((kind >> 3) & 1)
        s2 = full[:, c] ^ -((kind >> 4) & 1)
        v = (s0 & s1) | (s1 & s2) | (s2 & s0)   # == s0 when replicated
        if errors is not None:
            # pattern classes partition the bit positions, so exactly one
            # of the four masks applies per bit
            e = errors[:, 4 * i:4 * i + 4]
            ones3 = s0 & s1 & s2
            lit = s0 | s1 | s2
            v = v ^ ((e[:, 0] & ~lit) | (e[:, 1] & (lit & ~v))
                     | (e[:, 2] & (v & ~ones3)) | (e[:, 3] & ones3))
        pos, neg = aux & 0xFF, (aux >> 8) & 0xFF
        for r in range(N_FIXED):
            if (neg >> r) & 1:
                full[:, r] = ~v
            elif (pos >> r) & 1:
                full[:, r] = v
        full[:, aux >> 16] = v                 # D/C destination or sink
    rows = full[:, list(out_idx)]
    if reduce is None:
        return rows
    if mask is not None:
        rows = rows & mask[:, None, :]
    return popcount_u32(rows).sum(-1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class Program:
    """One launch's decoded program, block shape and device buffer."""

    dec: Decoded
    threads: int
    words: int
    rows: int                   # shared rows of a tile
    buf: torch.Tensor           # `encode`'s int32 words on the device


_PROGRAMS: Dict[Tuple, Program] = {}


def program(table: np.ndarray, out_idx: Tuple[int, ...], n_rows: int,
            first_row: int, n_in: int, faulty: bool, masked: bool,
            device: torch.device) -> Program:
    """`decode`, `block_cols` and `encode` for one launch, the buffer on
    ``device``; cached so a repeated plan costs no decode and no
    host-to-device copy."""
    key = (table.tobytes(), table.shape[0], out_idx, n_rows, first_row,
           n_in, faulty, masked, str(device))
    prog = _PROGRAMS.get(key)
    if prog is None:
        dec = decode(table, out_idx, n_rows, first_row, n_in, faulty)
        rows = dec.n_slots + int(masked)
        threads, words = block_cols(rows, dec.prog_ints(), len(out_idx),
                                    faulty)
        buf = torch.from_numpy(encode(dec, threads * words)).to(device)
        prog = Program(dec, threads, words, rows, buf)
        if len(_PROGRAMS) > 1024:
            _PROGRAMS.clear()
        _PROGRAMS[key] = prog
    return prog


def _lib() -> ctypes.CDLL:
    lib = _build.load("vm")
    if lib.vm_launch.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vm_launch.restype = i
        lib.vm_launch.argtypes = [p, i, i, i, i, p, i, i, q, p, i, p, i, i,
                                  i, p, i, i, i, p]
    return lib


def vm_megakernel(table: np.ndarray, plane: torch.Tensor, out_idx: Sequence[int], *,
                  n_rows: int, first_row: int = 0,
                  errors: Optional[torch.Tensor] = None,
                  reduce: Optional[str] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the opcode table over ``plane``: the CUDA kernel for a CUDA
    tensor, `vm_plain` for a CPU tensor. Same arguments and result as
    `vm_plain`."""
    if plane.device.type == "cpu":
        return vm_plain(table, plane, out_idx, n_rows=n_rows,
                        first_row=first_row, errors=errors, reduce=reduce,
                        mask=mask)
    if plane.device.type != "cuda":
        raise ValueError(f"vm_megakernel runs on cuda or cpu, not "
                         f"{plane.device}")
    table = np.asarray(table, dtype=np.int32)
    out_idx = tuple(int(i) for i in out_idx)
    _check(table, plane, out_idx, n_rows, first_row, errors, reduce, mask)
    batch, n_in, words = plane.shape
    n_cmds, n_out = table.shape[0], len(out_idx)
    if n_cmds > INDEX + 1:
        raise ValueError(f"{n_cmds} commands exceed the header's "
                         f"{INDEX + 1} command indices")
    if reduce is None:
        out = torch.empty((batch, n_out, words), dtype=torch.int32,
                          device=plane.device)
    else:
        out = torch.zeros((batch, n_out), dtype=torch.int32,
                          device=plane.device)
    if batch == 0 or words == 0 or n_out == 0:
        return out
    masked = reduce is not None and mask is not None
    prog = program(table, out_idx, n_rows, first_row, n_in,
                   errors is not None, masked, plane.device)
    dec = prog.dec
    plane = plane.contiguous()
    errors = None if errors is None else errors.contiguous()
    mask = None if not masked else mask.contiguous()
    unit = prog.threads * prog.words
    lib = _lib()
    with torch.cuda.device(plane.device):
        rc = lib.vm_launch(
            _build.ptr(prog.buf), prog.buf.numel(), len(dec.loads), n_out,
            (prog.buf.numel() - _round4(2 * len(dec.loads))
             - _round4(n_out)) // 4,
            _build.ptr(plane), batch, n_in, words, _build.ptr(errors),
            n_cmds, _build.ptr(mask),
            int(masked and mask.shape[0] > 1), dec.n_slots * unit,
            prog.rows * unit, _build.ptr(out), int(reduce is not None),
            prog.threads, prog.words, _build.stream_of(plane))
    _build.check(lib, rc, "vm_launch")
    LAUNCHES["vm_materialize" if reduce is None else "vm_popcount"] += 1
    return out


def run_megakernel(lp, plane: torch.Tensor, outputs: Sequence[str],
                   errors=None, reduce: Optional[str] = None,
                   mask=None) -> torch.Tensor:
    """Named-row convenience over `vm_megakernel`, as the reference's.

    ``lp`` is a `core.lowering.LoweredProgram` and ``plane`` its
    ``(n_rows, *batch, W)`` plane (`core.lowering.make_plane`); the
    ``outputs`` rows come back as ``(len(outputs), *batch, W)`` rows, or
    with ``reduce="popcount"`` as ``(len(outputs), *batch)`` int32 counts,
    or with ``reduce="aggregate"`` as their ``batch``-shaped float32
    weighted sum (`core.lowering.weight_counts`). ``errors`` (``(n_cmds,
    4[, *batch], W)`` fault masks) and ``mask`` (a per-word mask of the
    counted rows) pass through. The kernel picks its own block shape, so
    the reference's ``block_cols`` (a TPU tile width) has no counterpart.
    """
    from repro_torch.core.lowering import (_flat_errors, _flat_mask,
                                           weight_counts)

    if reduce not in REDUCE_MODES + ("aggregate",):
        raise ValueError(f"unknown reduce mode {reduce!r}")
    if mask is not None and reduce is None:
        raise ValueError("mask= is only meaningful with a reduce mode")
    out_idx = tuple(lp.row_index(o) for o in outputs)
    n_rows, words = plane.shape[0], plane.shape[-1]
    batch = tuple(plane.shape[1:-1])
    flat = plane.movedim(0, -2).reshape(-1, n_rows, words)
    out = vm_megakernel(
        lp.table, flat, out_idx, n_rows=n_rows, first_row=0,
        errors=(None if errors is None else _flat_errors(
            errors, lp.n_cmds, batch, words, plane.device)),
        reduce=None if reduce is None else "popcount",
        mask=(None if mask is None else _flat_mask(mask, batch, words,
                                                   plane.device)))
    if reduce is None:
        return out.movedim(1, 0).reshape((len(out_idx),) + batch + (words,))
    counts = out.movedim(1, 0).reshape((len(out_idx),) + batch)
    return counts if reduce == "popcount" else weight_counts(counts)
