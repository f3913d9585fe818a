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
"""
from __future__ import annotations

import ctypes
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
#: columns per thread block, widest first (one thread per column)
BLOCK_COLS = (256, 128, 64, 32)


def block_cols(n_rows: int, n_cmds: int, n_out: int) -> int:
    """Widest column block whose ``n_rows x cols`` plane tile, plus the
    opcode table, output indices and count slots, fits in shared memory."""
    fixed = 4 * (5 * n_cmds + 2 * n_out)
    for cols in BLOCK_COLS:
        if fixed + 4 * n_rows * cols <= SMEM_LIMIT:
            return cols
    raise ValueError(
        f"a {n_rows}-row plane with {n_cmds} commands does not fit one "
        f"thread block's shared memory even at {BLOCK_COLS[-1]} columns")


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


_PROGRAMS: Dict[Tuple, torch.Tensor] = {}


def _program(table: np.ndarray, out_idx: Tuple[int, ...],
             device: torch.device) -> torch.Tensor:
    """The kernel's int32 program buffer ``[table.flat | out_idx]`` on
    ``device``, cached so a repeated plan costs no host-to-device copy."""
    key = (table.tobytes(), out_idx, str(device))
    buf = _PROGRAMS.get(key)
    if buf is None:
        host = np.concatenate([table.reshape(-1),
                               np.asarray(out_idx, dtype=np.int32)])
        buf = torch.from_numpy(host).to(device)
        if len(_PROGRAMS) > 1024:
            _PROGRAMS.clear()
        _PROGRAMS[key] = buf
    return buf


def _lib() -> ctypes.CDLL:
    lib = _build.load("vm")
    if lib.vm_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vm_launch.restype = i
        lib.vm_launch.argtypes = [p, i, i, p, i, i, i, i, i, p, p, i, p, i,
                                  i, p]
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
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's 65535 rows")
    if reduce is None:
        out = torch.empty((batch, n_out, words), dtype=torch.int32,
                          device=plane.device)
    else:
        out = torch.zeros((batch, n_out), dtype=torch.int32,
                          device=plane.device)
    if batch == 0 or words == 0 or n_out == 0:
        return out
    cols = block_cols(n_rows, n_cmds, n_out)
    prog = _program(table, out_idx, plane.device)
    plane = plane.contiguous()
    errors = None if errors is None else errors.contiguous()
    mask = None if mask is None else mask.contiguous()
    lib = _lib()
    with torch.cuda.device(plane.device):
        rc = lib.vm_launch(
            _build.ptr(prog), n_cmds, n_out, _build.ptr(plane), batch, n_in,
            n_rows, first_row, words, _build.ptr(errors), _build.ptr(mask),
            int(mask is not None and mask.shape[0] > 1), _build.ptr(out),
            int(reduce is not None), cols, _build.stream_of(plane))
    _build.check(lib, rc, "vm_launch")
    LAUNCHES["vm_materialize" if reduce is None else "vm_popcount"] += 1
    return out
