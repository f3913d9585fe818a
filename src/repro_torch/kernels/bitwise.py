"""Fused bulk bitwise ops: and/or/xor/nand/nor/xnor/andnot/not/maj3.

Port of the Pallas `repro.kernels.bitwise.bitwise_kernel` and
`banked_bitwise_kernel`. Both wrappers launch ``csrc/bitwise.cu`` for
CUDA tensors and run the plain version, `kernels.ref.bitwise`, for CPU
tensors. The reference's ``(8, 2048)`` VMEM tiles and its padding to them
were the TPU's: the kernel walks each bank's words as one flat run, so
any shape goes through unpadded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import ARITY, BITWISE_OPS
from repro_torch.kernels.ref import bitwise as bitwise_plain

#: the kernel's op codes (``csrc/bitwise.cu``)
OP_CODES = {op: i for i, op in enumerate(BITWISE_OPS)}
#: CUDA grids allow at most this many blocks on axis y, the bank axis
MAX_BANKS = 65535


def _lib() -> ctypes.CDLL:
    lib = _build.load("bitwise")
    if lib.bitwise_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.bitwise_launch.restype = ctypes.c_int
        lib.bitwise_launch.argtypes = [ctypes.c_int, p, p, p, ctypes.c_int,
                                       ctypes.c_longlong, p, p]
    return lib


def _check(op: str, args, ndim: int, what: str) -> None:
    if op not in BITWISE_OPS:
        raise ValueError(f"unknown bitwise op {op!r}; expected one of "
                         f"{tuple(BITWISE_OPS)}")
    if len(args) != ARITY[op]:
        raise ValueError(f"{op!r} takes {ARITY[op]} operands, got "
                         f"{len(args)}")
    x = args[0]
    for a in args:
        if not isinstance(a, torch.Tensor) or a.dtype != torch.int32 \
                or a.dim() != ndim:
            raise ValueError(f"{what} operands must be {ndim}-D int32 "
                             f"tensors")
        if a.shape != x.shape or a.device != x.device:
            raise ValueError(f"{what} operands differ: {tuple(a.shape)} on "
                             f"{a.device} vs {tuple(x.shape)} on "
                             f"{x.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")


def _launch(op: str, args, n_banks: int) -> torch.Tensor:
    """One launch over ``n_banks`` equal contiguous runs of words."""
    args = tuple(a.contiguous() for a in args)
    x = args[0]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ptrs = [_build.ptr(a) for a in args] + [_build.ptr(None)] * (3 - len(args))
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.bitwise_launch(OP_CODES[op], *ptrs, n_banks,
                                x.numel() // n_banks, _build.ptr(out),
                                _build.stream_of(x))
    _build.check(lib, rc, "bitwise_launch")
    return out


def bitwise_kernel(op: str, *args: torch.Tensor) -> torch.Tensor:
    """``op`` over ``(rows, words)`` int32 operands of one shape."""
    _check(op, args, 2, "bitwise_kernel")
    if args[0].device.type == "cpu":
        return bitwise_plain(op, *args)
    out = _launch(op, args, 1)
    if out.numel():
        LAUNCHES["bitwise"] += 1
    return out


def banked_bitwise_kernel(op: str, *args: torch.Tensor) -> torch.Tensor:
    """``op`` over ``(n_banks, rows, words)`` int32 operands: bank ``k``'s
    slice is one run of words, and the kernel's grid axis y is the bank,
    so no thread block reads two banks."""
    _check(op, args, 3, "banked_bitwise_kernel")
    if args[0].device.type == "cpu":
        return bitwise_plain(op, *args)
    n_banks = args[0].shape[0]
    if n_banks > MAX_BANKS:
        raise ValueError(f"{n_banks} banks exceed the grid's {MAX_BANKS}")
    out = _launch(op, args, n_banks)
    if out.numel():
        LAUNCHES["bitwise_banked"] += 1
    return out
