"""Bit-serial ripple-carry arithmetic over packed bit-planes.

Port of the Pallas `repro.kernels.arith.bitserial_add_kernel` and
`bitserial_lt_kernel`. Both wrappers launch ``csrc/arith.cu`` (one
thread per word position, the carry or the lt / eq chain in registers)
for CUDA tensors and run the plain versions, `kernels.ref.bitserial_add`
and `kernels.ref.bitserial_lt`, for CPU tensors. ``n_bits`` and ``sub``
are launch arguments (the reference unrolls ``n_bits`` at trace time),
and the reference's ``(8, 2048)`` tiles and their padding are gone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import bitserial_add as bitserial_add_plain
from repro_torch.kernels.ref import bitserial_lt as bitserial_lt_plain


def _lib() -> ctypes.CDLL:
    lib = _build.load("arith")
    if lib.bitserial_add_launch.argtypes is None:
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bitserial_add_launch.restype = ctypes.c_int
        lib.bitserial_add_launch.argtypes = [p, p, i, n, i, p, p]
        lib.bitserial_lt_launch.restype = ctypes.c_int
        lib.bitserial_lt_launch.argtypes = [p, p, i, n, p, p]
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    for x in (a, b):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 \
                or x.dim() != 3:
            raise ValueError(f"{what} takes (n_bits, rows, words) int32 "
                             "tensors")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"{what}: operands differ: {tuple(a.shape)} on "
                         f"{a.device} vs {tuple(b.shape)} on {b.device}")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {a.device}")


def bitserial_add_kernel(a: torch.Tensor, b: torch.Tensor,
                         sub: bool = False) -> torch.Tensor:
    """(n_bits, rows, words) x2 -> (n_bits, rows, words) planes of
    ``a + b`` (``a - b`` with ``sub``) modulo ``2**n_bits``."""
    _check(a, b, "bitserial_add_kernel")
    if a.device.type == "cpu":
        return bitserial_add_plain(a, b, sub=sub)
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    a, b = a.contiguous(), b.contiguous()
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = lib.bitserial_add_launch(_build.ptr(a), _build.ptr(b),
                                      a.shape[0], a[0].numel(),
                                      int(bool(sub)),
                                      _build.ptr(out), _build.stream_of(a))
    _build.check(lib, rc, "bitserial_add_launch")
    LAUNCHES["bitserial_add"] += 1
    return out


def bitserial_lt_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n_bits, rows, words) x2 -> (rows, words) packed unsigned
    ``a < b``, compared MSB first."""
    _check(a, b, "bitserial_lt_kernel")
    if a.shape[0] == 0:
        raise ValueError("bitserial_lt_kernel needs at least one plane")
    if a.device.type == "cpu":
        return bitserial_lt_plain(a, b)
    out = torch.empty(a.shape[1:], dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    a, b = a.contiguous(), b.contiguous()
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = lib.bitserial_lt_launch(_build.ptr(a), _build.ptr(b),
                                     a.shape[0], out.numel(),
                                     _build.ptr(out), _build.stream_of(a))
    _build.check(lib, rc, "bitserial_lt_launch")
    LAUNCHES["bitserial_lt"] += 1
    return out
