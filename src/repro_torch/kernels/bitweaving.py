"""Fused BitWeaving-V between-scan: ``c1 <= v <= c2`` in one pass.

Port of the Pallas `repro.kernels.bitweaving.bitweaving_scan_kernel`.
`bitweaving_scan_kernel` launches ``csrc/bitweaving.cu`` (one thread per
output word, the four comparison states in registers) for a CUDA tensor
and runs the plain version, `kernels.ref.bitweaving_scan`, for a CPU
tensor. The reference bakes ``c1``, ``c2`` and ``n_bits`` into each trace;
here they are launch arguments, so one build serves every query. Bits of
``c1`` / ``c2`` at or above ``n_bits`` are ignored, as the reference's loop
ignores them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import bitweaving_scan as bitweaving_scan_plain

#: widest column the kernel scans (its bounds travel as 64-bit words)
MAX_BITS = 64
_LOW64 = (1 << 64) - 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("bitweaving")
    if lib.bitweaving_scan_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.bitweaving_scan_launch.restype = ctypes.c_int
        lib.bitweaving_scan_launch.argtypes = [
            p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.c_ulonglong, p, p]
    return lib


def bitweaving_scan_kernel(planes: torch.Tensor, c1: int, c2: int,
                           n_bits: int) -> torch.Tensor:
    """planes: (b, g) int32 words, b >= n_bits -> (g,) packed result words
    of ``c1 <= v <= c2`` over the column's low ``n_bits`` planes."""
    if not isinstance(planes, torch.Tensor) or planes.dtype != torch.int32 \
            or planes.dim() != 2:
        raise ValueError("bitweaving_scan_kernel takes (b, g) int32 planes")
    b, g = planes.shape
    if not 0 <= n_bits <= min(b, MAX_BITS):
        raise ValueError(f"n_bits {n_bits} must be in 0..min(b={b}, "
                         f"{MAX_BITS})")
    c1, c2 = int(c1), int(c2)
    if planes.device.type == "cpu":
        return bitweaving_scan_plain(planes, c1, c2, n_bits)
    if planes.device.type != "cuda":
        raise ValueError(f"bitweaving_scan_kernel runs on cuda or cpu, not "
                         f"{planes.device}")
    out = torch.empty((g,), dtype=torch.int32, device=planes.device)
    if g == 0:
        return out
    planes = planes[:n_bits].contiguous()
    lib = _lib()
    with torch.cuda.device(planes.device):
        rc = lib.bitweaving_scan_launch(
            _build.ptr(planes), g, n_bits, c1 & _LOW64, c2 & _LOW64,
            _build.ptr(out), _build.stream_of(planes))
    _build.check(lib, rc, "bitweaving_scan_launch")
    LAUNCHES["bitweaving_scan"] += 1
    return out
