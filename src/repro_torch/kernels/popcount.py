"""Total popcount of packed words.

Port of the Pallas `repro.kernels.popcount.popcount_kernel`.
`popcount_kernel` launches ``csrc/popcount.cu`` (``__popc`` per word, a
warp and a CTA reduction, one 64-bit ``atomicAdd`` per CTA) for a CUDA
tensor and runs the plain version, `kernels.ref.popcount`, for a CPU
tensor. The total is a 0-dim int64 tensor on the operand's device: exact,
and equal to the reference's int32 total wherever that does not wrap
(below 2**31 set bits).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import popcount as popcount_plain


def _lib() -> ctypes.CDLL:
    lib = _build.load("popcount")
    if lib.popcount_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.popcount_launch.restype = ctypes.c_int
        lib.popcount_launch.argtypes = [p, ctypes.c_longlong, p, p]
    return lib


def popcount_kernel(words: torch.Tensor) -> torch.Tensor:
    """words: (rows, words) int32 -> 0-dim int64 total of set bits."""
    if not isinstance(words, torch.Tensor) or words.dtype != torch.int32 \
            or words.dim() != 2:
        raise ValueError("popcount_kernel takes a (rows, words) int32 "
                         "tensor")
    if words.device.type == "cpu":
        return popcount_plain(words)
    if words.device.type != "cuda":
        raise ValueError(f"popcount_kernel runs on cuda or cpu, not "
                         f"{words.device}")
    total = torch.zeros((), dtype=torch.int64, device=words.device)
    if words.numel() == 0:
        return total
    words = words.contiguous()
    lib = _lib()
    with torch.cuda.device(words.device):
        rc = lib.popcount_launch(_build.ptr(words), words.numel(),
                                 _build.ptr(total), _build.stream_of(words))
    _build.check(lib, rc, "popcount_launch")
    LAUNCHES["popcount"] += 1
    return total
