"""Majority of k packed bit-planes: the generalized triple-row activation.

Port of the Pallas `repro.kernels.majority.majority_kernel`.
`majority_kernel` launches ``csrc/majority.cu`` (one thread per word
position, a carry-save counter of ``ceil(log2(k+1))`` planes in
registers) for a CUDA tensor and runs the plain version,
`kernels.ref.majority_k`, for a CPU tensor. ``k`` and the threshold are
launch arguments, so one build serves every vote; the counter is at most
`MAX_COUNTER_PLANES` wide, so ``k`` is at most 255.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import majority_k as majority_plain

#: the kernel's counter-width cap (``kMaxPlanes`` in ``csrc/majority.cu``)
MAX_COUNTER_PLANES = 8
MAX_K = (1 << MAX_COUNTER_PLANES) - 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("majority")
    if lib.majority_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.majority_launch.restype = ctypes.c_int
        lib.majority_launch.argtypes = [p, ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_int, p, p]
    return lib


def majority_kernel(planes: torch.Tensor,
                    threshold: Optional[int] = None) -> torch.Tensor:
    """planes: (k, rows, words) int32 -> (rows, words): each bit set where
    at least ``threshold`` (default ``k // 2 + 1``) of the k planes have
    it set; ``threshold <= 0`` gives all ones, ``threshold > k`` zeros."""
    if not isinstance(planes, torch.Tensor) or planes.dtype != torch.int32 \
            or planes.dim() != 3:
        raise ValueError("majority_kernel takes a (k, rows, words) int32 "
                         "tensor")
    k = planes.shape[0]
    if threshold is None:
        threshold = k // 2 + 1
    if planes.device.type == "cpu":
        return majority_plain(planes, threshold)
    if planes.device.type != "cuda":
        raise ValueError(f"majority_kernel runs on cuda or cpu, not "
                         f"{planes.device}")
    if k > MAX_K:
        raise ValueError(f"majority_kernel takes at most {MAX_K} planes "
                         f"(a {MAX_COUNTER_PLANES}-plane counter), got {k}")
    out = torch.empty(planes.shape[1:], dtype=torch.int32,
                      device=planes.device)
    if out.numel() == 0:
        return out
    # clamp into the kernel's int: every value past either edge gives the
    # same all-ones / all-zeros result
    threshold = max(0, min(int(threshold), k + 1))
    planes = planes.contiguous()
    lib = _lib()
    with torch.cuda.device(planes.device):
        rc = lib.majority_launch(_build.ptr(planes), k, out.numel(),
                                 max(1, k.bit_length()), threshold,
                                 _build.ptr(out), _build.stream_of(planes))
    _build.check(lib, rc, "majority_launch")
    LAUNCHES["majority"] += 1
    return out
