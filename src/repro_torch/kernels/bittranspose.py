"""32x32 bit transpose: horizontal values <-> BitWeaving-V planes.

Port of the Pallas `repro.kernels.bittranspose.bit_transpose_kernel` and
`bit_untranspose_kernel`, under the same names. `bit_transpose_kernel`
launches ``csrc/bittranspose.cu`` (a register butterfly per group of 32
values, staged through a shared tile) for a CUDA tensor and runs the plain
version, `kernels.ref.bit_transpose`, for a CPU tensor. Only the
``n_bits`` requested planes are computed — the same function as the
reference's 32-plane transpose sliced to ``n_bits``.
`bit_untranspose_kernel` is the inverse (a register butterfly per group;
plain version `kernels.ref.bit_untranspose`); it reads only the ``b <=
32`` planes it is given, the rest reading as zero, where the reference
pads to 32.

Convention (LSB-first): out[w, g] bit i == bit w of values[g*32 + i].
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import bit_transpose as bit_transpose_plain
from repro_torch.kernels.ref import bit_untranspose as bit_untranspose_plain


def _lib() -> ctypes.CDLL:
    lib = _build.load("bittranspose")
    if lib.bit_transpose_launch.argtypes is None:
        lib.bit_transpose_launch.restype = ctypes.c_int
        lib.bit_transpose_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.bit_untranspose_launch.restype = ctypes.c_int
        lib.bit_untranspose_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
    return lib


def bit_transpose_kernel(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """values: (n,) int32 words, n % 32 == 0 -> planes (n_bits, n // 32)."""
    if values.device.type == "cpu":
        return bit_transpose_plain(values, n_bits)
    if values.device.type != "cuda":
        raise ValueError(f"bit_transpose_kernel runs on cuda or cpu, not "
                         f"{values.device}")
    if values.dtype != torch.int32 or values.dim() != 1:
        raise ValueError(f"values must be (n,) int32, got "
                         f"{tuple(values.shape)} {values.dtype}")
    n = values.shape[0]
    if n % 32:
        raise ValueError(f"bit_transpose needs a multiple of 32 values, "
                         f"got {n}")
    if not 0 <= n_bits <= 32:
        raise ValueError(f"n_bits must be in 0..32, got {n_bits}")
    groups = n // 32
    out = torch.empty((n_bits, groups), dtype=torch.int32,
                      device=values.device)
    if groups == 0 or n_bits == 0:
        return out
    values = values.contiguous()
    lib = _lib()
    with torch.cuda.device(values.device):
        rc = lib.bit_transpose_launch(_build.ptr(values), groups, n_bits,
                                      _build.ptr(out),
                                      _build.stream_of(values))
    _build.check(lib, rc, "bit_transpose_launch")
    LAUNCHES["bit_transpose"] += 1
    return out


def bit_untranspose_kernel(planes: torch.Tensor) -> torch.Tensor:
    """planes: (b, g) int32 words, b <= 32 -> (32g,) values; value
    32*g + i takes bit j from bit i of planes[j, g] (0 for j >= b)."""
    if not isinstance(planes, torch.Tensor) or planes.dtype != torch.int32 \
            or planes.dim() != 2 or planes.shape[0] > 32:
        raise ValueError("bit_untranspose_kernel takes (b, g) int32 "
                         "planes, b <= 32")
    n_bits = planes.shape[0]
    if planes.device.type == "cpu":
        return bit_untranspose_plain(planes, n_bits)
    if planes.device.type != "cuda":
        raise ValueError(f"bit_untranspose_kernel runs on cuda or cpu, not "
                         f"{planes.device}")
    groups = planes.shape[1]
    out = torch.empty((32 * groups,), dtype=torch.int32,
                      device=planes.device)
    if groups == 0:
        return out
    planes = planes.contiguous()
    lib = _lib()
    with torch.cuda.device(planes.device):
        rc = lib.bit_untranspose_launch(_build.ptr(planes), groups, n_bits,
                                        _build.ptr(out),
                                        _build.stream_of(planes))
    _build.check(lib, rc, "bit_untranspose_launch")
    LAUNCHES["bit_untranspose"] += 1
    return out
