"""Sign pack / unpack: 32:1 compression of gradients for majority-vote
signSGD.

Port of the Pallas `repro.kernels.signpack.pack_signs_kernel` and
`unpack_signs_kernel`. `pack_signs_kernel` ((r, 32 w) float32 / bf16 ->
(r, w) int32 words, bit i = the IEEE sign bit of lane i) and
`unpack_signs_kernel` ((r, w) words -> (r, 32 w) {+1, -1}, float32 or
bf16) launch ``csrc/signpack.cu`` (one warp per 32 words: a ballot of 32
coalesced sign tests per word, and its inverse with a shuffle per word)
for CUDA tensors and run the plain versions, `kernels.ref.pack_signs` /
`unpack_signs`, for CPU tensors. Words are int32 bit patterns. The
reference's padding to (8, 512-word) blocks served the TPU's tiles and is
gone: the kernels walk the words of any (r, w) as one flat run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import pack_signs as pack_signs_plain
from repro_torch.kernels.ref import unpack_signs as unpack_signs_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("signpack")
    if lib.pack_signs_launch.argtypes is None:
        p, n, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.pack_signs_launch, lib.unpack_signs_launch):
            fn.restype = i
            fn.argtypes = [p, p, n, i, p]
    return lib


def pack_signs_kernel(x: torch.Tensor) -> torch.Tensor:
    """x: (r, n) float32 or bfloat16, n % 32 == 0 -> (r, n // 32) int32
    words; bit i of word j holds the sign bit of x[:, 32 j + i] (-0.0 ->
    1)."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2 \
            or x.dtype not in _DTYPE_CODE:
        raise ValueError("pack_signs_kernel takes a (rows, lanes) float32 "
                         "or bfloat16 tensor")
    r, n = x.shape
    if n % 32:
        raise ValueError(f"pack_signs_kernel needs a multiple of 32 lanes, "
                         f"got {n}")
    if x.device.type == "cpu":
        return pack_signs_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"pack_signs_kernel runs on cuda or cpu, not "
                         f"{x.device}")
    out = torch.empty((r, n // 32), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    x = x.contiguous()
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pack_signs_launch(_build.ptr(x), _build.ptr(out),
                                   out.numel(), _DTYPE_CODE[x.dtype],
                                   _build.stream_of(x))
    _build.check(lib, rc, "pack_signs_launch")
    LAUNCHES["pack_signs"] += 1
    return out


def unpack_signs_kernel(words: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """words: (r, w) int32 -> (r, 32 w) in {+1, -1} of ``dtype`` (float32
    or bfloat16); a set bit gives -1."""
    if not isinstance(words, torch.Tensor) or words.dim() != 2 \
            or words.dtype != torch.int32:
        raise ValueError("unpack_signs_kernel takes a (rows, words) int32 "
                         "tensor")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"unpack_signs_kernel writes float32 or bfloat16, "
                         f"not {dtype}")
    if words.device.type == "cpu":
        return unpack_signs_plain(words, dtype)
    if words.device.type != "cuda":
        raise ValueError(f"unpack_signs_kernel runs on cuda or cpu, not "
                         f"{words.device}")
    r, w = words.shape
    out = torch.empty((r, 32 * w), dtype=dtype, device=words.device)
    if out.numel() == 0:
        return out
    words = words.contiguous()
    lib = _lib()
    with torch.cuda.device(words.device):
        rc = lib.unpack_signs_launch(_build.ptr(words), _build.ptr(out),
                                     words.numel(), _DTYPE_CODE[dtype],
                                     _build.stream_of(words))
    _build.check(lib, rc, "unpack_signs_launch")
    LAUNCHES["unpack_signs"] += 1
    return out
