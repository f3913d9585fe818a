"""Bulk bitwise operations on packed words — the deployable fast path.

Every call goes through the fused bitwise kernel's wrapper
(`kernels.ops.bitwise`, or `bitwise_banked` for ``banks > 1``): the CUDA
kernel for operands on the card, its plain PyTorch version for operands
on the CPU. The reference's size threshold (it sent operands under 2**14
words, and every 1-D operand, to plain `jnp`) priced a TPU launch and
interpret mode; here the device alone decides, so 1-D operands on the
card take the kernel too. Semantics are identical to running the paper's
AAP programs through `core.engine`.

Operands are uint32 words (numpy arrays, lists) or int32 / uint32 word
tensors. Tensors stay on their device, and all of them must share it;
host operands go to ``device``, which defaults to ``"cuda"`` and raises
where there is no card (pass ``device="cpu"`` to run on the host).
``use_kernel=False`` on the card and ``use_kernel=True`` on the CPU
raise: the device picks the path, and nothing falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import check_use_kernel, operand_device
from repro_torch.core.bitplane import as_words


def _dispatch(op: str, *args, use_kernel: Optional[bool] = None,
              banks: int = 1, device=None) -> torch.Tensor:
    """Route one bulk op: the banked kernel grid for ``banks > 1``, else
    the flat kernel; results are bit-identical across both."""
    from repro_torch.kernels import ops as kops

    dev = operand_device(args, device)
    check_use_kernel(use_kernel, dev)
    if banks < 1:
        raise ValueError(f"banks must be >= 1, got {banks}")
    words = tuple(as_words(a, dev) for a in args)
    if banks > 1:
        return kops.bitwise_banked(op, *words, n_banks=banks)
    return kops.bitwise(op, *words)


def bitwise_and(a, b, **kw):
    return _dispatch("and", a, b, **kw)


def bitwise_or(a, b, **kw):
    return _dispatch("or", a, b, **kw)


def bitwise_xor(a, b, **kw):
    return _dispatch("xor", a, b, **kw)


def bitwise_not(a, **kw):
    return _dispatch("not", a, **kw)


def bitwise_nand(a, b, **kw):
    return _dispatch("nand", a, b, **kw)


def bitwise_nor(a, b, **kw):
    return _dispatch("nor", a, b, **kw)


def bitwise_xnor(a, b, **kw):
    return _dispatch("xnor", a, b, **kw)


def majority3(a, b, c, **kw):
    """Triple-row activation: the paper's native primitive."""
    return _dispatch("maj3", a, b, c, **kw)


def andnot(a, b, **kw):
    """a & ~b (bitmap difference; one fused pass)."""
    return _dispatch("andnot", a, b, **kw)
