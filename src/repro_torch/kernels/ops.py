"""Public wrappers over the port's kernels.

The counterpart of the reference's `repro.kernels.ops`, for the kernels
ported so far. Each wrapper reshapes its operands to the kernel's layout
and calls the kernel wrapper (looked up on its module at call time),
which launches the CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors. Operands are int32 word tensors
(`core.bitplane.as_words`). The reference's fold of 1-D
operands into 8 sublane rows and its interpret-mode block sizes served
the TPU's tiles and are gone. The remaining wrappers (majority, bit
untranspose, bit-serial arithmetic, sign packing, attention) come with
their kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bittranspose, bitweaving
from repro_torch.kernels import bitwise as _bitwise
from repro_torch.kernels import popcount as _popcount


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Any (..., W) operand as (rows, W); a (W,) vector is one row."""
    if x.dim() == 0:
        raise ValueError("bitwise operands need a word axis")
    return x.reshape(-1, x.shape[-1])


def bitwise(op: str, *args: torch.Tensor) -> torch.Tensor:
    """Fused bitwise op over int32 operands of one shape, (words,) or
    (..., words); the result has that shape."""
    shape = args[0].shape
    return _bitwise.bitwise_kernel(
        op, *(_rows(a) for a in args)).reshape(shape)


def bitwise_banked(op: str, *args: torch.Tensor,
                   n_banks: int = 1) -> torch.Tensor:
    """Bank-parallel bitwise op: operands sharded word-wise over `n_banks`.

    (words,) or (..., words) operands are partitioned with
    `core.bankgroup.shard_words` (zero pad to a multiple of `n_banks`,
    bank axis first), evaluated with the bank-gridded kernel, and
    reassembled with the pad words stripped. Bit-identical to
    `bitwise(op, *args)` for every op and bank count, ``not`` / ``nand``
    included, which drive the pad words to ones.
    """
    from repro_torch.core.bankgroup import shard_words, unshard_words

    shape = args[0].shape
    sharded = tuple(shard_words(_rows(a), n_banks) for a in args)
    out = _bitwise.banked_bitwise_kernel(op, *sharded)
    return unshard_words(out, shape[-1]).reshape(shape)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits of (words,) or (..., words) int32 words: a 0-dim
    int64 tensor on their device."""
    return _popcount.popcount_kernel(_rows(words))


def bit_transpose(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(n,) int32 -> (n_bits, n//32) vertical planes (LSB-first order)."""
    return bittranspose.bit_transpose(values, n_bits)


def bitweaving_scan(planes: torch.Tensor, c1: int, c2: int,
                    n_bits: int) -> torch.Tensor:
    """(b, g) planes -> (g,) packed words of ``c1 <= v <= c2``."""
    return bitweaving.bitweaving_scan_kernel(planes, c1, c2, n_bits)
