"""Plain PyTorch oracles of the port's kernels.

For now only the BitWeaving-V bit transpose (the reference's
`repro.kernels.ref.bit_transpose`); the opcode-table VM's plain version
lives beside its kernel in `kernels.vm`.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitplane import pack_lanes


def bit_transpose(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """values: (n,) int32 words (integers < 2**n_bits), n % 32 == 0.

    Returns planes: (n_bits, n//32) int32 — plane j, word g, bit i equals
    bit j of values[32*g + i] (LSB-first packing; plane 0 = LSB).
    """
    n = values.shape[0]
    if n % 32:
        raise ValueError(f"bit_transpose needs a multiple of 32 values, "
                         f"got {n}")
    v = values.reshape(-1, 32)
    planes = [pack_lanes((v >> j) & 1) for j in range(n_bits)]
    if not planes:
        return torch.empty((0, n // 32), dtype=torch.int32,
                           device=values.device)
    return torch.stack(planes)
