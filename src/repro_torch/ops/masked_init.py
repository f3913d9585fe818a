"""Bulk masked initialization (paper §8.4.1).

Clears/sets a specific field across an array of packed records without moving
the data to the processor: out = (data & ~mask) | (value & mask), one fused
pass. `field_mask` builds the row-wide mask for a (offset, width) field of a
fixed-stride record — e.g. zeroing the alpha channel of an RGBA image.

The counterpart of `repro.ops.masked_init`, on the port's bulk ops
(`ops.bitwise`: the bitwise kernel on the card). Tensors keep their
device; host operands go to ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.bitplane import pack_bits
from repro_torch.ops.bitwise import bitwise_and, bitwise_not, bitwise_or


def field_mask(record_bits: int, offset: int, width: int, n_records: int,
               device="cuda") -> torch.Tensor:
    """Packed mask with `width` bits set at `offset` of each record."""
    total = record_bits * n_records
    bit_idx = torch.arange(total, device=resolve_device(device)) \
        % record_bits
    return pack_bits((bit_idx >= offset) & (bit_idx < offset + width))


def masked_init(data, mask, value, device=None) -> torch.Tensor:
    """out = (data & ~mask) | (value & mask) on packed words."""
    keep = bitwise_and(data, bitwise_not(mask, device=device), device=device)
    put = bitwise_and(value, mask, device=device)
    return bitwise_or(keep, put, device=device)


def masked_fill_constant(data, mask, bit: int, device=None) -> torch.Tensor:
    """Set all masked bits to a constant 0/1 (the common graphics case —
    maps to two Buddy ops: and with ~mask, or with mask)."""
    if bit:
        return bitwise_or(data, mask, device=device)
    return bitwise_and(data, bitwise_not(mask, device=device), device=device)
