"""Population count on packed words (int32 bit patterns)."""
from __future__ import annotations

import torch

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101


def popcount_u32(w: torch.Tensor) -> torch.Tensor:
    """SWAR popcount per word (Hacker's Delight 5-2). Returns int32 0..32.

    Right shifts on int32 are arithmetic, so every shift is masked; the
    sums and the product wrap exactly as their uint32 counterparts do.
    """
    w = w - ((w >> 1) & _M1)
    w = (w & _M2) + ((w >> 2) & _M2)
    w = (w + (w >> 4)) & _M4
    return ((w * _H01) >> 24) & 0xFF


def popcount_words(words: torch.Tensor, axis=None) -> torch.Tensor:
    """Total set bits (sum over `axis`, default all), as int64."""
    per_word = popcount_u32(words)
    return per_word.sum() if axis is None else per_word.sum(dim=axis)
