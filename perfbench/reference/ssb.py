"""The plain reference of SSB flight 1 in count and select form: the
predicate evaluated row by row on the column codes, in blocks of rows.

``coarse`` names columns compared with their lowest bit dropped (each
code and bound rounded down to even): the control, an answer that is no
longer exact.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch

#: rows per block (a multiple of 32, so blocks pack into whole words)
BLOCK = 1 << 26


def _mask(codes: Mapping[str, torch.Tensor],
          ranges: Mapping[str, Tuple[int, int]], a: int, b: int,
          coarse: Sequence[str]) -> torch.Tensor:
    m = None
    for c, (lo, hi) in ranges.items():
        v = codes[c][a:b].to(torch.int32)
        if c in coarse:
            v, lo, hi = v & ~1, lo & ~1, hi & ~1
        t = (v >= lo) & (v <= hi)
        m = t if m is None else m & t
    return m


def count(codes: Mapping[str, torch.Tensor],
          ranges: Mapping[str, Tuple[int, int]],
          coarse: Sequence[str] = ()) -> int:
    """select count(*) where every column lies in its range."""
    n = next(iter(codes.values())).shape[0]
    total = 0
    for a in range(0, n, BLOCK):
        total += int(_mask(codes, ranges, a, min(n, a + BLOCK),
                           coarse).sum())
    return total


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> (ceil(n / 32),) int32 words, bit i of the vector in
    bit i % 32 of word i // 32."""
    n = bits.shape[0]
    pad = (-n) % 32
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    lanes = bits.view(-1, 32).to(torch.int64)
    weights = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (lanes << weights).sum(-1)
    return (words - (words >= 2**31).to(torch.int64) * 2**32).to(
        torch.int32)


def bitmap_words(codes: Mapping[str, torch.Tensor],
                 ranges: Mapping[str, Tuple[int, int]],
                 coarse: Sequence[str] = ()) -> torch.Tensor:
    """The selection bitmap as packed words."""
    n = next(iter(codes.values())).shape[0]
    parts = [pack(_mask(codes, ranges, a, min(n, a + BLOCK), coarse))
             for a in range(0, n, BLOCK)]
    return torch.cat(parts)

