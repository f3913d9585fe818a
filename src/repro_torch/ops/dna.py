"""Bit-parallel DNA sequence matching (paper §8.4.3).

Bases pack 2 bits/base into two parallel bit-planes (lo, hi). Exact-match
read mapping a la bit-parallel filters (Shifted-Hamming-Distance family
[15, 71]): a read of length L against a genome of length G evaluates

    match[i] = AND_j  eq_j[i + j],   eq_j = (genome base == read[j])

where each eq_j is one bulk bitwise op over the whole genome plane and the
AND-accumulation over shifted planes is L more — exactly the row-wide
workload Buddy accelerates. Mismatch tolerance (<= t) counts the eq-planes
with the generalized-TRA majority (threshold L - t) instead of the AND
chain.

The counterpart of `repro.ops.dna`. The eq-planes and the AND chain run
on the fused bitwise kernel (`ops.bitwise`: ``and``, ``andnot``,
``nor``), the threshold count on the majority kernel
(`kernels.ops.majority`), each the plain version on CPU tensors; the funnel
shift is plain PyTorch. Host genomes go to ``device`` (default
``"cuda"``). Where the genome and the match positions span different word
counts the reference's final mask fails to broadcast; the port masks the
genome's words past the last valid start.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import operand_device
from repro_torch.core.bitplane import BitVector, pack_bits, shr
from repro_torch.ops.bitwise import andnot, bitwise_and, bitwise_nor

# A=0 C=1 G=2 T=3
_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}


def encode(seq, device=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Sequence (str, int array or tensor) -> (lo_plane, hi_plane, n)
    packed, on the tensor's device or ``device`` (default ``"cuda"``)."""
    if isinstance(seq, str):
        seq = np.asarray([_BASE[c] for c in seq], dtype=np.int32)
    dev = operand_device([seq], device)
    vals = torch.as_tensor(seq, device=dev).to(torch.int32)
    lo = pack_bits((vals & 1).bool())
    hi = pack_bits(((vals >> 1) & 1).bool())
    return lo, hi, int(vals.shape[0])


def shift_down(words: torch.Tensor, k: int) -> torch.Tensor:
    """Packed funnel shift: out bit i = in bit (i + k)  (k >= 0)."""
    nw = words.shape[-1]
    wshift, bshift = divmod(k, 32)
    w = torch.roll(words, -wshift, dims=-1)
    if wshift:
        w[..., max(nw - wshift, 0):] = 0
    if bshift:
        hi = torch.cat([w[..., 1:], torch.zeros_like(w[..., :1])], dim=-1)
        w = shr(w, bshift) | (hi << (32 - bshift))
    return w


def base_equality(lo: torch.Tensor, hi: torch.Tensor,
                  base: int) -> torch.Tensor:
    """Packed eq-plane: genome[i] == base (one fused bulk op)."""
    if base & 1 and base & 2:
        return bitwise_and(lo, hi)
    if base & 1:
        return andnot(lo, hi)
    if base & 2:
        return andnot(hi, lo)
    return bitwise_nor(lo, hi)


def _read(read):
    return [_BASE[c] for c in read] if isinstance(read, str) \
        else [int(b) for b in read]


def _starts(acc: torch.Tensor, n: int, L: int) -> BitVector:
    """Keep the bits of valid start positions (i <= n - L)."""
    valid = max(n - L + 1, 0)
    bits = torch.arange(acc.shape[-1] * 32, device=acc.device) < valid
    return BitVector(acc & pack_bits(bits), valid)


def find_matches(genome, read, device=None) -> BitVector:
    """Exact-match start positions of `read` in `genome` (packed)."""
    g_lo, g_hi, n = encode(genome, device)
    read_vals = _read(read)
    acc = None
    for j, b in enumerate(read_vals):
        eq = shift_down(base_equality(g_lo, g_hi, b), j)
        acc = eq if acc is None else bitwise_and(acc, eq)
    if acc is None:
        acc = torch.full_like(g_lo, -1)
    return _starts(acc, n, len(read_vals))


def find_matches_with_mismatches(genome, read, max_mismatch: int,
                                 device=None) -> BitVector:
    """Start positions with <= max_mismatch mismatches: count eq-planes with
    the generalized-TRA majority (threshold = L - max_mismatch)."""
    from repro_torch.kernels import ops as kops

    g_lo, g_hi, n = encode(genome, device)
    read_vals = _read(read)
    L = len(read_vals)
    planes = torch.stack([
        shift_down(base_equality(g_lo, g_hi, b), j)
        for j, b in enumerate(read_vals)])
    acc = kops.majority(planes, threshold=L - max_mismatch)
    return _starts(acc, n, L)
