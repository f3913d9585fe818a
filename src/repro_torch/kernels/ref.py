"""Plain PyTorch oracles of the port's kernels.

The counterparts of the reference's `repro.kernels.ref`: the fused bulk
bitwise ops, the k-plane majority, the total popcount, the BitWeaving-V
bit transpose and its inverse, the BitWeaving-V between-scan, the
bit-serial add / sub / less-than and the sign pack / unpack. Each CUDA
wrapper runs these for CPU tensors, and `chip_smoke.py` holds the
kernels to them on the card. The opcode-table VM's plain version lives
beside its kernel in `kernels.vm`. Words are int32 bit patterns; a right
shift here is always followed by ``& 1``, so the sign bits it drags in
never count.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.bitplane import pack_lanes
from repro_torch.ops.popcount import popcount_words

# ---------------------------------------------------------------------------
# fused bitwise ops
# ---------------------------------------------------------------------------

BITWISE_OPS = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "nand": lambda a, b: ~(a & b),
    "nor": lambda a, b: ~(a | b),
    "xnor": lambda a, b: ~(a ^ b),
    "andnot": lambda a, b: a & ~b,
    "not": lambda a: ~a,
    "maj3": lambda a, b, c: (a & b) | (b & c) | (c & a),
}

#: operands each op takes
ARITY = {op: fn.__code__.co_argcount for op, fn in BITWISE_OPS.items()}


def bitwise(op: str, *args: torch.Tensor) -> torch.Tensor:
    """One of `BITWISE_OPS` over int32 word tensors of one shape."""
    return BITWISE_OPS[op](*args)


# ---------------------------------------------------------------------------
# majority over k bit-planes (generalized TRA)
# ---------------------------------------------------------------------------


def majority_k(planes: torch.Tensor, threshold: Optional[int] = None
               ) -> torch.Tensor:
    """planes: (k, ...) int32 words -> (...) words whose bit is set where
    at least ``threshold`` (default ``k // 2 + 1``, the majority) of the k
    planes have it set.

    Unpacks each bit position and counts, one plane at a time: exact by
    construction, and independent of the kernel's carry-save counter.
    ``threshold <= 0`` gives all ones, ``threshold > k`` all zeros.
    """
    k = planes.shape[0]
    if threshold is None:
        threshold = k // 2 + 1
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    counts = torch.zeros(planes.shape[1:] + (32,), dtype=torch.int32,
                         device=planes.device)
    for i in range(k):
        counts += (planes[i][..., None] >> shifts) & 1
    return pack_lanes((counts >= threshold).to(torch.int32))


# ---------------------------------------------------------------------------
# popcount
# ---------------------------------------------------------------------------


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits of every word, as a 0-dim int64 tensor."""
    return popcount_words(words)


# ---------------------------------------------------------------------------
# BitWeaving-V bit transpose: values -> vertical bit planes
# ---------------------------------------------------------------------------


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


def bit_untranspose(planes: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of `bit_transpose`: (b, g) planes -> (32g,) int32 values
    built from the first ``n_bits`` planes (value 32*g + i takes bit j
    from bit i of planes[j, g])."""
    g = planes.shape[1]
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    vals = torch.zeros((g * 32,), dtype=torch.int32, device=planes.device)
    for j in range(n_bits):
        bits = ((planes[j][:, None] >> shifts) & 1).reshape(g * 32)
        vals |= bits << j
    return vals


# ---------------------------------------------------------------------------
# BitWeaving-V predicate scan: c1 <= v <= c2 over vertical planes
# ---------------------------------------------------------------------------


def _cmp_planes(planes: torch.Tensor, c: int, n_bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bit-serial compare of every packed column value against constant c.

    Returns (lt, eq) packed words. Scans MSB -> LSB (BitWeaving §4); bits
    of ``c`` at or above ``n_bits`` are never read.
    """
    g = planes.shape[1]
    ones = torch.full((g,), -1, dtype=torch.int32, device=planes.device)
    zeros = torch.zeros((g,), dtype=torch.int32, device=planes.device)
    lt, eq = zeros, ones
    for j in range(n_bits - 1, -1, -1):
        cj = ones if ((c >> j) & 1) else zeros
        lt = lt | (eq & ~planes[j] & cj)
        eq = eq & ~(planes[j] ^ cj)
    return lt, eq


def bitweaving_scan(planes: torch.Tensor, c1: int, c2: int, n_bits: int
                    ) -> torch.Tensor:
    """Result words of the predicate c1 <= v <= c2 (paper §8.2 query)
    over (b, g) planes, b >= n_bits."""
    lt1, _ = _cmp_planes(planes, c1, n_bits)
    lt2, eq2 = _cmp_planes(planes, c2, n_bits)
    return ~lt1 & (lt2 | eq2)


# ---------------------------------------------------------------------------
# bit-serial ripple-carry arithmetic over vertical planes (SIMDRAM-style)
# ---------------------------------------------------------------------------


def bitserial_add(a_planes: torch.Tensor, b_planes: torch.Tensor,
                  sub: bool = False) -> torch.Tensor:
    """(n_bits, ...) x2 int32 planes -> (n_bits, ...) sum planes.

    Ripple-carry full adders per bit position; SUB is a + ~b + 1. The
    carry out of the MSB is dropped (wrap modulo 2**n_bits), so the result
    is exact for unsigned and two's-complement operands alike.
    """
    c = torch.full_like(a_planes[0], -1) if sub \
        else torch.zeros_like(a_planes[0])
    outs = []
    for j in range(a_planes.shape[0]):
        a = a_planes[j]
        b = ~b_planes[j] if sub else b_planes[j]
        outs.append(a ^ b ^ c)
        c = (a & b) | (b & c) | (c & a)
    if not outs:
        return torch.empty_like(a_planes)
    return torch.stack(outs)


def bitserial_lt(a_planes: torch.Tensor, b_planes: torch.Tensor
                 ) -> torch.Tensor:
    """(n_bits, ...) x2 int32 planes -> (...) packed unsigned ``a < b``,
    compared MSB first."""
    lt = torch.zeros_like(a_planes[0])
    eq = torch.full_like(a_planes[0], -1)
    for j in range(a_planes.shape[0] - 1, -1, -1):
        lt = lt | (eq & ~a_planes[j] & b_planes[j])
        eq = eq & ~(a_planes[j] ^ b_planes[j])
    return lt


# ---------------------------------------------------------------------------
# sign pack / unpack (1-bit gradient compression)
# ---------------------------------------------------------------------------


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """(..., 32 w) float32 / bf16 -> (..., w) int32 words; bit i of a word
    is the IEEE sign bit of lane i (`torch.signbit`: set for -0.0 and for
    NaNs with the sign bit)."""
    n = x.shape[-1]
    if n % 32:
        raise ValueError(f"pack_signs needs a multiple of 32 lanes, got {n}")
    bits = torch.signbit(x).to(torch.int32)
    return pack_lanes(bits.reshape(x.shape[:-1] + (n // 32, 32)))


def unpack_signs(words: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., w) int32 words -> (..., 32 w) in {+1, -1} of ``dtype`` (bit 1
    -> -1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    out = 1.0 - 2.0 * bits.to(torch.float32)
    return out.reshape(words.shape[:-1] + (words.shape[-1] * 32,)).to(dtype)
