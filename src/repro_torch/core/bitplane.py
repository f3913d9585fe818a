"""Packed bit-plane tensors — the device analogue of a DRAM row.

Buddy-RAM operates on 8 KB DRAM rows (65536 bits across a rank). A "row"
here is a vector of 32-bit words, LSB-first within each word, exactly as
in the JAX package. PyTorch has no shift, invert or comparison on
``torch.uint32``, so the words are carried as **int32 tensors holding the
same bit patterns**: `as_words` / `to_uint32` cross the boundary to numpy
uint32 with a ``.view``, and every right shift on words is masked so it
stays logical.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

WORD_BITS = 32
WORD_DTYPE = torch.int32

# Geometry of the paper's subarray: 8 KB row across a rank = 65536 bits.
ROW_BYTES = 8192
ROW_BITS = ROW_BYTES * 8
ROW_WORDS = ROW_BITS // WORD_BITS  # 2048


def n_words(n_bits: int) -> int:
    return (n_bits + WORD_BITS - 1) // WORD_BITS


def i32(x: int) -> int:
    """The int32 bit pattern of a uint32 Python int (0xFFFFFFFF -> -1)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def as_words(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """uint32 words (numpy, list, or tensor) -> int32 bit-pattern tensor.

    int32 tensors pass through (moved to ``device`` if given); uint32
    tensors are re-viewed; host arrays are copied onto ``device`` (the
    CPU when None), so the result never aliases the caller's buffer.
    """
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        elif x.dtype != torch.int32:
            raise TypeError(f"packed words must be int32 or uint32, "
                            f"got {x.dtype}")
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if a.dtype != np.uint32:
        if a.dtype.kind not in "iub":
            raise TypeError(f"packed words must be integers, got {a.dtype}")
        a = a.astype(np.uint32)
    return torch.tensor(np.ascontiguousarray(a).view(np.int32),
                        device=device)


def shr(words: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by ``0 < s < 32`` of int32 bit patterns: the
    reference's uint32 ``>>`` (int32's is arithmetic)."""
    return (words >> s) & ((1 << (32 - s)) - 1)


def to_uint32(words: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> host numpy uint32 (same bits)."""
    return words.detach().cpu().numpy().view(np.uint32)


def pack_lanes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) {0,1} int32 -> (...) int32 words; lane i becomes bit i.

    The lanes hold disjoint bits, so their int32 sum is their OR and never
    overflows: bit 31 (-2**31) is the only negative term.
    """
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=bits.device)
    return (bits << shifts).sum(-1, dtype=torch.int32)


def pack_bits(bits) -> torch.Tensor:
    """Pack a bool/{0,1} array along the last axis into int32 words.

    bits: (..., n) -> (..., ceil(n/32)), LSB-first within each word.
    """
    b = torch.as_tensor(bits).to(torch.int32)
    n = b.shape[-1]
    nw = n_words(n)
    pad = nw * WORD_BITS - n
    if pad:
        b = F.pad(b, (0, pad))
    return pack_lanes(b.reshape(b.shape[:-1] + (nw, WORD_BITS)))


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of pack_bits: (..., nw) words -> (..., n_bits) bool."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD_BITS,))
    return bits[..., :n_bits].to(torch.bool)


def tail_mask(n_bits: int) -> np.ndarray:
    """uint32 mask vector zeroing the padding bits of the final word."""
    nw = n_words(n_bits)
    m = np.full((nw,), 0xFFFFFFFF, dtype=np.uint32)
    rem = n_bits % WORD_BITS
    if rem:
        m[-1] = np.uint32((1 << rem) - 1)
    return m


@dataclasses.dataclass
class BitVector:
    """A length-tagged packed bitvector (1-D logical bit array).

    `words` may have leading batch dims; the last axis is packed words.
    """

    words: torch.Tensor
    n_bits: int

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_bits(cls, bits) -> "BitVector":
        bits = torch.as_tensor(bits)
        return cls(pack_bits(bits), bits.shape[-1])

    @classmethod
    def zeros(cls, n_bits: int, batch: Tuple[int, ...] = (),
              device: Optional[torch.device] = None) -> "BitVector":
        return cls(torch.zeros(batch + (n_words(n_bits),), dtype=WORD_DTYPE,
                               device=device), n_bits)

    @classmethod
    def ones(cls, n_bits: int, batch: Tuple[int, ...] = (),
             device: Optional[torch.device] = None) -> "BitVector":
        w = as_words(tail_mask(n_bits), device).expand(
            batch + (n_words(n_bits),))
        return cls(w, n_bits)

    # -- views -------------------------------------------------------------
    def to_bits(self) -> torch.Tensor:
        return unpack_bits(self.words, self.n_bits)

    def popcount(self) -> torch.Tensor:
        from repro_torch.ops.popcount import popcount_words

        return popcount_words(self.words)

    # -- logical ops -------------------------------------------------------
    def _mask(self) -> torch.Tensor:
        return as_words(tail_mask(self.n_bits), self.words.device)

    def __and__(self, o: "BitVector") -> "BitVector":
        return BitVector(self.words & o.words, self.n_bits)

    def __or__(self, o: "BitVector") -> "BitVector":
        return BitVector(self.words | o.words, self.n_bits)

    def __xor__(self, o: "BitVector") -> "BitVector":
        return BitVector(self.words ^ o.words, self.n_bits)

    def __invert__(self) -> "BitVector":
        return BitVector(~self.words & self._mask(), self.n_bits)

    def majority(self, b: "BitVector", c: "BitVector") -> "BitVector":
        """Triple-row activation: MAJ(self, b, c) = AB + BC + CA."""
        a, bw, cw = self.words, b.words, c.words
        return BitVector((a & bw) | (bw & cw) | (cw & a), self.n_bits)
