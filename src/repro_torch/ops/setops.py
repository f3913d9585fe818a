"""Bitvector set data structure (paper §8.3): constant-time insert/lookup,
bulk union/intersection/difference as row-wide bitwise ops.

The bulk merges accept `banks > 1` to run over the bank-parallel path
(`core.bankgroup` word-sharding + the bank-gridded kernel) — same results,
N-bank schedule; this is the set-operation workload of Fig. 12 scaled the
way §7 scales Fig. 9. With ``banks=1`` they are plain tensor ops, as the
reference's are plain `jnp` outside any kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch._device import operand_device
from repro_torch.core.bitplane import BitVector, i32, pack_bits
from repro_torch.ops.bitwise import andnot, bitwise_and, bitwise_or


@dataclasses.dataclass
class BitSet:
    """Set over domain [0, domain) as a packed bitvector."""

    bits: BitVector

    @classmethod
    def empty(cls, domain: int, device=None) -> "BitSet":
        """The empty set on ``device`` (default ``"cuda"``)."""
        return cls(BitVector.zeros(domain,
                                   device=operand_device((), device)))

    @classmethod
    def from_elements(cls, elems, domain: int, device=None) -> "BitSet":
        """Duplicate-safe: scatter 1s at bit granularity, then pack. A
        tensor of elements keeps its device; host elements go to
        ``device`` (default ``"cuda"``)."""
        dev = operand_device([elems], device)
        elems = torch.as_tensor(elems, device=dev).to(torch.int64)
        bits = torch.zeros((domain,), dtype=torch.int32, device=dev)
        bits[elems] = 1
        return cls(BitVector(pack_bits(bits), domain))

    @property
    def domain(self) -> int:
        return self.bits.n_bits

    def insert(self, e: int) -> "BitSet":
        e = int(e)
        w = self.bits.words.clone()
        # bit 31 is negative in int32: build the word through i32
        w[e // 32] |= i32(1 << (e % 32))
        return BitSet(BitVector(w, self.domain))

    def contains(self, e: int) -> torch.Tensor:
        """1 if ``e`` is in the set, else 0 (0-dim int32)."""
        e = int(e)
        return (self.bits.words[e // 32] >> (e % 32)) & 1

    def union(self, *others: "BitSet", banks: int = 1) -> "BitSet":
        """Multi-way set union — one bulk OR per operand."""
        if banks > 1:
            return self._merge("or", others, banks)
        out = self.bits
        for o in others:
            out = out | o.bits
        return BitSet(out)

    def intersection(self, *others: "BitSet", banks: int = 1) -> "BitSet":
        """Multi-way set intersection — one bulk AND per operand."""
        if banks > 1:
            return self._merge("and", others, banks)
        out = self.bits
        for o in others:
            out = out & o.bits
        return BitSet(out)

    def difference(self, *others: "BitSet", banks: int = 1) -> "BitSet":
        """Set difference — one fused ANDNOT per operand."""
        if banks > 1:
            return self._merge("andnot", others, banks)
        out = self.bits.words
        for o in others:
            out = out & ~o.bits.words
        return BitSet(BitVector(out, self.domain))

    def _merge(self, op: str, others: Sequence["BitSet"],
               banks: int) -> "BitSet":
        fn = {"or": bitwise_or, "and": bitwise_and, "andnot": andnot}[op]
        out = self.bits.words
        for o in others:
            out = fn(out, o.bits.words, banks=banks)
        return BitSet(BitVector(out, self.domain))

    def cardinality(self) -> torch.Tensor:
        return self.bits.popcount()

    def to_elements(self) -> torch.Tensor:
        """The members in increasing order (int64)."""
        return torch.nonzero(self.bits.to_bits())[:, 0]
