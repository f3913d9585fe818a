"""Bloom filters on packed bitvectors (paper §8.4.4 approximate statistics).

Batch insert/query are scatter/gather over one packed row; merging filters
(the expensive distributed aggregation) is a bulk OR — a Buddy op. Used by
the data pipeline for streaming dedup statistics.

The counterpart of `repro.ops.bloom`. The hashes are the reference's
uint32 arithmetic carried in int32 bit patterns (products and sums wrap
the same way, right shifts are masked to stay logical); the slot is the
unsigned value's remainder, taken in int64. The OR of an insert and of a
merge runs on the bitwise kernel, the fill ratio's count on the popcount
kernel (their plain versions on CPU tensors).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import operand_device, resolve_device
from repro_torch.core.bitplane import (BitVector, as_words, i32, pack_bits,
                                       shr)
from repro_torch.ops.bitwise import bitwise_or


def _hashes(keys: torch.Tensor, k: int, m_bits: int) -> torch.Tensor:
    """k hash positions per key: double hashing h1 + i*h2
    (Kirsch-Mitzenmacher). keys: (n,) int32 bit patterns -> (n, k) int64
    slots in [0, m_bits)."""
    h1 = keys * i32(0x9E3779B1)
    h1 = (h1 ^ shr(h1, 15)) * i32(0x85EBCA77)
    h1 = h1 ^ shr(h1, 13)
    h2 = keys * i32(0xC2B2AE3D)
    h2 = (h2 ^ shr(h2, 16)) | 1  # odd
    i = torch.arange(k, dtype=torch.int32, device=keys.device)
    h = h1[:, None] + i[None, :] * h2[:, None]
    return (h.long() & 0xFFFFFFFF) % m_bits


@dataclasses.dataclass
class BloomFilter:
    """Bloom filter over an m-bit packed row (paper §8.4.4 "approximate
    statistics").

    `bits` is the filter's backing bitvector (one subarray row in the
    paper's deployment); `k` is the number of hash probes per key.
    Membership updates are scatter/gather; the distributed-aggregation
    path (`merge`) is a bulk OR, i.e. one Buddy AAP program per 8 KB row.
    """

    bits: BitVector
    k: int

    @classmethod
    def create(cls, m_bits: int, k: int = 4, device="cuda") -> "BloomFilter":
        """Empty filter of `m_bits` bits with `k` probes per key, on
        ``device``."""
        return cls(BitVector.zeros(m_bits, device=resolve_device(device)), k)

    def _keys(self, keys) -> torch.Tensor:
        return as_words(keys, operand_device([keys], self.bits.words.device))

    def insert(self, keys) -> "BloomFilter":
        """Set the k probe bits of every key (functional — returns a new
        filter; duplicates are harmless)."""
        pos = _hashes(self._keys(keys), self.k, self.bits.n_bits).reshape(-1)
        flat = torch.zeros((self.bits.n_bits,), dtype=torch.bool,
                           device=self.bits.words.device)
        flat[pos] = True
        new = bitwise_or(self.bits.words, pack_bits(flat))
        return BloomFilter(BitVector(new, self.bits.n_bits), self.k)

    def query(self, keys) -> torch.Tensor:
        """Possibly-present (True) vs definitely-absent (False) per key."""
        pos = _hashes(self._keys(keys), self.k, self.bits.n_bits)
        w = self.bits.words[pos // 32]
        present = (w >> (pos % 32).to(torch.int32)) & 1
        return present.bool().all(dim=1)

    def merge(self, *others: "BloomFilter") -> "BloomFilter":
        """Union of filters — bulk OR (the Buddy-accelerated path)."""
        words = self.bits.words
        for o in others:
            if o.k != self.k or o.bits.n_bits != self.bits.n_bits:
                raise ValueError("merged filters need the same k and size")
            words = bitwise_or(words, o.bits.words)
        return BloomFilter(BitVector(words, self.bits.n_bits), self.k)

    def fill_ratio(self) -> torch.Tensor:
        """Fraction of set bits — drives the false-positive-rate estimate
        fpr ~= fill_ratio ** k."""
        from repro_torch.kernels import ops as kops

        return kops.popcount(self.bits.words) / self.bits.n_bits
