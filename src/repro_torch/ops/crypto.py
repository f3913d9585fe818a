"""XOR-based encryption primitives (paper §8.4.2).

One-time-pad / stream-cipher XOR is the canonical bandwidth-bound bitwise
workload: ciphertext = plaintext ^ keystream, one fused pass. The keystream
generator is a counter-mode xorshift PRF (not cryptographically strong — it
demonstrates the data path the paper targets, where the XOR of multi-KB
blocks dominates, e.g. optical XOR encryption [26] and visual crypto [66]).

The counterpart of `repro.ops.crypto`. The stream is the reference's
uint32 arithmetic carried in int32 bit patterns: products and sums wrap
the same way, and each right shift is masked so it stays logical.
"""
from __future__ import annotations

import torch

from repro_torch._device import operand_device, resolve_device
from repro_torch.core.bitplane import as_words, i32, shr
from repro_torch.ops.bitwise import bitwise_xor


def keystream(key: int, shape, device="cuda") -> torch.Tensor:
    """Counter-mode xorshift* stream: words[i] = mix(key, i), as int32 bit
    patterns of ``shape`` on ``device``."""
    n = 1
    for s in shape:
        n *= s
    ctr = torch.arange(n, dtype=torch.int32, device=resolve_device(device))
    x = ctr + i32(int(key) * 0x9E3779B9)
    x = x ^ shr(x, 16)
    x = x * i32(0x21F0AAAD)
    x = x ^ shr(x, 15)
    x = x * i32(0x735A2D97)
    x = x ^ shr(x, 15)
    return x.reshape(tuple(shape))


def xor_encrypt(plaintext, key: int, device=None) -> torch.Tensor:
    """plaintext: packed words; involution (decrypt == encrypt)."""
    words = as_words(plaintext, operand_device([plaintext], device))
    return bitwise_xor(words, keystream(key, words.shape, words.device))


def xor_decrypt(ciphertext, key: int, device=None) -> torch.Tensor:
    """Inverse of `xor_encrypt` — the same XOR pass (involution, §8.4.2)."""
    return xor_encrypt(ciphertext, key, device)
