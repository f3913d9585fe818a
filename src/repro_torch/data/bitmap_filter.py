"""Bitmap-index corpus curation — the paper's §8.1/§8.2 machinery as a
training-data pipeline stage.

A corpus catalog keeps one packed bitmap per document attribute (language,
quality tier, dedup-canonical, toxicity flag, ...) plus BitWeaving-V vertical
columns for integer metadata (token counts). A filter expression is compiled
to bulk bitwise ops over the packed bitmaps (AND/OR/NOT — on hardware these
are Buddy AAP programs; here the fused bitwise kernel) and BitWeaving range
scans, yielding the eligible-document bitmap that drives sampling.

The counterpart of `repro.data.bitmap_filter`: the bitwise, BitWeaving-scan
and popcount kernels on the card (their plain versions on CPU tensors).
Randomness comes from a `torch.Generator`, whose draws are not the
reference's `jax.random` bits; `gumbel_top_k` is the sampler's pure step,
so any source of Gumbel draws can be held to the same selection.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bitplane import pack_bits, unpack_bits
from repro_torch.ops.bitwise import bitwise_and, bitwise_not
from repro_torch.ops.predicate import VerticalColumn


@dataclasses.dataclass
class CorpusCatalog:
    """n_docs documents with boolean attribute bitmaps and integer columns."""

    attrs: Dict[str, torch.Tensor]         # name -> (n_words,) int32 packed
    columns: Dict[str, VerticalColumn]     # name -> vertical int column
    n_docs: int

    @property
    def device(self) -> torch.device:
        for words in self.attrs.values():
            return words.device
        for col in self.columns.values():
            return col.planes.device
        raise ValueError("an empty catalog has no device")

    @classmethod
    def synthetic(cls, generator: torch.Generator, n_docs: int,
                  attr_p: Optional[Dict[str, float]] = None,
                  token_bits: int = 12) -> "CorpusCatalog":
        """Random attributes and token counts drawn from ``generator`` on
        its device."""
        attr_p = attr_p or {"lang_en": 0.6, "quality_hi": 0.3,
                            "dedup_canonical": 0.8, "toxic": 0.05}
        dev = torch.device(generator.device)
        attrs = {name: pack_bits(torch.rand((n_docs,), generator=generator,
                                            device=dev) < p)
                 for name, p in attr_p.items()}
        n_tokens = torch.randint(0, (1 << token_bits) - 1, (n_docs,),
                                 generator=generator, device=dev)
        cols = {"n_tokens": VerticalColumn.encode(n_tokens.to(torch.int32),
                                                  token_bits)}
        return cls(attrs, cols, n_docs)


def build_filter(cat: CorpusCatalog,
                 require: Sequence[str] = (),
                 exclude: Sequence[str] = (),
                 ranges: Optional[Dict[str, Tuple[int, int]]] = None
                 ) -> Tuple[torch.Tensor, int]:
    """Compile and evaluate a filter; returns (packed eligibility bitmap,
    n_eligible). `require`: attributes that must be 1; `exclude`: must be 0;
    `ranges`: integer column lo <= v <= hi (BitWeaving scan)."""
    from repro_torch.kernels import ops as kops

    acc = None

    def et(a, b):
        return b if a is None else bitwise_and(a, b)

    for name in require:
        acc = et(acc, cat.attrs[name])
    for name in exclude:
        acc = et(acc, bitwise_not(cat.attrs[name]))
    for name, (lo, hi) in (ranges or {}).items():
        acc = et(acc, cat.columns[name].scan(lo, hi).words)
    if acc is None:
        acc = torch.full(((cat.n_docs + 31) // 32,), -1, dtype=torch.int32,
                         device=cat.device)
    # mask tail padding
    n_valid = int(kops.popcount(_mask_tail(acc, cat.n_docs)))
    return acc, n_valid


def _mask_tail(packed: torch.Tensor, n: int) -> torch.Tensor:
    nw = packed.shape[-1]
    if nw * 32 == n:
        return packed
    idx = torch.arange(nw, dtype=torch.int32, device=packed.device) * 32
    bits_here = (n - idx).clamp(0, 32)
    # (1 << 31) - 1 wraps to 0x7FFFFFFF in int32, the uint32 value's bits
    mask = torch.where(bits_here >= 32, -1, (1 << bits_here) - 1)
    return packed & mask


def eligible_indices(packed: torch.Tensor, n_docs: int) -> np.ndarray:
    """Unpack the eligibility bitmap into document indices (host-side)."""
    bits = unpack_bits(packed, n_docs).cpu().numpy()
    return np.nonzero(bits)[0]


def gumbel_top_k(bits: torch.Tensor, gumbel: torch.Tensor,
                 batch: int) -> torch.Tensor:
    """The `batch` eligible ids (``bits`` (n_docs,) bool) with the largest
    Gumbel scores, largest first, as int32."""
    scored = torch.where(bits, gumbel, float("-inf"))
    _, idx = torch.topk(scored, batch)
    return idx.to(torch.int32)


def sample_eligible(generator: torch.Generator, packed: torch.Tensor,
                    n_docs: int, batch: int) -> torch.Tensor:
    """Uniformly sample `batch` eligible document ids without replacement
    (gumbel-top-k over the eligibility mask); the Gumbel draws come from
    ``generator``, which must live on the bitmap's device."""
    bits = unpack_bits(packed, n_docs)
    u = torch.rand((n_docs,), generator=generator, device=packed.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return gumbel_top_k(bits, g, batch)
