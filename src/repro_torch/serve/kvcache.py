"""KV cache utilities for serving (the counterpart of
`repro.serve.kvcache`)."""
from __future__ import annotations

from typing import Any, Dict

import torch


def extend_cache(cache: Dict[str, Any], extra: int) -> Dict[str, Any]:
    """Pad the sequence axis of the attention KV sheets by ``extra`` zero
    slots so a prefill-produced cache (length S) can absorb ``extra``
    decoded tokens. The SSM state / conv caches and the cross-attention
    caches (``cross_k``, ``cross_v``) are fixed-size and pass through
    untouched."""
    out: Dict[str, Any] = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = extend_cache(v, extra)
        elif k in ("k", "v"):
            # (L, B, S, KV*hd): pad axis 2
            out[k] = torch.nn.functional.pad(v, (0, 0, 0, extra))
        else:
            out[k] = v
    return out


def cache_bytes(cache) -> int:
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return 0
