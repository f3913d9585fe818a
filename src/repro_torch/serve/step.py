"""Serving: the decode step and the batched greedy / temperature
generation loop (the counterpart of `repro.serve.step`)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.serve.kvcache import extend_cache


def make_serve_step(bundle) -> Callable:
    """serve_step(params, token, cache, pos) -> (logits, cache)."""

    def serve_step(params, token, cache, pos):
        return bundle.decode_step(params, token, cache, pos)

    return serve_step


def generate(bundle, params, batch: Dict[str, Any], max_new: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Prefill + decode loop. ``batch["tokens"]``: (B, S) prompts. Returns
    the (B, max_new) int32 ids ``[tok0, t1, ..., t_{max_new-1}]``: the
    prefill's pick, then each decode step's, as the reference's scan emits
    each step's input token. The reference also runs one more decode step
    whose pick it discards; the port skips it.

    ``temperature <= 0`` picks the argmax over the padded vocabulary;
    otherwise ids are sampled from softmax(logits / temperature) with
    ``generator`` (default: one seeded with 0 on the model's device)."""
    S = batch["tokens"].shape[1]
    logits, cache = bundle.prefill(params, batch)
    cache = extend_cache(cache, max_new)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)

    def pick(logits):
        if temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    toks = [pick(logits)]
    for i in range(max_new - 1):
        logits, cache = bundle.decode_step(params, toks[-1], cache, S + i)
        toks.append(pick(logits))
    return torch.stack(toks, dim=1)
