"""Deterministic synthetic data pipeline (the counterpart of
`repro.data.pipeline`).

Batches are pure functions of (seed, step), drawn on the device from a
`torch.Generator` seeded from that pair, so a restart replays the exact
token stream with nothing to checkpoint but the step. The formula is the
reference's; its `jax.random` bits are not reproduced (the tests feed
the reference's batches to both packages). `host_shard` carves one
host's (or one data-parallel worker's) slice of a global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig


def _generator(seed: int, step: int, device: torch.device
               ) -> torch.Generator:
    """A generator on ``device`` seeded by the pair (seed, step)."""
    key = np.random.SeedSequence([int(seed), int(step)])
    g = torch.Generator(device=device)
    g.manual_seed(int(key.generate_state(1, np.uint64)[0]))
    return g


@dataclasses.dataclass
class SyntheticLM:
    """Markov-ish synthetic LM stream: token t + 1 is token t plus a
    step-keyed drift in [0, 7) (mod the vocabulary), so a model can lower
    its loss on it. Tokens and labels are int32 (B, S), labels are the
    tokens shifted left by one, and the mask zeroes the last position.
    With a ``frontend_name`` ("frames" or "patches") the batch also holds
    standard-normal stub embeddings ``(B, n_frontend_tokens,
    frontend_dim)`` in bf16 under that name."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: Any = DEFAULT_DEVICE
    n_frontend_tokens: int = 0
    frontend_dim: int = 0
    frontend_name: str = ""

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        dev = resolve_device(self.device)
        g = _generator(self.seed, step, dev)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        base = torch.randint(0, V, (B, 1), generator=g, device=dev)
        drift = torch.randint(0, 7, (B, S), generator=g, device=dev)
        toks = ((base + torch.cumsum(drift, dim=1)) % V).to(torch.int32)
        mask = torch.ones((B, S), dtype=torch.float32, device=dev)
        mask[:, -1] = 0.0
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
                 "mask": mask}
        if self.frontend_name:
            batch[self.frontend_name] = torch.randn(
                (B, self.n_frontend_tokens, self.frontend_dim), generator=g,
                device=dev).to(torch.bfloat16)
        return batch

    @classmethod
    def for_cell(cls, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 device: Any = DEFAULT_DEVICE) -> "SyntheticLM":
        return cls(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                   global_batch=shape.global_batch, seed=seed, device=device,
                   n_frontend_tokens=cfg.n_frontend_tokens,
                   frontend_dim=cfg.frontend_dim or cfg.d_model,
                   frontend_name=frontend_name(cfg))


def frontend_name(cfg: ModelConfig) -> str:
    """The batch key of ``cfg``'s stub frontend embeddings: "frames"
    (audio), "patches" (vision), or "" without a frontend."""
    if not cfg.frontend:
        return ""
    return "frames" if cfg.frontend == "audio" else "patches"


def host_shard(batch: Dict[str, Any], host_id: int = 0, n_hosts: int = 1
               ) -> Dict[str, Any]:
    """The ``host_id``-th of ``n_hosts`` equal slices of a global batch
    along its leading axis."""
    if n_hosts == 1:
        return batch

    def s(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: s(x) for k, x in batch.items()}
