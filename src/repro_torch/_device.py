"""Device resolution for the port's entry points.

The counterpart of JAX's default device: entry points take a ``device``
that defaults to ``"cuda"``, and asking for the card on a machine without
one raises instead of falling back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device] = DEFAULT_DEVICE
                   ) -> torch.device:
    """``"cuda"`` / ``"cpu"`` (or a `torch.device`) -> `torch.device`.

    Raises `RuntimeError` for a CUDA device when no card is present.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; "
                         "expected 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the host")
    return dev
