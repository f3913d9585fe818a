"""Device resolution for the port's entry points.

The counterpart of JAX's default device: entry points take a ``device``
that defaults to ``"cuda"``, and asking for the card on a machine without
one raises instead of falling back to the CPU.
"""
from __future__ import annotations

from typing import Iterable, Optional, Union

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


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so two names of one card compare
    equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def operand_device(operands: Iterable,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The one device a call on ``operands`` runs on.

    Tensor operands keep their own device; host operands (numpy arrays,
    lists) go to ``device``, which defaults to ``"cuda"``. Tensors on
    different devices, or on another device than an explicit ``device``,
    raise `ValueError` (nothing is moved behind the caller's back).
    """
    found = {_indexed(x.device) for x in operands
             if isinstance(x, torch.Tensor)}
    if device is not None:
        found.add(_indexed(resolve_device(device)))
    if len(found) > 1:
        raise ValueError(f"operands lie on different devices: "
                         f"{sorted(str(d) for d in found)}")
    return found.pop() if found else resolve_device(DEFAULT_DEVICE)


def check_use_kernel(use_kernel: Optional[bool], device: torch.device
                     ) -> None:
    """``use_kernel`` (None: either) must agree with the device, which
    picks the path: the CUDA kernel on the card, its plain version on the
    CPU. Nothing falls back from one to the other."""
    if use_kernel is not None and use_kernel != (device.type == "cuda"):
        raise ValueError(
            f"use_kernel={use_kernel} on {device}: the operands' device "
            "picks the path (the CUDA kernel on the card, its plain "
            "version on the CPU)")
