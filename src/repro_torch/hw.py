"""The card's peak rates: the one place the port takes them from.

The counterpart of `repro.hw`, which holds the reference's accelerator
peaks. Here a `Card` row per supported GPU holds the published figures
that the roofline (`launch.roofline`), the kernels' bounds in
``chip_smoke.py`` and the comments in ``csrc/flashattn*.cu`` price
against. `current` picks the row of the card in use by its name
(`torch.cuda.get_device_properties`); `lookup` picks one by name without a
card, so the CPU can price a count (`launch.hlocost`) against a named
card. Any card without a row raises: a peak is never guessed.

The figures are published peaks: they assume the card's full power limit
(700 W for the H100 SXM). A card set below it runs slower under load, so
every measured share of a peak names the card and its power limit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class Card:
    """One GPU's published peaks (dense rates, no sparsity)."""

    name: str
    #: bf16 FLOP/s on the tensor cores
    bf16_flops_per_s: float
    #: float32 FLOP/s outside the tensor cores
    f32_flops_per_s: float
    #: device-memory bytes/s
    hbm_bytes_per_s: float
    #: NVLink bytes/s each way between this card and the others of its
    #: host (the counterpart of the reference's ``ICI_BW``)
    nvlink_bytes_per_s: float
    #: int32 lanes of one SM (int32 operations it starts a clock)
    int32_lanes_per_sm: int
    #: shared-memory bytes one SM moves a clock
    smem_bytes_per_clk: int
    #: TF32 FLOP/s on the tensor cores (0: no published figure); the
    #: float32 flash kernels price their three TF32 products against it,
    #: while `flops_per_s("float32")` stays the FMA peak every other
    #: float32 product runs at
    tf32_flops_per_s: float = 0.0

    def flops_per_s(self, dtype: Union[str, torch.dtype]) -> float:
        """The dense peak for operands of ``dtype`` ("bfloat16" or
        "float32", or the `torch.dtype`)."""
        name = str(dtype).split(".")[-1]
        rates = {"bfloat16": self.bf16_flops_per_s,
                 "float32": self.f32_flops_per_s}
        if name not in rates:
            raise ValueError(f"{self.name}: no peak for {name!r}; "
                             f"expected one of {sorted(rates)}")
        return rates[name]


#: NVIDIA H100 SXM5 80 GB. NVIDIA H100 Tensor Core GPU data sheet (SXM
#: column, dense): 989 TFLOP/s bf16, 67 TFLOP/s float32, 494.7 TFLOP/s TF32
#: (half the sheet's 989.4 with sparsity), 3.35 TB/s HBM3, NVLink 900 GB/s
#: (450 GB/s each way). NVIDIA Hopper architecture white
#: paper: four SM partitions of 16 int32 lanes; 32 shared-memory banks of
#: 4 bytes a clock.
H100_SXM = Card(
    name="NVIDIA H100 80GB HBM3",
    bf16_flops_per_s=989e12,
    f32_flops_per_s=67e12,
    hbm_bytes_per_s=3.35e12,
    nvlink_bytes_per_s=450e9,
    int32_lanes_per_sm=64,
    smem_bytes_per_clk=128,
    tf32_flops_per_s=494.7e12,
)

#: rows by the name `torch.cuda.get_device_properties` reports
CARDS: Dict[str, Card] = {H100_SXM.name: H100_SXM}


def lookup(name: str) -> Card:
    """The row of the card named ``name``; raises for a card the port has
    no published peaks for."""
    if name not in CARDS:
        raise ValueError(f"no peaks for card {name!r}; the port knows "
                         f"{sorted(CARDS)}")
    return CARDS[name]


def current(device: Optional[Union[int, str, torch.device]] = None) -> Card:
    """The row of the card ``device`` (default: the current one); raises
    without a card or for a card without a row."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass a card's row "
                           "(`hw.lookup(name)`) to price on the host")
    dev = torch.cuda.current_device() if device is None else device
    return lookup(torch.cuda.get_device_properties(dev).name)
