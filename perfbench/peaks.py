"""Published peaks of the cards the benchmark knows, for its rooflines.

NVIDIA H100 SXM5 80 GB data sheet, dense rates without sparsity, at the
full 700 W power limit (a run records the card's own limit beside them).
The table is keyed by the whole name that `torch.cuda.get_device_name()`
gives: an H100 PCIe or NVL has other peaks. A card that is not listed
has no peaks, and the metrics that need them are left out of its result
lines.
"""
from __future__ import annotations

from typing import Dict, Optional

#: card name -> peaks (FLOP/s, bytes/s)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def for_card(name: str) -> Optional[Dict[str, float]]:
    """The peaks of the card ``torch.cuda.get_device_name()`` names."""
    return PEAKS.get(name)
