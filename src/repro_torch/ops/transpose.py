"""Layout conversion from horizontal integers to BitWeaving-V planes."""
from __future__ import annotations

import torch

from repro_torch._device import operand_device
from repro_torch.core.bitplane import as_words


def to_vertical(values, n_bits: int, device=None) -> torch.Tensor:
    """(n,) integer column -> (n_bits, n//32) vertical bit planes (LSB first).

    Always goes through the bit-transpose wrapper, which launches the CUDA
    kernel for a CUDA tensor and runs its plain version for a CPU tensor.
    (The reference switches on a 65,536-value threshold that priced its
    kernel's launch; on the card every column takes the kernel.) A tensor
    stays on its device; host values go to ``device``, which defaults to
    ``"cuda"`` (`repro_torch._device.operand_device`).
    """
    from repro_torch.kernels.bittranspose import bit_transpose

    return bit_transpose(
        as_words(values, operand_device([values], device)), n_bits)
