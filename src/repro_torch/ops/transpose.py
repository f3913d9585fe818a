"""Layout conversion between horizontal integers and BitWeaving-V planes."""
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
    from repro_torch.kernels.bittranspose import bit_transpose_kernel

    return bit_transpose_kernel(
        as_words(values, operand_device([values], device)), n_bits)


def from_vertical(planes, n_bits: int, device=None) -> torch.Tensor:
    """(b, g) vertical bit planes -> (32g,) int32 values built from the
    first ``n_bits`` planes (the inverse of `to_vertical`).

    Always goes through the bit-untranspose wrapper (`kernels.ops.
    bit_untranspose`): the CUDA kernel for planes on the card, its plain
    version on the CPU (the reference's size threshold priced a TPU
    launch). Host planes go to ``device``, default ``"cuda"``.
    """
    from repro_torch.kernels import ops as kops

    return kops.bit_untranspose(
        as_words(planes, operand_device([planes], device)), n_bits)
