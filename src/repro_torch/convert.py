"""Carry state from the JAX package into the port, as numpy arrays.

Both functions take the reference's objects by duck typing (this module
imports nothing of `repro`): anything with the same attributes works.
Words cross as the same bits, uint32 -> int32 (`core.bitplane.as_words`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lowering import LoweredProgram
from repro_torch.service.catalog import Catalog


def catalog_from_reference(ref, device="cpu") -> Catalog:
    """A port `Catalog` holding the same entries, groups and columns as a
    reference `repro.service.catalog.Catalog`, in registration order (so
    the modeled DRAM placement is the same too)."""
    cat = Catalog(device=torch.device(device))
    for name in ref.names():
        entry = ref.get(name)
        cat.register(name, np.asarray(entry.words, dtype=np.uint32),
                     entry.n_bits, group=entry.group)
    cat.columns.update(ref.columns)
    return cat


def lowered_from_reference(lp) -> LoweredProgram:
    """A port `LoweredProgram` with the reference program's rows and
    opcode table."""
    return LoweredProgram(
        row_names=tuple(lp.row_names),
        table=np.asarray(lp.table, dtype=np.int32),
        reads=tuple(lp.reads), writes=tuple(lp.writes), comment=lp.comment)
