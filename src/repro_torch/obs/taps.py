"""Taps: a model's intermediate tensors handed to a reader.

While `reading(fn)` is active, each tap site calls ``fn(site, values)``
with the tensors named below, as the model computes them; the reader
copies what it keeps (the model goes on to free or rebind them). With no
reader a site costs one check of `READER`. The sites are an interface
of their own: a check that compares a model's layers with a reference
reads them, and a change to the model keeps them where they are.

* ``block`` (`models/nemotron_h.py` prefill): a pattern block's input
  ``x`` (B, S, D) and its mixer's output ``y`` (B, S, D) before the
  residual add, with the block's ``index``;
* ``moe.route`` (`models/moe.py` `moe_ffn`, outside a mesh): the experts
  an MoE layer selected for its tokens, ``idx`` (T, k);
* ``final`` (`models/nemotron_h.py` prefill): the final norm's input at
  the positions the head reads, ``x`` (B, D).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

Reader = Callable[[str, Dict[str, object]], None]

#: the active reader, or None
READER: Optional[Reader] = None


@contextlib.contextmanager
def reading(fn: Reader):
    """Hand every tap site's values to ``fn`` while active."""
    global READER
    prev, READER = READER, fn
    try:
        yield
    finally:
        READER = prev


def emit(site: str, **values) -> None:
    """Hand ``values`` to the reader, if one is active."""
    if READER is not None:
        READER(site, values)
