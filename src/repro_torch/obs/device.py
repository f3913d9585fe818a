"""Device time of the port's spans and device-side counters over a window.

Between `start(device)` and `stop()`, every span the port opens
(`Telemetry.span`, `begin` / `end`, through `trace.open_span`) also
records a CUDA event at each of its edges on the current stream, and
`count(name, value)` adds ``value`` (a host number, or a 0-d tensor on
the device, summed there) to a counter. Nothing waits for the device
until `stop()`, which synchronises once and returns ``{"spans": {name:
device seconds between the edges, summed}, "counters": {name: value}}``.
On a CPU device the edges are host clock readings (the CPU runs each op
before returning). Off, a site costs one check of `RECORDER`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import torch


class Recorder:
    """One window's span edges and counters."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.edges: List[Tuple[str, object, object]] = []
        self.counters: Dict[str, Union[float, torch.Tensor]] = {}

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def open(self, name: str):
        return (name, self._mark())

    def close(self, token) -> None:
        self.edges.append((token[0], token[1], self._mark()))

    def add(self, name: str, value) -> None:
        prev = self.counters.get(name)
        self.counters[name] = value if prev is None else prev + value

    def read(self) -> Dict[str, Dict[str, float]]:
        if self.cuda:
            torch.cuda.synchronize()
        spans: Dict[str, float] = {}
        for name, a, b in self.edges:
            s = a.elapsed_time(b) * 1e-3 if self.cuda else b - a
            spans[name] = spans.get(name, 0.0) + s
        counters = {k: float(v) for k, v in self.counters.items()}
        return {"spans": spans, "counters": counters}


#: the window being recorded, or None
RECORDER: Optional[Recorder] = None


def start(device) -> None:
    """Record the spans' device time and the counters on ``device`` from
    now on (a window already open is dropped)."""
    global RECORDER
    RECORDER = Recorder(device)


def stop() -> Dict[str, Dict[str, float]]:
    """End the window: its spans' device seconds and its counters (empty
    when none was open)."""
    global RECORDER
    rec, RECORDER = RECORDER, None
    if rec is None:
        return {"spans": {}, "counters": {}}
    return rec.read()


def recording() -> bool:
    return RECORDER is not None


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` while a window records."""
    if RECORDER is not None:
        RECORDER.add(name, value)
