"""Reduce a `torch.profiler` trace of a stretch of the window to what the
per-layer metrics and the result's breakdown read.

* ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device;
* ``kernels``: device seconds by name (kernels, copies and memsets);
* ``device_ops``: the ten names that took the most device time;
* ``idle_gaps``: the device's idle time within the stretch, summed by
  what the host was doing at the middle of each gap (the innermost host
  event then open: an aten op, or a ``record_function`` label of the
  harness), the ten largest.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

#: longest kernel name kept in the breakdown
NAME_CHARS = 160
#: what a gap is charged to when no host event is open at its middle
NO_HOST_EVENT = "host (no torch op open)"


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _label_gaps(gaps: List[Tuple[float, float]],
                host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle seconds by the innermost host event open at each gap's
    middle (a sweep over both sorted by time)."""
    host = sorted(host)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    by_label: Dict[str, float] = {}
    open_: List[Tuple[float, float, float, str]] = []   # (end, -, start, name)
    k = 0
    for i in order:
        s, e = gaps[i]
        mid = (s + e) / 2
        while k < len(host) and host[k][0] <= mid:
            hs, he, name = host[k]
            heapq.heappush(open_, (he, -hs, hs, name))
            k += 1
        while open_ and open_[0][0] < mid:
            heapq.heappop(open_)
        label = NO_HOST_EVENT
        if open_:
            inner = min(open_, key=lambda x: x[0] - x[2])
            label = inner[3]
        by_label[label] = by_label.get(label, 0.0) + (e - s) * 1e-6
    return by_label


def reduce(prof, wall_s: float, labels=()) -> Dict:
    """The stretch's device activity from a finished profiler ``prof``;
    ``wall_s`` is the stretch's length on the host clock. The device
    rows that mirror a ``record_function`` label (user annotations, also
    those named in ``labels``) span work, not device activity, and are
    left out."""
    from torch.autograd import DeviceType

    device: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    kernels: Dict[str, float] = {}
    t_first = t_last = None
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        t_first = s if t_first is None else min(t_first, s)
        t_last = e if t_last is None else max(t_last, e)
        if ev.device_type == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or ev.name in labels:
                continue
            device.append((s, e))
            kernels[ev.name] = kernels.get(ev.name, 0.0) + (e - s) * 1e-6
        elif ev.device_type == DeviceType.CPU:
            host.append((s, e, ev.name))
    busy = _merge(device)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps: List[Tuple[float, float]] = []
    if busy:
        edges = [(t_first, t_first)] + busy + [(t_last, t_last)]
        gaps = [(a[1], b[0]) for a, b in zip(edges, edges[1:])
                if b[0] > a[1]]
    idle = _label_gaps(gaps, host)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": wall_s,
        "kernels": kernels,
        "device_ops": [[n[:NAME_CHARS], s] for n, s in top],
        "idle_gaps": [[n[:NAME_CHARS], s] for n, s in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def seconds_matching(kernels: Dict[str, float], patterns) -> float:
    """Device seconds of the kernels whose names contain any pattern."""
    return sum(s for n, s in kernels.items()
               if any(p in n for p in patterns))
