"""Device work by the program's own span: each kernel, copy and memset
of a `torch.profiler` trace charged to the innermost program range open
around its launch on the host.

The port's spans (`repro_torch.obs`: ``batch``, ``cse_pass``, ``place``,
``gc``, ``step.grads``, ``step.clip``, ``step.update``, ...) are
``record_function`` ranges while a profiler records, so they sit in the
profiler's event stream beside the kernels. A device event shares its
``id`` (the CUDA correlation id) with the runtime or driver call that
launched it (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``,
...), and that call's start is the launch time. Ranges named in
``labels`` (the harness's own spans around the program's layers) are
passed over, so a launch is charged to the program's span inside them.

Use it on a profile that recorded host and device activity, as the
harness's second stretch does::

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ...
    by_span(prof.events(), labels=bench.labels)
    # {"step.update": {"device_s": 0.41, "launches": 9120}, ...}

A profile without host activity has no ranges: everything lands under
``NO_SPAN``.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

#: what device work is charged to when no program range is open around
#: its launch (or its launch call was not recorded)
NO_SPAN = "(no program span)"
#: the prefix of the CUDA runtime and driver calls that launch device work
LAUNCH_CALL = "cu"


def _innermost(points: List[Tuple[float, int]],
               ranges: List[Tuple[float, float, str]]) -> Dict[int, str]:
    """For each ``(time, key)`` point, the name of the shortest range
    ``(start, end, name)`` that holds it (a sweep over both sorted by
    time); points outside every range are left out."""
    ranges = sorted(ranges)
    out: Dict[int, str] = {}
    open_: List[Tuple[float, float, str]] = []   # (end, start, name)
    k = 0
    for t, key in sorted(points):
        while k < len(ranges) and ranges[k][0] <= t:
            rs, re_, name = ranges[k]
            heapq.heappush(open_, (re_, rs, name))
            k += 1
        while open_ and open_[0][0] < t:
            heapq.heappop(open_)
        if open_:
            out[key] = min(open_, key=lambda x: x[0] - x[1])[2]
    return out


def by_span(events, labels=()) -> Dict[str, Dict[str, float]]:
    """Device seconds and launches by the innermost program range open
    around each launch, ``{span: {"device_s", "launches"}}``.
    ``events`` are a profiler's `FunctionEvent`-like records: ``name``,
    ``id``, ``device_type``, ``time_range`` and ``is_user_annotation``."""
    from torch.autograd import DeviceType

    ranges: List[Tuple[float, float, str]] = []
    launch_at: Dict[int, float] = {}
    work: List[Tuple[int, float]] = []      # (id, device seconds)
    for ev in events:
        annotation = getattr(ev, "is_user_annotation", False)
        if ev.device_type == DeviceType.CUDA:
            if not annotation and ev.name not in labels:
                work.append((ev.id, (ev.time_range.end
                                     - ev.time_range.start) * 1e-6))
        elif ev.device_type == DeviceType.CPU:
            if annotation:
                if ev.name not in labels:
                    ranges.append((ev.time_range.start, ev.time_range.end,
                                   ev.name))
            elif ev.name.startswith(LAUNCH_CALL):
                launch_at[ev.id] = ev.time_range.start
    where = _innermost([(launch_at[i], i) for i in
                        {i for i, _ in work if i in launch_at}], ranges)
    out: Dict[str, Dict[str, float]] = {}
    for i, secs in work:
        row = out.setdefault(where.get(i, NO_SPAN),
                             {"device_s": 0.0, "launches": 0})
        row["device_s"] += secs
        row["launches"] += 1
    return out
