"""Structured tracer: per-query span trees + modeled timelines, exported as
Chrome trace-event JSON (loadable in `chrome://tracing` / Perfetto).

Two clocks share one trace:

  * **wall events** (pid `WALL_PID`) — `begin`/`end`/`span` record real
    `time.perf_counter` durations of serving stages (parse -> plan/cache ->
    bind -> group -> dispatch -> readout), nested by stack discipline on
    one thread track;
  * **modeled events** (pid `MODEL_PID`) — `model_event` places duration
    events on *virtual* tracks at modeled-nanosecond timestamps: the
    scheduler's per-chip bus / per-bank compute timeline, per-query
    latency summaries, and the cluster's tree-psum reduction hops. The
    modeled clock starts at 0 per batch epoch.

Every emitted event carries ``name``/``ph``/``ts``/``pid``/``tid`` (the
schema `validate_chrome_trace` enforces and tests/test_obs.py pins down);
``ts`` is microseconds as the trace-event spec requires, so modeled
nanoseconds are divided by 1e3 on the way out.

`NULL_TRACER` is the disabled twin: `tracing` is False and every method is
a no-op. Instrumentation sites must guard anything that allocates (kwargs
dicts, f-strings) behind ``if tracer.tracing:`` so the disabled serving
path stays allocation-free — the contract `benchmarks/obs_overhead.py`
gates at < 3% overhead.

**One clock with the device trace.** While a `torch.profiler` session
records (``torch.autograd.profiler._is_profiler_enabled``, the flag the
profiler sets on entry and clears on exit), every wall-clock span of the
port also opens a `record_function` range of the same name, whether or
not a tracer is on, so the spans sit in the profiler's own event stream
beside the kernels they launch. `open_span` / `close_span` keep the open spans on a stack
per thread (a collector callback or the autograd engine's thread opens
its own); `Telemetry.span` / `begin` / `end` are the sites' entry points.
While `obs.device` records a window, each span also marks its edges
there (CUDA events), read once when the window ends.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

from torch.autograd import profiler as _autograd_profiler

from repro_torch.obs import device as _device

WALL_PID = 1
MODEL_PID = 2

Json = Dict[str, Union[str, int, float, dict]]


class Tracer:
    """Records Chrome trace events; single-threaded stack discipline."""

    tracing = True

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        """Drop all recorded events and restart the wall clock at 0."""
        self.events: List[Json] = []
        self._open = 0                  # B events awaiting their E
        self._tids: Dict[Tuple[int, str], int] = {}
        self._t0 = self._clock()
        self._meta(WALL_PID, "process_name", name="serving (wall clock)")
        self._meta(MODEL_PID, "process_name", name="modeled DRAM timeline")
        self._tid(WALL_PID, "serve")    # the one real thread

    # -- plumbing ------------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _meta(self, pid: int, kind: str, tid: int = 0, **args) -> None:
        self.events.append({"name": kind, "ph": "M", "ts": 0.0,
                            "pid": pid, "tid": tid, "args": args})

    def _tid(self, pid: int, track: str) -> int:
        """Stable per-(pid, track-name) thread id + its metadata event."""
        key = (pid, track)
        tid = self._tids.get(key)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[key] = tid
            self._meta(pid, "thread_name", tid=tid, name=track)
        return tid

    # -- wall-clock spans ----------------------------------------------------

    def begin(self, name: str, **args) -> None:
        self._open += 1
        self.events.append({"name": name, "ph": "B", "ts": self._now_us(),
                            "pid": WALL_PID, "tid": self._tids[(WALL_PID,
                                                                "serve")],
                            "args": args})

    def end(self, **args) -> None:
        if self._open <= 0:
            raise ValueError("Tracer.end() without a matching begin()")
        self._open -= 1
        self.events.append({"name": "", "ph": "E", "ts": self._now_us(),
                            "pid": WALL_PID, "tid": self._tids[(WALL_PID,
                                                                "serve")],
                            "args": args})

    @contextlib.contextmanager
    def span(self, name: str, **args):
        self.begin(name, **args)
        try:
            yield self
        finally:
            self.end()

    def instant(self, name: str, **args) -> None:
        self.events.append({"name": name, "ph": "i", "ts": self._now_us(),
                            "pid": WALL_PID,
                            "tid": self._tids[(WALL_PID, "serve")],
                            "s": "t", "args": args})

    # -- modeled timeline ----------------------------------------------------

    def model_event(self, name: str, ts_ns: float, dur_ns: float,
                    track: str, **args) -> None:
        """A duration ("X") event at modeled time on a named virtual track
        (e.g. ``chip0/bus``, ``chip0/bank3``, ``reduce``)."""
        self.events.append({"name": name, "ph": "X", "ts": ts_ns / 1e3,
                            "dur": dur_ns / 1e3, "pid": MODEL_PID,
                            "tid": self._tid(MODEL_PID, track),
                            "args": args})

    def counter_event(self, name: str, ts_ns: float, track: str,
                      **values) -> None:
        """A counter ("C") sample at modeled time: Chrome renders each
        named series (queue depth, occupancy, ...) as a stacked area
        chart over the timeline. Values must be numeric."""
        self.events.append({"name": name, "ph": "C", "ts": ts_ns / 1e3,
                            "pid": MODEL_PID,
                            "tid": self._tid(MODEL_PID, track),
                            "args": values})

    # -- export --------------------------------------------------------------

    def export(self) -> Json:
        """The Chrome trace payload (open spans are NOT auto-closed)."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}


class NullTracer:
    """Disabled tracer: every method is a cheap no-op."""

    tracing = False
    events: List[Json] = []

    def reset(self) -> None:
        pass

    def begin(self, name: str, **args) -> None:
        pass

    def end(self, **args) -> None:
        pass

    def span(self, name: str, **args):
        return _NULL_CM

    def instant(self, name: str, **args) -> None:
        pass

    def model_event(self, name: str, ts_ns: float, dur_ns: float,
                    track: str, **args) -> None:
        pass

    def counter_event(self, name: str, ts_ns: float, track: str,
                      **values) -> None:
        pass

    def export(self) -> Json:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


class _ReusableNullCM:
    """A single shared no-op context manager (no per-use allocation)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CM = _ReusableNullCM()
NULL_TRACER = NullTracer()


class _OpenSpans(threading.local):
    """Each thread's open spans: ``(tracer or None, profiler range or
    None, device edge or None)``, innermost last."""

    def __init__(self):
        self.stack: List[Tuple[Optional[Tracer], object, object]] = []


_OPEN = _OpenSpans()


def open_span(tracer: Optional[Tracer], name: str, args: Dict) -> int:
    """Open span ``name``: a B event on ``tracer`` (None: no tracer
    event), while a profiler records a profiler range of the same name,
    and while `obs.device` records a window the span's first edge.
    Returns the thread's span depth before it, for `close_span`."""
    stack = _OPEN.stack
    depth = len(stack)
    rf = None
    if _autograd_profiler._is_profiler_enabled:
        rf = _autograd_profiler.record_function(name)
        rf.__enter__()
    if tracer is not None:
        tracer.begin(name, **args)
    rec = _device.RECORDER
    stack.append((tracer, rf, None if rec is None else (rec, rec.open(name))))
    return depth


def close_span(depth: Optional[int] = None) -> None:
    """Close the innermost open span, or with ``depth`` every span
    opened since `open_span` returned it (an exception may have skipped
    inner ends)."""
    stack = _OPEN.stack
    stop = len(stack) - 1 if depth is None else depth
    while len(stack) > stop:
        tracer, rf, edge = stack.pop()
        if edge is not None:
            edge[0].close(edge[1])
        if tracer is not None:
            tracer.end()
        if rf is not None:
            rf.__exit__(None, None, None)


class Span:
    """A span site's context manager (`Telemetry.span` builds it only
    when the span is recorded somewhere)."""

    __slots__ = ("tracer", "name", "args", "depth")

    def __init__(self, tracer: Optional[Tracer], name: str, args: Dict):
        self.tracer, self.name, self.args = tracer, name, args
        self.depth = 0

    def __enter__(self):
        self.depth = open_span(self.tracer, self.name, self.args)
        return self

    def __exit__(self, *exc):
        close_span(self.depth)
        return False


def validate_chrome_trace(payload: Json) -> None:
    """Raise ValueError unless `payload` is schema-valid trace-event JSON.

    Enforced: a ``traceEvents`` list; every event has ``name``/``ph``/
    ``ts``/``pid``/``tid`` with numeric non-negative ``ts``; ``X`` events
    carry a non-negative ``dur``; ``C`` counter samples carry an args
    dict of numeric series values; ``B``/``E`` events balance with LIFO
    discipline per ``(pid, tid)`` track. This is the schema test the
    acceptance criteria (and any trace consumer) rely on.
    """
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("payload has no traceEvents list")
    stacks: Dict[Tuple, int] = {}
    for i, ev in enumerate(events):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} has bad ts {ev['ts']!r}")
        ph = ev["ph"]
        key = (ev["pid"], ev["tid"])
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"X event {i} has bad dur: {ev}")
        elif ph == "C":
            args = ev.get("args")
            if (not isinstance(args, dict) or not args
                    or not all(isinstance(v, (int, float))
                               for v in args.values())):
                raise ValueError(f"C event {i} needs numeric args: {ev}")
        elif ph == "B":
            stacks[key] = stacks.get(key, 0) + 1
        elif ph == "E":
            depth = stacks.get(key, 0)
            if depth <= 0:
                raise ValueError(f"E event {i} closes nothing on {key}")
            stacks[key] = depth - 1
    unbalanced = {k: d for k, d in stacks.items() if d}
    if unbalanced:
        raise ValueError(f"unclosed B events per track: {unbalanced}")


def write_chrome_trace(payload: Json, path) -> pathlib.Path:
    """Validate and write a trace payload to `path` as JSON."""
    validate_chrome_trace(payload)
    p = pathlib.Path(path)
    p.write_text(json.dumps(payload) + "\n")
    return p
