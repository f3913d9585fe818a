"""The bulk-bitwise query engine under closed-loop batches of range
queries: `QueryService.query_batch` -> planner -> optimizer (CSE) ->
`Scheduler._run_group` -> the VM kernel.

The general generator of ``traffic/<mix>.json`` with ``"generator":
"query_batches"``: each batch holds one query per shape, each a
conjunction of one range per column; a shape lists its candidate ranges
per column, and each shape's candidates come in cycles, each cycle in an
order drawn from the seed (`Bench.draw`).
``"mode"`` is ``"popcount"`` (counts) or ``"materialize"`` (selection
bitmaps, returned as the program returns them; dropped after the next
batch, but for ``kept_batches`` batches drawn from the first
``kept_from``, which the check compares bit for bit). One client sends
each batch once it has the last one's answers.

The configuration's ``service`` goes to the port's `ServiceConfig` whole
(a ``reliability`` group as its `ReliabilityConfig`). A key of a
configuration, a column, the service, a mix or a shape that this driver
does not read, or a mode it does not know, is refused at construction:
a file that asks for what the driver would not do is not run without it.

Set-up registers the configuration's columns (drawn on the device from
the seed), plans every candidate once (prepared statements) and runs
``warmup_batches`` batches (kernels built and loaded). The check draws
the columns again and counts (or selects) with the plain reference.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import counts, data, harness
from perfbench.harness import log
from perfbench.spans import Spans
from perfbench.reference import ssb as ref


#: the keys each file holds; the others of the configuration document it
CONFIG_KEYS = ("name", "system", "source", "scale_factor", "rows", "columns",
               "layout", "service", "guarantees", "reduced", "reduced_why",
               "assumed", "scale_why", "footprint")
COLUMN_KEYS = ("name", "bits", "min", "max", "encoding")
TRAFFIC_KEYS = ("generator", "about", "mode", "warmup", "warmup_batches",
                "profile_units", "kept_batches", "kept_from", "shapes")
SHAPE_KEYS = ("name", "ssb", "ranges")
#: a mix's ``mode`` -> the port's query mode of that name
MODES = {"popcount": "POPCOUNT", "materialize": "MATERIALIZE"}
#: `ServiceConfig` fields that are objects of the benchmark or the program
NOT_DATA = ("device", "telemetry", "timing", "fault_tolerance", "slo")


def service_config(service, device: str, telemetry):
    """The configuration's ``service`` as the port's `ServiceConfig`: every
    key passed on, so one that the port does not know fails here."""
    from repro_torch.core.errors import ReliabilityConfig
    from repro_torch.service import ServiceConfig

    kw = dict(service)
    bad = [k for k in NOT_DATA if k in kw]
    if "reliability" in kw:
        if "model" in kw["reliability"]:
            bad.append("reliability.model")
        kw["reliability"] = ReliabilityConfig(**kw["reliability"])
    if bad:
        raise ValueError(f"service: {bad} are not set from a file")
    return ServiceConfig(device=device, telemetry=telemetry, **kw)


def _wall_tracer():
    """The program's tracer keeping its wall-clock spans only: the
    modeled DRAM timeline (two events per 8 KB row block and query) would
    hold millions of events a batch at a deployment's size."""
    from repro_torch.obs.trace import Tracer

    class WallTracer(Tracer):
        def model_event(self, *args, **kwargs):
            pass

        def counter_event(self, *args, **kwargs):
            pass

    return WallTracer()


def span_seconds(events, name: str) -> float:
    """Seconds inside outermost ``name`` spans of the program's tracer
    (its B / E events, nested by stack discipline)."""
    stack: List[Tuple[str, float]] = []
    total = 0.0
    for ev in events:
        if ev.get("pid") != 1:
            continue
        if ev["ph"] == "B":
            stack.append((ev["name"], ev["ts"]))
        elif ev["ph"] == "E" and stack:
            n, ts = stack.pop()
            if n == name and all(m != name for m, _ in stack):
                total += (ev["ts"] - ts) * 1e-6
    return total


class Bench:
    unit_label = "query_batch"
    labels = (unit_label,)
    spans = Spans(())

    def __init__(self, config, traffic, cell, seed, device, overrides):
        if traffic["generator"] != "query_batches":
            raise ValueError(f"the query driver reads query_batches mixes, "
                             f"not {traffic['generator']!r}")
        harness.known_keys(config, CONFIG_KEYS, f"configs/{config['name']}")
        for col in config["columns"]:
            harness.known_keys(col, COLUMN_KEYS, f"column {col['name']}")
        harness.known_keys(traffic, TRAFFIC_KEYS, "the mix")
        for shape in traffic["shapes"]:
            harness.known_keys(shape, SHAPE_KEYS, f"shape {shape['name']}")
        if traffic["mode"] not in MODES:
            raise ValueError(f"the query driver runs the modes "
                             f"{sorted(MODES)}, not {traffic['mode']!r}")
        self.config, self.traffic, self.cell = config, traffic, cell
        self.seed, self.device = seed, torch.device(device)
        self.mode = MODES[traffic["mode"]]
        self.rows = int(overrides.get("rows", config["rows"]))
        if self.rows % 32:
            raise ValueError("rows must fill whole 32-bit words")
        self.control = bool(overrides.get("control", False))
        self.select = self.mode == "MATERIALIZE"
        self.profile_units = int(traffic["profile_units"])
        self.bits = {c["name"]: c["bits"] for c in config["columns"]}
        # candidates[s][k]: {column: (lo, hi)}
        self.candidates = []
        for shape in traffic["shapes"]:
            cols = list(shape["ranges"])
            n = max(len(shape["ranges"][c]) for c in cols)
            self.candidates.append([
                {c: tuple(shape["ranges"][c][k % len(shape["ranges"][c])])
                 for c in cols} for k in range(n)])
        self.bytes = [[counts.query_bytes(self.rows, self.bits, r,
                                          self.select) for r in shape]
                      for shape in self.candidates]
        self.kept_ids = set()
        if self.select:
            rng = np.random.default_rng(data.subseed(seed, "kept"))
            self.kept_ids = set(int(i) for i in rng.choice(
                traffic["kept_from"], traffic["kept_batches"],
                replace=False))
        self.n_queries = self.n_groups = self.n_bytes = 0
        self.latencies: List[float] = []
        self.answers: List[Tuple[Tuple[int, ...], List[int]]] = []
        self.kept: Dict[int, Tuple[Tuple[int, ...], list]] = {}
        self.last = None

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        if self.control:
            self.codes = self._codes()
            return
        from repro_torch.obs.telemetry import Telemetry
        from repro_torch.service import QueryService

        self.telemetry = Telemetry(trace=True)
        self.telemetry.tracer = _wall_tracer()
        self.telemetry.tracing = False
        self.svc = QueryService(service_config(
            self.config["service"], str(self.device), self.telemetry))
        t0 = time.perf_counter()
        for col, values in data.ssb_columns(self.config, self.rows,
                                            self.seed, self.device):
            self.svc.register_column(col["name"], values, col["bits"])
            del values
        self.sync()
        log(f"columns drawn and registered in {time.perf_counter() - t0:.3f} s")
        sched = self.svc.scheduler
        self.spans = Spans([
            (self.svc.planner, "plan", "planner.plan"),
            (sched, "_apply_cse", "scheduler.cse_pass"),
            (sched, "_run_group", "scheduler.run_group"),
            (sched, "_place_batch", "scheduler.modeled_timeline")])
        self.labels = (self.unit_label,) + self.spans.labels
        self.exprs = [[self._expr(r) for r in shape]
                      for shape in self.candidates]
        from repro_torch.service import Query

        t0 = time.perf_counter()
        self.svc.scheduler.plan_queries(
            [Query(e) for shape in self.exprs for e in shape])
        t1 = time.perf_counter()
        for k in range(int(self.traffic["warmup_batches"])):
            self._serve(tuple(k % len(s) for s in self.candidates))
        self.last = None
        log(f"candidates planned in {t1 - t0:.3f} s, warm-up batches in "
            f"{time.perf_counter() - t1:.3f} s")

    def _expr(self, ranges):
        e = None
        for c, (lo, hi) in ranges.items():
            t = self.svc.range_scan_query(c, lo, hi)
            e = t if e is None else e & t
        return e

    def _codes(self) -> Dict[str, torch.Tensor]:
        """The columns again, each in the narrowest integer type."""
        out = {}
        for col, values in data.ssb_columns(self.config, self.rows,
                                            self.seed, self.device):
            dt = torch.uint8 if col["max"] < 256 else torch.int16
            out[col["name"]] = values.to(dt)
            del values
        return out

    # -- the window -----------------------------------------------------------

    def draw(self, i: int) -> Tuple[int, ...]:
        """Batch i's candidate of each shape. Each shape runs through its
        candidates in cycles, each cycle in an order drawn from the seed:
        every seed serves the same candidates as often, in another order
        and pairing."""
        out = []
        for s, shape in enumerate(self.candidates):
            cycle, k = divmod(i, len(shape))
            rng = np.random.default_rng(data.subseed(self.seed, "cycle", s,
                                                     cycle))
            out.append(int(rng.permutation(len(shape))[k]))
        return tuple(out)

    def _serve(self, ids):
        from repro_torch import service

        mode = getattr(service, self.mode)
        queries = [service.Query(self.exprs[s][k], mode)
                   for s, k in enumerate(ids)]
        report = self.svc.query_batch(queries)
        self.last = report      # the previous batch's results go here
        return report

    def unit(self, i: int) -> None:
        ids = self.draw(i)
        t0 = time.perf_counter()
        if self.control:
            scalars, words = self._control_answers(ids)
            groups = 0
        else:
            report = self._serve(ids)
            scalars = [r.scalar for r in report.results]
            words = ([r.value for r in report.results] if self.select
                     else None)
            groups = report.n_plan_groups
        wall = time.perf_counter() - t0
        self.latencies += [wall] * len(ids)
        self.answers.append((ids, scalars))
        if i in self.kept_ids:
            self.kept[i] = (ids, words)
        self.n_queries += len(ids)
        self.n_groups += groups
        self.n_bytes += sum(self.bytes[s][k] for s, k in enumerate(ids))

    def _control_answers(self, ids):
        """The reference with the date column held at one bit less (the
        lowest plane dropped): the control, in the program's place."""
        scalars, words = [], []
        for s, k in enumerate(ids):
            r = self.candidates[s][k]
            scalars.append(ref.count(self.codes, r, coarse=("lo_orderdate",)))
            if self.select:
                w = ref.bitmap_words(self.codes, r, coarse=("lo_orderdate",))
                words.append(w.cpu().numpy().view(np.uint32))
        return scalars, words

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def counters(self) -> Dict[str, float]:
        return {"queries": self.n_queries, "plan_groups": self.n_groups,
                "bytes": self.n_bytes}

    def trace_on(self) -> None:
        if not self.control:
            self.telemetry.tracer.reset()
            self.telemetry.tracing = True

    def trace_off(self) -> Dict[str, float]:
        if self.control:
            return {}
        self.telemetry.tracing = False
        out = {"plan": span_seconds(self.telemetry.tracer.events, "plan")}
        self.telemetry.tracer.reset()
        return out

    def samples(self) -> Dict[str, List[float]]:
        """Each query's latency in seconds: its batch's wall."""
        return {"query_latency_s": self.latencies}

    def e2e(self, win) -> Dict[str, float]:
        return {"queries_per_s": self.n_queries / win["seconds"]}

    def attempted(self) -> Tuple[int, int]:
        return self.n_queries, 0

    def close(self) -> None:
        self.last = None
        for name in ("svc", "exprs", "telemetry", "codes"):
            if hasattr(self, name):
                delattr(self, name)

    # -- the check ------------------------------------------------------------

    def check(self) -> Dict[str, Tuple[float, float]]:
        """Every count of the window against the plain reference, and in
        select mode the kept bitmaps bit for bit."""
        codes = self._codes()
        want: Dict[Tuple[int, int], int] = {}
        wrong = 0
        for ids, scalars in self.answers:
            for s, (k, got) in enumerate(zip(ids, scalars)):
                if (s, k) not in want:
                    want[(s, k)] = ref.count(codes, self.candidates[s][k])
                wrong += int(got != want[(s, k)])
        limits = self.cell["limits"]
        out = {"wrong_counts": (wrong, limits["wrong_counts"])}
        if self.select:
            bad = 0
            for ids, words in self.kept.values():
                for s, (k, w) in enumerate(zip(ids, words)):
                    mine = ref.bitmap_words(codes, self.candidates[s][k])
                    got = torch.from_numpy(
                        np.ascontiguousarray(w).view(np.int32)).to(
                            mine.device)
                    bad += int(not torch.equal(got, mine))
            out["wrong_bitmaps"] = (bad, limits["wrong_bitmaps"])
        return out
