"""The general runner: find a cell's files by name, drive its window,
read its metrics, decide ``correct``, print the result line.

A cell is an entry of `BENCHMARK.json`'s ``workloads``. Its configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``) and
cell file (``cells/<cell>.json``: the driver and the correctness limits)
are found by name, as is each metric's reader (``metrics/<name>.py``,
a ``read(ctx)`` that returns a number or None). A driver
(``drivers/<driver>.py``) exposes ``Bench(config, traffic, cell, seed,
device, overrides)`` with:

* ``setup()``: make the inputs and weights from the seed, load the
  program, warm up every shape the window uses;
* ``unit(i)``: one unit of closed-loop work (a batch of queries, a
  training step, a request), the i-th of the run;
* ``sync()``, ``counters()`` (cumulative counts of the work done),
  optionally ``samples()`` (cumulative lists of per-item readings, such
  as each query's latency, by name),
  ``trace_on()`` / ``trace_off()`` (the program's own spans, as
  ``{name: seconds}``), ``spans`` (a `perfbench.spans.Spans` of the
  benchmark's labels around the program's layers) and ``labels``,
  ``e2e(win)`` (the end-to-end metrics of the window);
* ``close()``: free the program's state; ``check()``: compare what the
  window produced with the plain reference, as ``{name: (value,
  limit)}``.

A run with ``--trace 1`` runs the first half of the window untraced (the
metrics over the whole window read it), then profiles a stretch of the
traffic's ``profile_units`` units with `torch.profiler` (the device's
activity, and the program's own spans), then as many again with the
host's activity and the benchmark's spans (``bench.spans``, to name the
device's idle gaps), and ends.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
#: modules whose presence in the run's process refuses the result: the
#: JAX reference package and JAX itself, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_manifest() -> Dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def load_module(path: Path):
    """A benchmark module from its file (names may hold dots)."""
    name = "perfbench_file_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def known_keys(d: Dict, allowed, what: str) -> None:
    """Raise where ``d`` holds a key that its driver does not read: a file
    that asks for what the driver would not do is refused, not run
    without it."""
    extra = sorted(set(d) - set(allowed))
    if extra:
        raise ValueError(f"{what}: no driver reads {extra}")


def cell_spec(manifest: Dict, name: str) -> Dict:
    """The workload entry ``name`` with its cell file's keys."""
    for w in manifest["workloads"]:
        if w["name"] == name:
            spec = dict(w)
            spec.update(load_json(ROOT / "cells" / f"{name}.json"))
            return spec
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest: Dict, cell: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` entries that list ``cell``, or
    that list no cells (``setup_s``: every cell reports it)."""
    return [m for m in manifest[kind]
            if cell in m.get("workloads", [cell])]


class Context:
    """What a per-layer metric's reader sees: the cell's files, the card's
    peaks, the untraced part of the window (``pre``) and the profiled
    stretch (``stretch``), each with the driver's counters over it."""

    def __init__(self, config, traffic, cell, peaks, pre, stretch):
        self.config, self.traffic, self.cell = config, traffic, cell
        self.peaks = peaks
        self.pre = pre
        self.stretch = stretch


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def _diff(after: Dict, before: Dict) -> Dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _samples(bench) -> Dict[str, list]:
    return bench.samples() if hasattr(bench, "samples") else {}


def profile_stretch(bench, start: int, units: int, cuda: bool) -> Dict:
    """``units`` units from ``start`` under `torch.profiler` recording the
    device alone (its host cost would read as idle device time), with the
    program's spans on: the stretch's counters, spans and device trace.
    On a card, ``units`` more then run with the host's activity recorded
    too and the benchmark's spans around the program's layers on, to name
    what the host was doing while the device idled."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import devtrace

    bench.sync()
    before = bench.counters()
    bench.trace_on()
    device = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[device]) as prof:
        t0 = time.perf_counter()
        for i in range(start, start + units):
            bench.unit(i)
        bench.sync()
        wall = time.perf_counter() - t0
    spans = bench.trace_off()
    out = devtrace.reduce(prof, wall, labels=bench.labels)
    del prof
    out.update(seconds=wall, units=units, spans=spans,
               counters=_diff(bench.counters(), before))
    if cuda:
        bench.spans.on()
        try:
            with profile(activities=[ProfilerActivity.CPU, device]) as prof:
                t0 = time.perf_counter()
                for i in range(start + units, start + 2 * units):
                    with record_function(bench.unit_label):
                        bench.unit(i)
                bench.sync()
                wall = time.perf_counter() - t0
        finally:
            bench.spans.off()
        out["idle_gaps"] = devtrace.reduce(prof, wall,
                                           labels=bench.labels)["idle_gaps"]
        out["units"] = 2 * units
    return out


def window(bench, seconds: float, trace: bool, cuda: bool) -> Dict:
    """The closed loop: units until ``seconds`` have passed, the last one
    finished; with ``trace``, the profiled stretch at half time ends it."""
    before = bench.counters()
    first = {k: len(v) for k, v in _samples(bench).items()}
    t0 = time.perf_counter()
    i = 0
    stretch = None
    while True:
        t = time.perf_counter() - t0
        if trace and t >= seconds / 2:
            bench.sync()
            pre_s = time.perf_counter() - t0
            pre = {"seconds": pre_s, "units": i,
                   "counters": _diff(bench.counters(), before),
                   "samples": {k: list(v[first.get(k, 0):])
                               for k, v in _samples(bench).items()}}
            stretch = profile_stretch(bench, i, bench.profile_units, cuda)
            i += stretch["units"]
            break
        if t >= seconds:
            break
        bench.unit(i)
        i += 1
    bench.sync()
    elapsed = time.perf_counter() - t0
    if stretch is None:
        pre = {"seconds": elapsed, "units": i,
               "counters": _diff(bench.counters(), before),
               "samples": {k: list(v[first.get(k, 0):])
                           for k, v in _samples(bench).items()}}
    return {"seconds": elapsed, "units": i, "pre": pre, "stretch": stretch}


def power_limit() -> Optional[str]:
    """The card's power limit as `nvidia-smi` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda",
             overrides: Optional[Dict] = None,
             manifest: Optional[Dict] = None) -> Dict:
    """Run cell ``name`` and return its result line as a dict.

    ``overrides`` (smaller sizes for a rehearsal on the CPU, or
    ``{"control": True}``: the reference in the program's place, computed
    in a precision below the configuration's) are for the tests and the
    control's runs; a benchmark run passes none."""
    import torch

    from perfbench import peaks as peaks_mod

    manifest = manifest or load_manifest()
    spec = cell_spec(manifest, name)
    config = load_json(ROOT / "configs" / f"{spec['config']}.json")
    traffic = load_json(ROOT / "traffic" / f"{spec['traffic']}.json")
    driver = load_module(ROOT / "drivers" / f"{spec['driver']}.py")
    cuda = device.startswith("cuda")
    bench = driver.Bench(config, traffic, spec, seed, device,
                         overrides or {})
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bench.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")
    win = window(bench, seconds, trace, cuda)
    log(f"window {win['seconds']:.3f} s, {win['units']} units")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    peaks = peaks_mod.for_card(kind) if cuda else None
    metrics: Dict[str, Dict] = {}
    if not trace:
        values = bench.e2e(win)
        values["setup_s"] = setup_s
        for m in metrics_of(manifest, name, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = Context(config, traffic, spec, peaks, win["pre"],
                      win["stretch"])
        for m in metrics_of(manifest, name, "per_layer"):
            reader = load_module(ROOT / "metrics" / f"{m['name']}.py")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted, failed = bench.attempted()
    bench.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = bench.check()
    log(f"check {time.perf_counter() - t_check:.3f} s")
    correct = all(v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": spec["chips"], "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit"] = power_limit()
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev,
           "window": {"seconds": win["seconds"], "units": win["units"]}}
    if trace:
        st = win["stretch"]
        dev["busy_s"] = st["busy_s"]
        dev["window_s"] = st["window_s"]
        out["breakdown"] = {"device_ops": st["device_ops"],
                            "idle_gaps": st["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    manifest = load_manifest()
    spec = cell_spec(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < spec["chips"]:
        print(f"perfbench: {args.workload} needs {spec['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), t0, manifest=manifest)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; the benchmark "
              "measures the port alone", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
