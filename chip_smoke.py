#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out DIR]      # from the root of a checkout

Phases; the first failure exits non-zero:

1. build   — ``nvcc`` every kernel under ``src/repro_torch/csrc/`` into
   ``build/``, all at once; print each build's time and the ``-Xptxas -v``
   register / shared-memory report.
2. kernels — each kernel against its plain PyTorch version on the card, bit
   for bit: the VM on tables lowered from the §8 templates (weekly OR
   tree, ``sum(col + col2)``, range scan, ``col < K & male``) at batch 1
   and 16, a word count that is not a multiple of the column block,
   popcount with a shared and with per-batch masks, materialize, fault
   masks; the bit transpose on 2**24 values and on a ragged count.
3. slice   — serve the §8 multi-tenant workload at full width (2**24-bit
   vectors) through ``build_service -> query_stream -> query_batch``, plus
   a batch of materialize queries. Every result must equal the unbatched
   micro-op interpreter (no VM, no kernel) on the card, and sum(col) and a
   weekly-OR count must equal numpy on the raw seeded data. Every kernel
   must have been launched while the slice ran.
4. numbers — replay every kernel launch of phase 3 with the same arguments,
   hold each to its plain version again (bit for bit, at the main path's
   shapes), time both with CUDA events, and print each kernel's total
   beside its bound (bytes over 3.35 TB/s or int32 operations over the
   card's integer rate, whichever is larger).

Output: the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and as the last line ``{"ok": true, "device": {...}}``. ``--out DIR``
also writes every launch's numbers to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: int32 lanes per Hopper SM (4 partitions x 16; Hopper white paper)
INT32_LANES_PER_SM = 64

KERNELS = {
    "vm_popcount": ("src/repro_torch/csrc/vm.cu",
                    "src/repro/kernels/vm.py:164"),
    "vm_materialize": ("src/repro_torch/csrc/vm.cu",
                       "src/repro/kernels/vm.py:164"),
    "bit_transpose": ("src/repro_torch/csrc/bittranspose.cu",
                      "src/repro/kernels/bittranspose.py:54"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build(build_mod) -> None:
    names = sorted(p.stem for p in build_mod.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    seconds = build_mod.build(names)
    print(f"[build] {len(names)} kernels in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name in names:
        print(f"[build] {name}.cu: " + (f"{seconds[name]:.1f} s"
                                       if name in seconds else "cached"))
        for line in build_mod.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "bytes stack" in line:
                print(f"[ptxas] {name}: {line.strip()}")
        build_mod.load(name)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _group(svc, texts):
    """Bound plans of one plan group and its per-query operand rows,
    exactly as the scheduler hands them to `lowering.vm_call`."""
    bound = [svc.scheduler.planner.plan(t, columns=svc.catalog.columns,
                                        names=svc.catalog) for t in texts]
    keys = {bp.plan.key for bp in bound}
    check(len(keys) == 1, f"templates {texts[:2]} do not share one plan")
    rows = [bp.input_map() for bp in bound]
    data = {n: [svc.catalog.get(r[n]).words for r in rows]
            for n in rows[0]}
    return bound[0].plan, data


def _compare(label, got, want, errs) -> None:
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: kernel {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    errs.append(err)
    check(torch.equal(got, want), f"{label}: kernel != plain "
          f"(max abs err {err})")


def phase_kernels(torch, svc, spec) -> int:
    from repro_torch.apps.bitmap_index import week_or
    from repro_torch.core import lowering
    from repro_torch.kernels import ref, vm
    from repro_torch.kernels.bittranspose import bit_transpose

    rng = np.random.default_rng(1234)
    words = svc.catalog.mask().shape[0]
    cols = vm.block_cols(35, 126, 8)
    check(words % cols != 0, f"{words} words is a multiple of {cols}")
    templates = {
        "week_or": lambda t: week_or(0, prefix=f"{t}/"),
        "add8": lambda t: f"sum({t}/col + {t}/col2)",
        "range_scan": lambda t: svc.range_scan_query(f"{t}/col", 37, 201),
        "lt_male": lambda t: f"{t}/col < 37 & {t}/male",
    }
    errs = []
    n_cases = 0
    for name, make in templates.items():
        for batch in (1, 16):
            tenants = [f"t{i % spec.n_tenants}" for i in range(batch)]
            plan, data = _group(svc, [make(t) for t in tenants])
            outs = list(plan.outputs)
            per_batch = torch.from_numpy(
                rng.integers(0, 1 << 32, (batch, words), dtype=np.uint32)
                .view(np.int32)).to(svc.device)
            cases = [("materialize", None, None),
                     ("popcount/shared-mask", "popcount", svc.catalog.mask()),
                     ("popcount/per-batch-mask", "popcount", per_batch)]
            for case, reduce, mask in cases:
                call = lowering.vm_call(plan.lowered, data, outputs=outs,
                                        mask=mask)
                got = call.run(vm.vm_megakernel, reduce)
                want = call.run(vm.vm_plain, reduce)
                _compare(f"vm {name} B={batch} {case}", got, want, errs)
                n_cases += 1
        # fault masks: the four TRA classes per command, per batch slice
        plan, data = _group(svc, [make("t0"), make("t1")])
        n_cmds = plan.lowered.n_cmds
        e = (rng.integers(0, 1 << 32, (n_cmds, 4, 2, words), dtype=np.uint32)
             & rng.integers(0, 1 << 32, (n_cmds, 4, 2, words),
                            dtype=np.uint32))
        for reduce in (None, "popcount"):
            call = lowering.vm_call(
                plan.lowered, data, outputs=list(plan.outputs), errors=e,
                mask=None if reduce is None else svc.catalog.mask())
            _compare(f"vm {name} B=2 errors reduce={reduce}",
                     call.run(vm.vm_megakernel, reduce),
                     call.run(vm.vm_plain, reduce), errs)
            n_cases += 1
    for n, n_bits in ((1 << 24, 8), (1 << 24, 32), (32 * 1001, 8),
                      (32 * 1001, 13)):
        values = torch.from_numpy(rng.integers(0, 1 << n_bits, n,
                                               dtype=np.uint32)
                                  .view(np.int32)).to(svc.device)
        _compare(f"bit_transpose n={n} n_bits={n_bits}",
                 bit_transpose(values, n_bits),
                 ref.bit_transpose(values, n_bits), errs)
        n_cases += 1
    torch.cuda.synchronize()
    print(f"[kernels] {n_cases} cases bit-identical to the plain versions "
          f"({words} words per row, {cols}-column blocks)")
    return max(errs)


# ---------------------------------------------------------------------------
# phase 3: the slice at full width
# ---------------------------------------------------------------------------


class Recorder:
    """Wraps the kernel wrappers the main path calls and keeps each call's
    arguments, so phase 4 can replay exactly the slice's launches. The
    wrappers themselves (and their launch counters) are untouched."""

    def __init__(self):
        import repro_torch.kernels.bittranspose as bt
        import repro_torch.kernels.vm as vm

        self.calls = []
        self.stage = ""
        self._restore = [(vm, "vm_megakernel", vm.vm_megakernel),
                         (bt, "bit_transpose", bt.bit_transpose)]
        orig_vm, orig_bt = vm.vm_megakernel, bt.bit_transpose

        def vm_rec(table, plane, out_idx, **kw):
            self.calls.append(("vm", (table, plane, tuple(out_idx)), kw,
                               self.stage))
            return orig_vm(table, plane, out_idx, **kw)

        def bt_rec(values, n_bits):
            self.calls.append(("bt", (values, n_bits), {}, self.stage))
            return orig_bt(values, n_bits)

        vm.vm_megakernel = vm_rec
        bt.bit_transpose = bt_rec

    def held_bytes(self) -> int:
        """Device bytes the recorded arguments keep alive."""
        import torch

        seen = {}
        for _, args, kw, _ in self.calls:
            for t in (*args, *kw.values()):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    st = t.untyped_storage()
                    seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    def close(self):
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)


def _raw_tenant0(spec):
    """Tenant 0's raw seeded data, drawn in `build_service`'s order."""
    rng = np.random.default_rng(spec.seed)
    m = spec.domain_bits
    days = [[rng.random(m) < spec.p_active for _ in range(7)]
            for _ in range(spec.n_weeks)]
    rng.random(m)                                   # male
    for _ in range(spec.n_sets):
        rng.random(m)
    col = rng.integers(0, 1 << spec.col_bits, m, dtype=np.uint32)
    col2 = rng.integers(0, 1 << spec.col_bits, m, dtype=np.uint32)
    return days, col, col2


def phase_slice(torch, spec):
    from repro_torch.apps.bitmap_index import week_or
    from repro_torch.kernels import LAUNCHES
    from repro_torch.service import (AGGREGATE, MATERIALIZE, Query,
                                     build_service, query_stream,
                                     run_queries_unbatched)

    rec = Recorder()
    try:
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        rec.stage = "ingest"
        t0 = time.perf_counter()
        svc = build_service(spec, device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        queries = query_stream(spec, svc)
        mat = [Query(week_or(1, prefix="t1/"), MATERIALIZE, tenant="t1"),
               Query("t2/col + t2/col2", MATERIALIZE, tenant="t2"),
               Query(svc.range_scan_query("t3/col", 10, 200), MATERIALIZE,
                     tenant="t3"),
               Query("t0/s1 & ~t0/s2", MATERIALIZE, tenant="t0")]
        rec.stage = "batch"
        t0 = time.perf_counter()
        report = svc.query_batch(queries)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        # the same stream again, every plan cached
        rec.stage = "warm batch"
        t0 = time.perf_counter()
        warm = svc.query_batch(queries)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        rec.stage = "materialize batch"
        report_mat = svc.query_batch(mat)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        rec.close()
    peak = torch.cuda.max_memory_allocated()
    held = rec.held_bytes()
    print(f"[slice] domain {spec.domain_bits} bits, {len(svc.catalog)} "
          f"vectors; build_service {t_build:.2f} s; {len(queries)}-query "
          f"batch {t_batch:.3f} s wall, {t_warm:.3f} s with every plan "
          f"cached ({report.n_plan_groups} plan groups, "
          f"{report.n_cse_planes} shared planes); peak device memory "
          f"{peak / 2**30:.2f} GiB, of which the launch recorder holds "
          f"{held / 2**30:.2f} GiB of replay inputs")
    print(f"[slice] launches while the slice ran: {launches}")
    for name in KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the main path")

    check([r.scalar for r in warm.results] == [r.scalar for r in
                                                report.results],
          "the warm batch disagrees with the first")
    oracle = run_queries_unbatched(svc.catalog, queries)
    for got, want in zip(report.results, oracle.results):
        check(got.scalar == want.scalar,
              f"query {got.index}: served {got.scalar} != oracle "
              f"{want.scalar} ({queries[got.index].query})")
    oracle_mat = run_queries_unbatched(svc.catalog, mat)
    for got, want in zip(report_mat.results, oracle_mat.results):
        check(np.array_equal(got.value, want.value)
              and got.scalar == want.scalar,
              f"materialize query {got.index} differs from the oracle")
    days, col, col2 = _raw_tenant0(spec)
    want_sum = int(col.astype(np.int64).sum())
    got_sum = svc.query("sum(t0/col)", AGGREGATE).scalar
    check(got_sum == want_sum, f"sum(t0/col) {got_sum} != numpy {want_sum}")
    want_add = int(((col.astype(np.int64) + col2) % (1 << spec.col_bits))
                   .sum())
    got_add = svc.query("sum(t0/col + t0/col2)", AGGREGATE).scalar
    check(got_add == want_add,
          f"sum(t0/col + t0/col2) {got_add} != numpy {want_add}")
    want_week = int(np.logical_or.reduce(days[0]).sum())
    got_week = svc.query(week_or(0, prefix="t0/")).scalar
    check(got_week == want_week,
          f"weekly OR count {got_week} != numpy {want_week}")
    print(f"[slice] {len(queries)} scalars and {len(mat)} materialized "
          f"results equal the unbatched interpreter; sum(t0/col)="
          f"{got_sum}, sum(t0/col+t0/col2)={got_add}, weekly-OR "
          f"count={got_week} equal numpy")
    return rec.calls, launches, {"batch_wall_s": t_batch,
                                 "warm_batch_wall_s": t_warm,
                                 "build_service_s": t_build,
                                 "peak_device_bytes": peak,
                                 "recorder_held_bytes": held,
                                 "n_plan_groups": report.n_plan_groups,
                                 "n_cse_planes": report.n_cse_planes}


# ---------------------------------------------------------------------------
# phase 4: numbers
# ---------------------------------------------------------------------------


def _time_ms(torch, fn, reps: int, clock_hz: float):
    """(result, device ms, call ms) of ``fn()``; times averaged over
    ``reps``.

    Device time: a sleep kernel holds the stream while the host enqueues
    every (start event, call, stop event) triple, so no host gap falls
    between a pair of events. Call time: events around ``reps``
    back-to-back calls on an idle stream, host work included.
    """
    result = fn()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(min(2.0 * reps * host_s + 2e-3, 5.0) * clock_hz))
    for start, stop in pairs:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    device_ms = sum(a.elapsed_time(b) for a, b in pairs) / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return result, device_ms, start.elapsed_time(stop) / reps


def _vm_bound(args, kw, int_rate: float):
    """(bytes ms, ops ms): the least time one VM launch's bytes and int32
    operations take on these inputs."""
    table, plane, out_idx = args
    batch, n_in, words = plane.shape
    n_out = len(out_idx)
    counting = kw.get("reduce") is not None
    nbytes = 4 * (plane.numel() + table.size + n_out
                  + (batch * n_out if counting else batch * n_out * words))
    for t in (kw.get("errors"), kw.get("mask")):
        if t is not None:
            nbytes += 4 * t.numel()
    # one 3-input logic op (LOP3: majority with polarity) per command per
    # word; count mode adds an AND and a popcount per output word
    ops = table.shape[0] * batch * words \
        + (2 * batch * n_out * words if counting else 0)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / int_rate * 1e3


def phase_numbers(torch, calls, launches, max_err, int_rate, clock_hz):
    from repro_torch.kernels import LAUNCHES, ref, vm
    from repro_torch.kernels.bittranspose import bit_transpose

    before = dict(LAUNCHES)
    per_kernel = {name: {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0,
                         "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
                         "calls": []}
                  for name in KERNELS}
    stages = {}
    errs = [max_err]
    for kind, args, kw, stage in calls:
        if kind == "vm":
            name = "vm_materialize" if kw.get("reduce") is None \
                else "vm_popcount"
            table, plane, out_idx = args
            got, k_ms, c_ms = _time_ms(torch, lambda: vm.vm_megakernel(
                table, plane, out_idx, **kw), 10, clock_hz)
            want, p_ms, _ = _time_ms(torch, lambda: vm.vm_plain(
                table, plane, out_idx, **kw), 2, clock_hz)
            b_ms, o_ms = _vm_bound(args, kw, int_rate)
            shape = {"batch": plane.shape[0], "rows_in": plane.shape[1],
                     "n_rows": kw["n_rows"], "n_cmds": int(table.shape[0]),
                     "n_out": len(out_idx), "words": plane.shape[2]}
        else:
            name = "bit_transpose"
            values, n_bits = args
            got, k_ms, c_ms = _time_ms(
                torch, lambda: bit_transpose(values, n_bits), 10, clock_hz)
            want, p_ms, _ = _time_ms(
                torch, lambda: ref.bit_transpose(values, n_bits), 2,
                clock_hz)
            n = values.numel()
            b_ms = 4 * (n + n_bits * (n // 32)) / HBM_BYTES_PER_S * 1e3
            o_ms = n * n_bits / int_rate * 1e3    # one bit test per plane
            shape = {"values": n, "n_bits": n_bits}
        _compare(f"{name} replay ({stage})", got, want, errs)
        row = per_kernel[name]
        row["ms"] += k_ms
        row["call_ms"] += c_ms
        row["plain_ms"] += p_ms
        row["bytes_ms"] += b_ms
        row["ops_ms"] += o_ms
        row["bound_ms"] += max(b_ms, o_ms)
        stages[stage] = stages.get(stage, 0.0) + k_ms
        row["calls"].append({**shape, "stage": stage, "ms": k_ms,
                             "call_ms": c_ms,
                             "plain_ms": p_ms,
                             "bytes_ms": b_ms, "ops_ms": o_ms})
    check(dict(LAUNCHES) != before, "replays launched no kernel")
    print("[numbers] kernel device ms by stage of the slice: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = per_kernel[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max(errs), "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": None})
        print(f"[numbers] {name}: {len(r['calls'])} launches of the slice "
              f"replayed: kernel {r['ms']:.3f} ms on the device "
              f"({r['call_ms']:.3f} ms timed with the wrapper's host "
              f"work), plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms (bytes {r['bytes_ms']:.3f} ms, "
              f"int32 ops {r['ops_ms']:.3f} ms)")
    return rows, per_kernel, stages


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every launch's numbers here")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout that holds "
              "src/repro_torch", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: chip_smoke.py needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.service import WorkloadSpec, build_service

    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    max_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    int_rate = INT32_LANES_PER_SM * props.multi_processor_count * max_mhz * 1e6
    print(f"[device] {torch.cuda.get_device_name(0)}: "
          f"{props.multi_processor_count} SMs, max SM clock {max_mhz:.0f} "
          f"MHz -> int32 rate {int_rate / 1e12:.2f} Top/s; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    try:
        phase_build(_build)
        small = WorkloadSpec(n_tenants=4, n_weeks=3,
                             domain_bits=(1 << 20) + 32 * 37 + 5,
                             n_queries=96)
        max_err = phase_kernels(torch, build_service(small, device="cuda"),
                                small)
        spec = WorkloadSpec(n_tenants=4, n_weeks=3, domain_bits=1 << 24,
                            n_queries=96)
        calls, launches, slice_info = phase_slice(torch, spec)
        rows, per_kernel, stages = phase_numbers(
            torch, calls, launches, max_err, int_rate, max_mhz * 1e6)
    except SmokeFailure as e:
        print(f"[fail] {e}", file=sys.stderr)
        return 1
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps({
            "card": card, "int32_ops_per_s": int_rate, "slice": slice_info,
            "kernel_ms_by_stage": stages,
            "kernels": rows, "launches": per_kernel}, indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
