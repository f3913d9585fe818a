"""The readings the correctness limits are set from, on the card: the
program's on many seeds (its lower reading), and the control's and the
planted faults' on a few (its upper one). The benchmark's own runs do
not run this.

    python perfbench/control.py --workload qwen3_0p6b.train \
        --seeds 11 12 13 ... --control-seeds 11 12 13 \
        --out readings.jsonl

* LM training: the program's first checked steps against the reference
  (no window); the control is the reference in float8 in the program's
  place; the fault keeps half of each batch (the mean over the rest).
* LM prefill: ``sampled_requests`` requests of the program, then the
  widest logit gap of its ids, of the ids the float8 reference puts
  first (the control), of ids altered by one, and of the first half of
  each batch's ids served for the whole batch.
* Query cells: a short window of the control (the date column at one bit
  less) in the program's place.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
NO_LIMITS = {"grad_gap": 0, "grad_gap_own": 0, "update_gap": 0}


def _free(device="cuda"):
    import torch

    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()


def train_readings(spec, config, traffic, driver, seed, control,
                   device="cuda", overrides=None):
    bench = driver.Bench(config, traffic, spec, seed, device,
                         overrides or {})
    t0 = time.perf_counter()
    bench.setup()
    bench.close()
    _free(device)
    t1 = time.perf_counter()
    want = bench.reference()
    t2 = time.perf_counter()
    out = [{"kind": "program", "setup_s": t1 - t0, "reference_s": t2 - t1,
            **_numbers(driver, bench.prog, want)}]
    if control:
        fp8 = bench.reference(quant="fp8")
        out.append({"kind": "control_fp8", **_numbers(driver, fp8, want)})
        half = bench.reference(rows=bench.batch // 2)
        out.append({"kind": "fault_half_batch",
                    **_numbers(driver, half, want)})
    return out


def _numbers(driver, got, want):
    values = {k: v for k, (v, _) in
              driver.compare(got, want, NO_LIMITS).items()}
    values["loss_gap"] = driver.loss_gap(got, want)
    values["grad_leaf"] = driver.gaps(got["grads"], want["grads"])[1]
    values["update_leaf"] = driver.gaps(got["change"], want["change"])[1]
    # each leaf over its own norm alone, without the median leaf's floor
    values["grad_own"] = driver.leaf_gaps(got["grads"], want["grads"],
                                          floor=False)
    values["update_own"] = driver.leaf_gaps(got["change"], want["change"],
                                            floor=False)
    values["losses"] = got["losses"]
    values["want_losses"] = want["losses"]
    return values


def prefill_readings(spec, config, traffic, driver, seed, control,
                     device="cuda", overrides=None):
    import numpy as np

    bench = driver.Bench(config, traffic, spec, seed, device,
                         overrides or {})
    bench.setup()
    for i in range(bench.traffic["sampled_requests"]):
        bench.unit(i)
    bench.close()
    _free(device)
    picks = {"program": bench.picks()}
    if control:
        vocab = config["vocab_size"]
        picks["control_fp8"] = "fp8"
        picks["fault_altered"] = {i: (p + 1) % vocab
                                  for i, p in picks["program"].items()}
        picks["fault_half_batch"] = {
            i: np.concatenate([p[: len(p) // 2]] * 2)
            for i, p in picks["program"].items()}
    return [{"kind": k, "logit_gap": v}
            for k, v in bench.gaps(picks).items()]


def query_readings(name, seed, seconds):
    from perfbench import harness

    out = harness.run_cell(name, seed, seconds, False, time.perf_counter(),
                           overrides={"control": True})
    return [{"kind": "control_coarse_date",
             **{k: c["value"] for k, c in out["checks"].items()},
             "attempted": out["attempted"]}]


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from perfbench import harness

    manifest = harness.load_manifest()
    spec = harness.cell_spec(manifest, args.workload)
    config = harness.load_json(harness.ROOT / "configs"
                               / f"{spec['config']}.json")
    traffic = harness.load_json(harness.ROOT / "traffic"
                                / f"{spec['traffic']}.json")
    driver = harness.load_module(harness.ROOT / "drivers"
                                 / f"{spec['driver']}.py")
    with open(args.out, "a") as f:
        for seed in args.seeds:
            control = seed in args.control_seeds
            if spec["driver"] == "lm_train":
                rows = train_readings(spec, config, traffic, driver, seed,
                                      control)
            elif spec["driver"] == "lm_prefill":
                rows = prefill_readings(spec, config, traffic, driver, seed,
                                        control)
            elif control:
                rows = query_readings(args.workload, seed, args.seconds)
            else:
                rows = []
            for r in rows:
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   **r})
                print(line, flush=True)
                f.write(line + "\n")
            _free()
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]
    sys.exit(main(sys.argv[1:]))
