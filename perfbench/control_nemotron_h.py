"""The readings the ``nemotron3_nano.prefill`` cell's limits are set
from, on the card: the program's on many seeds (the lower reading), the
float8 control's and the planted faults' on a few (the upper one). The
benchmark's own runs do not run this.

    python perfbench/control_nemotron_h.py --seeds 11 12 13 ... \\
        --control-seeds 11 --fault-seeds 12 --out readings.jsonl

Each reading runs ``sampled_requests`` requests of the program (no
window) and reads ``block_gap`` (the worst block's mixer output against
the reference's on the program's own input, `Bench.block_gaps`),
``route_gap`` (how far the program's experts fall short of the
reference's choice, the same call), ``head_gap`` (the served ids against
the reference head on the program's last hidden states,
`Bench.head_gap`) and, unless ``--blocks-only``, ``logit_gap`` (the
served ids against the whole reference). The control is the reference
in float8 in the program's place: its mixers (on its own experts) on the
program's inputs, the ids its head and its whole model put first;
ids altered by one and the first half of each batch's ids served for all
are read against the head. The planted faults (`FAULTS`) patch the port
while it serves and replays: an expert dropped (expert 0's slots weigh
nothing), the selection bias ignored, RoPE applied in the attention
blocks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys

import numpy as np
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _route(change):
    import repro_torch.models.moe as moe

    return _patched(moe, "route_sigmoid", change)


def expert_dropped():
    def make(real):
        def route(router, bias, xt, k, scale):
            scores, gate, idx = real(router, bias, xt, k, scale)
            return scores, gate * (idx != 0), idx
        return route
    return _route(make)


def bias_ignored():
    import torch

    return _route(lambda real: lambda router, bias, xt, k, scale: real(
        router, torch.zeros_like(bias), xt, k, scale))


def rope_applied():
    import repro_torch.models.layers as L

    return _patched(L, "_project_qkv", lambda real: (
        lambda p, x, cfg, positions, rope=True: real(
            p, x, dataclasses.replace(cfg, use_rope=True), positions, rope)))


#: planted faults: each a context manager that patches the port
FAULTS = {"fault_expert_dropped": expert_dropped,
          "fault_bias_ignored": bias_ignored,
          "fault_rope_applied": rope_applied}


def _free(device):
    gc.collect()
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.empty_cache()


def readings(spec, config, traffic, driver, seed, control=False, faults=(),
             device="cuda", overrides=None, whole=True):
    """The program's reading on ``seed`` (with ``control``, the float8
    control's too), then each named fault's; ``whole``: with the whole
    reference's ``logit_gap``."""
    rows = []
    for kind in ("program",) + tuple(faults):
        with FAULTS[kind]() if kind in FAULTS else contextlib.nullcontext():
            bench = driver.Bench(config, traffic, spec, seed, device,
                                 overrides or {})
            bench.setup()
            for i in range(bench.traffic["sampled_requests"]):
                bench.unit(i)
            bench.close()
        _free(device)
        picks = {kind: bench.picks()}
        heads = {kind: bench.head_gap()}
        blocks = {kind: bench.block_gaps()}
        if control and kind == "program":
            picks["control_fp8"] = "fp8"
            heads["control_fp8"] = bench.head_gap(quant="fp8")
            blocks["control_fp8"] = bench.block_gaps("fp8")
            vocab = config["vocab_size"]
            for name, ids in (
                    ("fault_altered", {i: (p + 1) % vocab
                                       for i, p in picks[kind].items()}),
                    ("fault_half_batch", {
                        i: np.concatenate([p[: len(p) // 2]] * 2)
                        for i, p in picks[kind].items()})):
                heads[name] = bench.head_gap(ids)
        gaps = bench.gaps(picks) if whole else {}
        blocks = {k: (max(g), g, route) for k, (g, route) in blocks.items()}
        for name in heads:
            worst, each, route = blocks.get(name, (None, None, None))
            rows.append({"kind": name, "logit_gap": gaps.get(name),
                         "head_gap": heads[name], "block_gap": worst,
                         "route_gap": route, "blocks": each,
                         "route_share": bench.route_share
                         if name == kind else None})
        del bench
        _free(device)
    return rows


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="nemotron3_nano.prefill")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", required=True)
    p.add_argument("--blocks-only", action="store_true",
                   help="leave out the whole reference (logit_gap)")
    args = p.parse_args(argv)
    from perfbench import harness

    spec = harness.cell_spec(harness.load_manifest(), args.workload)
    config = harness.load_json(harness.ROOT / "configs"
                               / f"{spec['config']}.json")
    traffic = harness.load_json(harness.ROOT / "traffic"
                                / f"{spec['traffic']}.json")
    driver = harness.load_module(harness.ROOT / "drivers"
                                 / f"{spec['driver']}.py")
    with open(args.out, "a") as f:
        for seed in args.seeds:
            faults = tuple(FAULTS) if seed in args.fault_seeds else ()
            for r in readings(spec, config, traffic, driver, seed,
                              seed in args.control_seeds, faults,
                              whole=not args.blocks_only):
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   **r})
                print(line, flush=True)
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]
    sys.exit(main(sys.argv[1:]))
