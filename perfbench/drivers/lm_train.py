"""LM training: closed-loop optimizer steps of the port's
`train.step.make_train_step` (loss and gradients over microbatches,
the global-norm clip, the optimizer) on a dense decoder.

The generator of ``traffic/<mix>.json`` with ``"generator":
"lm_train"``: every step a fresh global batch of ``global_batch``
sequences of ``seq`` ids drawn on the card from the seed (tokens and
next-token labels), split into ``microbatches``; AdamW on the mix's
schedule, remat as the mix names it.

Set-up builds one training step with its model (the benchmark's weights)
and optimizer state and drives it through its first ``check_steps``
steps, which also warm up every shape; the window continues the same
object from there. The check runs the plain float32 reference through
those first steps on the same weights and batches and compares each
leaf's gradient norm at the first step (worked out from the optimizer's
first moment) and each leaf's change after the steps, by the worst leaf
(`compare`); each step's loss is recorded beside them.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, Tuple

import torch

from perfbench import counts, data, harness, lm
from perfbench.harness import log
from perfbench.spans import Spans
from perfbench.reference import qwen3 as ref


def leaf_gaps(prog: Dict[str, float], want: Dict[str, float], keep=None,
              floor: bool = True) -> Dict[str, float]:
    """Each leaf's |program's norm - reference's| over the reference's norm
    of that leaf, or with ``floor`` over the larger of it and the median
    leaf's."""
    leaves = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in leaves) if floor else 0.0
    return {k: abs(prog.get(k, 0.0) - want[k]) / max(want[k], median, 1e-30)
            for k in leaves}


def gaps(prog: Dict[str, float], want: Dict[str, float], keep=None,
         floor: bool = True) -> Tuple[float, str]:
    """The worst leaf's gap (`leaf_gaps`) and its name."""
    by = leaf_gaps(prog, want, keep, floor)
    name = max(by, key=by.get)
    return by[name], name


TRAFFIC_KEYS = ("generator", "about", "seq", "global_batch", "microbatches",
                "remat", "optimizer", "check_steps", "profile_units")
OPTIMIZER_KEYS = ("name", "lr", "warmup", "total", "b1", "b2", "eps",
                  "weight_decay", "clip")


class Bench:
    unit_label = "train_step"
    labels = (unit_label,)
    spans = Spans(())

    def __init__(self, config, traffic, cell, seed, device, overrides):
        if traffic["generator"] != "lm_train":
            raise ValueError(f"the lm_train driver reads lm_train mixes, "
                             f"not {traffic['generator']!r}")
        harness.known_keys(traffic, TRAFFIC_KEYS, "the mix")
        harness.known_keys(traffic["optimizer"], OPTIMIZER_KEYS,
                           "the mix's optimizer")
        if traffic["optimizer"]["name"] != "adamw":
            raise ValueError(f"the lm_train driver and its reference run "
                             f"adamw, not {traffic['optimizer']['name']!r}")
        self.config = lm.sized(config, overrides)
        self.port = lm.port_config(self.config)
        self.traffic = dict(traffic)
        self.traffic.update({k: v for k, v in overrides.items()
                             if k in traffic})
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.profile_units = int(traffic["profile_units"])
        t = self.traffic
        self.seq, self.batch = t["seq"], t["global_batch"]
        self.flops = counts.train_flops(self.config, self.batch, self.seq)
        self.steps = 0
        self.prog: Dict = {}

    def batch_of(self, k: int) -> Dict[str, torch.Tensor]:
        ids = data.token_ids(self.config["vocab_size"],
                             (self.batch, self.seq + 1), self.seed, k,
                             self.device)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    def setup(self) -> None:
        from repro_torch.models import build
        from repro_torch.optim import adamw, warmup_cosine
        from repro_torch.train import make_train_step

        from repro_torch.train import step as train_step

        self.spans = Spans([
            (train_step, "loss_and_grads", "train.loss_and_grads"),
            (train_step, "clip_by_global_norm", "train.clip")])
        self.labels = (self.unit_label,) + self.spans.labels
        t = self.traffic
        cfg = self.port
        vocab = lm.padded(self.config["vocab_size"])
        if cfg.padded_vocab != vocab:
            raise ValueError(f"the port pads the vocabulary to "
                             f"{cfg.padded_vocab}, the benchmark to {vocab}")
        t0 = time.perf_counter()
        weights = data.lm_weights(self.config, vocab, self.seed,
                                   self.device, lm.dtype(self.config))
        self.model = lm.load_model(cfg, weights, self.device)
        self.sync()
        log(f"weights drawn and loaded in {time.perf_counter() - t0:.3f} s")
        bundle = build(cfg, device=self.device, remat=t["remat"])
        o = t["optimizer"]
        self.opt = adamw(warmup_cosine(o["lr"], o["warmup"], o["total"]),
                         b1=o["b1"], b2=o["b2"], eps=o["eps"],
                         weight_decay=o["weight_decay"])
        self.state = self.opt.init(self.model)
        self.step_fn = make_train_step(bundle, self.opt,
                                       grad_accum=t["microbatches"],
                                       clip=o["clip"])
        losses = []
        t0 = time.perf_counter()
        for k in range(t["check_steps"]):
            self.model, self.state, m = self.step_fn(
                self.model, self.state, k, self.batch_of(k))
            losses.append(float(m["loss"]))
            if k == 0:
                self.prog["grads"] = {
                    leaf: float(mom.double().norm()) / (1 - o["b1"])
                    for leaf, mom in self.state["m"].items()}
        change: Dict[str, float] = {}
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                leaf = data.leaf_name(n)
                d = (p.float() - weights[n].float()).double().pow(2).sum()
                change[leaf] = change.get(leaf, 0.0) + float(d)
        self.prog["change"] = {k: v ** 0.5 for k, v in change.items()}
        self.prog["losses"] = losses
        del weights
        self.next_step = t["check_steps"]
        log(f"{t['check_steps']} checked steps in "
            f"{time.perf_counter() - t0:.3f} s")

    def unit(self, i: int) -> None:
        k = self.next_step + i
        self.model, self.state, _ = self.step_fn(self.model, self.state, k,
                                                 self.batch_of(k))
        self.steps += 1

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def counters(self) -> Dict[str, float]:
        return {"steps": self.steps,
                "tokens": self.steps * self.batch * self.seq,
                "flops": self.steps * self.flops["model"],
                "attention_flops": self.steps * self.flops["attention"]}

    def trace_on(self) -> None:
        pass

    def trace_off(self) -> Dict[str, float]:
        return {}

    def e2e(self, win) -> Dict[str, float]:
        return {"train_tokens_per_s":
                self.steps * self.batch * self.seq / win["seconds"]}

    def attempted(self) -> Tuple[int, int]:
        return self.steps, 0

    def close(self) -> None:
        for name in ("model", "state", "step_fn", "opt"):
            if hasattr(self, name):
                delattr(self, name)

    def reference(self, quant=None, rows=None) -> Dict:
        """The plain reference through the checked steps."""
        t = self.traffic
        W = lm.reference_weights(self.config, lm.padded(self.config["vocab_size"]),
                                 self.seed, self.device)
        batches = [(b["tokens"], b["labels"]) for b in
                   (self.batch_of(k) for k in range(t["check_steps"]))]
        with ref.full_float32():
            return ref.train(W, self.config, batches, t["optimizer"],
                             quant=quant, store_dtype=lm.dtype(self.config),
                             rows=rows)

    def check(self) -> Dict[str, Tuple[float, float]]:
        return compare(self.prog, self.reference(), self.cell["limits"])


def loss_gap(prog: Dict, want: Dict) -> float:
    """The widest relative gap of a checked step's loss. Recorded, not
    compared: the control reads no more than 3x the sound runs
    (PERF.md)."""
    return max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], want["losses"]))


def compare(prog: Dict, want: Dict, limits: Dict) -> Dict:
    """The compared numbers of a training run against the reference's,
    each by the worst leaf: the first gradient's gap over the larger of
    the leaf's norm and the median leaf's (``grad_gap``), the same over
    the leaf's own norm alone (``grad_gap_own``: the small leaves' noise
    leads it, so it catches what the median's floor hides, the float8
    control aside), and the change's gap over the leaf's own norm
    (``update_gap``). A leaf whose reference gradient is under a
    thousandth of the median leaf's is left out of the change (none of
    Qwen3's is)."""
    median = statistics.median(want["grads"].values())
    moved = {k for k, g in want["grads"].items() if g >= 1e-3 * median}
    grad, _ = gaps(prog["grads"], want["grads"])
    grad_own, _ = gaps(prog["grads"], want["grads"], floor=False)
    change, _ = gaps(prog["change"], want["change"], keep=moved, floor=False)
    return {"grad_gap": (grad, limits["grad_gap"]),
            "grad_gap_own": (grad_own, limits["grad_gap_own"]),
            "update_gap": (change, limits["update_gap"])}
