"""LM prefill: closed-loop requests of the port's `serve.step.generate`
with ``max_new`` new ids (one: long-prompt scoring and classification).

The generator of ``traffic/<mix>.json`` with ``"generator":
"lm_prefill"``: every request a fresh batch of ``prompts`` prompts of
``prompt_len`` ids drawn on the card from the seed; one client, which
reads each answer before it sends the next request.

The check takes ``sampled_requests`` of the finished requests, drawn
from the seed, runs the plain float32 reference over each prompt and
reads, for each served id, how far the reference's logit of it lies
below the reference's best: the widest such gap is the number compared.
Greedy ids only, so the gap is 0 wherever the program and the reference
agree on the best id.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import counts, data, harness, lm
from perfbench.harness import log
from perfbench.spans import Spans
from perfbench.reference import qwen3 as ref


TRAFFIC_KEYS = ("generator", "about", "prompts", "prompt_len", "max_new",
                "warmup_requests", "sampled_requests", "profile_units")


class Bench:
    unit_label = "request"
    labels = (unit_label,)
    spans = Spans(())

    def __init__(self, config, traffic, cell, seed, device, overrides):
        if traffic["generator"] != "lm_prefill":
            raise ValueError(f"the lm_prefill driver reads lm_prefill "
                             f"mixes, not {traffic['generator']!r}")
        harness.known_keys(traffic, TRAFFIC_KEYS, "the mix")
        self.config = lm.sized(config, overrides)
        self.port = lm.port_config(self.config)
        self.traffic = dict(traffic)
        self.traffic.update({k: v for k, v in overrides.items()
                             if k in traffic})
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        t = self.traffic
        self.profile_units = int(t["profile_units"])
        self.shape = (t["prompts"], t["prompt_len"])
        self.flops = counts.prefill_flops(self.config,
                                          [t["prompt_len"]] * t["prompts"])
        self.served: List[np.ndarray] = []

    def prompts(self, i: int) -> torch.Tensor:
        return data.token_ids(self.config["vocab_size"], self.shape,
                              self.seed, ("request", i), self.device)

    def setup(self) -> None:
        from repro_torch.models import build

        cfg = self.port
        vocab = lm.padded(self.config["vocab_size"])
        if cfg.padded_vocab != vocab:
            raise ValueError(f"the port pads the vocabulary to "
                             f"{cfg.padded_vocab}, the benchmark to {vocab}")
        t0 = time.perf_counter()
        weights = data.lm_weights(self.config, vocab, self.seed,
                                   self.device, lm.dtype(self.config))
        self.model = lm.load_model(cfg, weights, self.device)
        del weights
        self.sync()
        t1 = time.perf_counter()
        self.bundle = build(cfg, device=self.device)
        for k in range(self.traffic["warmup_requests"]):
            self._request(self.prompts(("warmup", k)))
        log(f"weights drawn and loaded in {t1 - t0:.3f} s, warm-up "
            f"requests in {time.perf_counter() - t1:.3f} s")

    def _request(self, prompts: torch.Tensor) -> np.ndarray:
        from repro_torch.serve import generate

        ids = generate(self.bundle, self.model, {"tokens": prompts},
                       self.traffic["max_new"])
        return ids.cpu().numpy()

    def unit(self, i: int) -> None:
        self.served.append(self._request(self.prompts(i)))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def counters(self) -> Dict[str, float]:
        n = len(self.served)
        return {"requests": n, "tokens": n * self.shape[0] * self.shape[1],
                "flops": n * self.flops["model"],
                "attention_flops": n * self.flops["attention"]}

    def trace_on(self) -> None:
        pass

    def trace_off(self) -> Dict[str, float]:
        return {}

    def e2e(self, win) -> Dict[str, float]:
        return {"prefill_tokens_per_s":
                self.counters()["tokens"] / win["seconds"]}

    def attempted(self) -> Tuple[int, int]:
        return len(self.served), 0

    def close(self) -> None:
        for name in ("model", "bundle"):
            if hasattr(self, name):
                delattr(self, name)

    def sample(self) -> List[int]:
        """The requests the check compares, drawn from the seed."""
        n = len(self.served)
        k = min(n, self.traffic["sampled_requests"])
        rng = np.random.default_rng(data.subseed(self.seed, "sample"))
        return sorted(int(i) for i in rng.choice(n, k, replace=False))

    def gaps(self, picks: Dict[str, object]) -> Dict[str, float]:
        """The widest gap, over the sampled requests' prompts, between the
        reference's best logit and its logit of each picked id, for each
        named set of ``picks``: a dict from request to its (prompts,) ids,
        or ``"fp8"``: the ids the reference computed in float8 puts first
        (the control)."""
        W = lm.reference_weights(self.config,
                                 lm.padded(self.config["vocab_size"]),
                                 self.seed, self.device)
        widest = {name: 0.0 for name in picks}
        with ref.full_float32():
            for i in self.sample():
                tokens = self.prompts(i)
                want = ref.last_logits(W, tokens, self.config)
                best = want.max(-1).values
                for name, p in picks.items():
                    if isinstance(p, str):
                        got = ref.last_logits(W, tokens, self.config,
                                              p).argmax(-1)
                    else:
                        got = torch.as_tensor(p[i], device=want.device)
                    gap = best - want.gather(-1, got.long()[:, None])[:, 0]
                    widest[name] = max(widest[name], float(gap.max()))
        return widest

    def picks(self) -> Dict[int, np.ndarray]:
        """The first served id of each prompt, by request."""
        return {i: s[:, 0] for i, s in enumerate(self.served)}

    def check(self) -> Dict[str, Tuple[float, float]]:
        gap = self.gaps({"program": self.picks()})["program"]
        return {"logit_gap": (gap, self.cell["limits"]["logit_gap"])}
