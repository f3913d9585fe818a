"""LM prefill of a pattern-driven hybrid (Nemotron-H): closed-loop
requests of the port's `serve.step.generate` with ``max_new`` new ids,
the model built by `models.registry.build` from a block pattern.

It reads ``lm_prefill`` mixes (``traffic/<mix>.json``): every request a
fresh batch of ``prompts`` prompts of ``prompt_len`` ids drawn on the
card from the seed; one client, which reads each answer before it sends
the next request. The dense drivers (`lm_prefill`, `lm_train`) hold a
dense decoder's weights; this one holds its own:

* the weight drawer (`fill`): every parameter drawn in place, in its
  stored dtype, by a generator of its own named by the parameter, so the
  program fills its whole model with no second copy and the reference
  draws any one block again;
* the FLOP counts (`prefill_flops`).

The check takes ``sampled_requests`` of the finished requests, drawn
from the seed. Before the model is freed they run once more (`replay`),
with the program's taps (`repro_torch.obs.taps`) read: its expert
selections, one prompt's input to every block and its mixer's output
(the prompt's batch slot turns with the request and the seed, so the
sampled requests cover every slot), and every prompt's last hidden
state. Compared, each with the cell's limit (`cells/<cell>.json` says
why): ``replay_mismatch``, the replayed requests that served other ids
than in the window; ``block_gap``, the worst block's mixer output on the
program's own input against the plain float32 reference's
(`reference.nemotron_h`, one block at a time; an MoE block on the
program's own experts); ``route_gap``, how far the program's experts
fall short of the reference's choice on that input; and ``head_gap``,
the served ids against the reference head on the program's last hidden
states. Logged, not compared: ``logit_gap`` (the served ids against the
whole reference; random routers amplify bf16 rounding through 52
blocks, so it does not separate from the float8 control) and the share
of the reference's routed slots that the program routed elsewhere.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from perfbench import data, harness, lm
from perfbench.harness import log
from perfbench.reference import nemotron_h as ref
from perfbench.spans import Spans

TRAFFIC_KEYS = ("generator", "about", "prompts", "prompt_len", "max_new",
                "warmup_requests", "sampled_requests", "profile_units")

#: ``configs/<model>.json`` key -> the port's `ModelConfig` field
FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "vocab_size": "vocab_size", "moe_intermediate_size": "d_ff",
          "moe_shared_expert_intermediate_size": "shared_d_ff",
          "n_routed_experts": "n_experts", "num_experts_per_tok": "top_k",
          "n_shared_experts": "n_shared_experts",
          "routed_scaling_factor": "routed_scale",
          "ssm_state_size": "ssm_state", "conv_kernel": "ssm_conv",
          "mamba_head_dim": "ssm_head_dim", "mamba_num_heads": "ssm_heads",
          "n_groups": "ssm_groups", "chunk_size": "ssm_chunk",
          "layer_norm_epsilon": "norm_eps", "rope_theta": "rope_theta",
          "torch_dtype": "dtype", "hybrid_override_pattern": "block_pattern"}
#: settings the port runs only as published
FIXED = {"model_type": "nemotron_h", "mlp_hidden_act": "relu2",
         "mamba_hidden_act": "silu", "n_group": 1, "topk_group": 1,
         "norm_topk_prob": True, "attention_bias": False, "mlp_bias": False,
         "use_bias": False, "mamba_proj_bias": False, "use_conv_bias": True,
         "tie_word_embeddings": False, "residual_in_fp32": False,
         "sliding_window": None}
#: keys that size nothing the port computes: the drawer's (``time_step_*``,
#: ``rescale_prenorm_residual``), the MLP blocks' width (no block of the
#: pattern is one), the published kernels' switch, and what documents the
#: file
CONFIG_KEYS = tuple(FIELDS) + tuple(FIXED) + (
    "intermediate_size", "expand", "max_position_embeddings",
    "num_logits_to_keep", "partial_rotary_factor", "rescale_prenorm_residual",
    "time_step_floor", "time_step_max", "time_step_min", "use_mamba_kernels",
    "norm_eps", "name", "system", "source", "arch", "reduced", "assumed",
    "deployment", "footprint")


def port_config(config: Mapping):
    """The port's `ModelConfig` of ``config["arch"]`` with every size of
    ``config``; raises where the file holds a key no driver reads or a
    setting the port does not run."""
    from repro_torch.configs.base import get_config

    harness.known_keys(config, CONFIG_KEYS, f"configs/{config['name']}")
    cfg = get_config(config["arch"])
    if not cfg.block_pattern:
        raise ValueError(f"{cfg.name} is not a pattern-driven hybrid")
    odd = {k: config[k] for k, v in FIXED.items() if config[k] != v}
    if odd or config["norm_eps"] != config["layer_norm_epsilon"]:
        raise ValueError(f"the port runs Nemotron-H as published, not {odd}")
    return dataclasses.replace(
        cfg, **{f: config[k] for k, f in FIELDS.items()})


def sized(config: Mapping, overrides: Mapping) -> Dict:
    """The configuration with a CPU rehearsal's smaller sizes, if any."""
    return {**config, **{k: v for k, v in overrides.items() if k in config}}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

INIT_STD = 0.02
#: spread of ``e_score_correction_bias``: that of the sigmoid scores
BIAS_STD = 0.2
#: the output projections, scaled by 1/sqrt(num_hidden_layers)
OUT_PROJECTIONS = ("ssm.out_proj", "attn.wo", "moe.wo", "moe.shared.wo")
#: parameters the port stores in float32
FLOAT32 = ("moe.router", "moe.e_bias", "ssm.a_log", "ssm.d_skip",
           "ssm.dt_bias")


def weight_specs(cfg: Mapping, padded_vocab: int
                 ) -> List[Tuple[str, tuple, torch.dtype]]:
    """Every parameter (``configs/<model>.json`` keys) by name, shape and
    stored dtype, in the port's layout."""
    D, V = cfg["hidden_size"], padded_vocab
    H, P = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    GN = cfg["n_groups"] * cfg["ssm_state_size"]
    Din = H * P
    E, F, Fs = (cfg["n_routed_experts"], cfg["moe_intermediate_size"],
                cfg["moe_shared_expert_intermediate_size"])
    Hq, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    mixers = {
        "M": {"ssm.in_proj": (D, 2 * Din + 2 * GN + H),
              "ssm.conv_w": (cfg["conv_kernel"], Din + 2 * GN),
              "ssm.conv_b": (Din + 2 * GN,), "ssm.a_log": (H,),
              "ssm.d_skip": (H,), "ssm.dt_bias": (H,), "ssm.norm": (Din,),
              "ssm.out_proj": (Din, D)},
        "E": {"moe.router": (D, E), "moe.e_bias": (E,),
              "moe.wi": (E, D, F), "moe.wo": (E, F, D),
              "moe.shared.wi": (D, Fs), "moe.shared.wo": (Fs, D)},
        "*": {"attn.wq": (D, Hq, hd), "attn.wk": (D, KV, hd),
              "attn.wv": (D, KV, hd), "attn.wo": (Hq, hd, D)}}
    dt = lm.dtype(cfg)
    out = [("embed.tok", (V, D), dt), ("embed.head", (D, V), dt)]
    for i, kind in enumerate(cfg["hybrid_override_pattern"]):
        out.append((f"blocks.{i}.ln", (D,), dt))
        out += [(f"blocks.{i}.{k}", s,
                 torch.float32 if k in FLOAT32 else dt)
                for k, s in mixers[kind].items()]
    out.append(("final_norm", (D,), dt))
    return out


@torch.no_grad()
def fill(t: torch.Tensor, name: str, cfg: Mapping, seed: int) -> None:
    """Draw parameter ``name`` into ``t`` in place, from a generator of
    its own (`configs/<model>.json`'s ``assumed`` says why each)."""
    g = data.generator(t.device, seed, "weights", name)
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("ln", "norm", "final_norm", "d_skip"):
        t.fill_(1)
    elif leaf == "a_log":
        t.uniform_(1, 16, generator=g).log_()
    elif leaf == "dt_bias":     # softplus^-1 of a log-uniform step
        t.uniform_(math.log(cfg["time_step_min"]),
                   math.log(cfg["time_step_max"]), generator=g)
        t.exp_().clamp_(min=cfg["time_step_floor"])
        t.add_(torch.log(-torch.expm1(-t)))
    elif leaf in ("conv_w", "conv_b"):
        bound = 1 / math.sqrt(cfg["conv_kernel"])
        t.uniform_(-bound, bound, generator=g)
    elif leaf == "e_bias":
        t.normal_(0, BIAS_STD, generator=g)
    else:
        std = INIT_STD
        if name.endswith(OUT_PROJECTIONS):
            std /= math.sqrt(cfg["num_hidden_layers"])
        t.normal_(0, std, generator=g)


def load_model(cfg, config: Mapping, seed: int, device):
    """The port's `NemotronH` of ``cfg`` with every parameter drawn in
    place (`fill`); raises where its parameters differ from
    `weight_specs` in name, shape or dtype."""
    from repro_torch.models.nemotron_h import NemotronH

    model = NemotronH(cfg, torch.device(device))
    params = dict(model.named_parameters())
    specs = {n: (s, d) for n, s, d in
             weight_specs(config, cfg.padded_vocab)}
    got = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    if got != specs:
        diff = sorted(n for n in set(got) | set(specs)
                      if got.get(n) != specs.get(n))
        raise ValueError(f"the port's parameters differ from the "
                         f"benchmark's: {diff[:8]}")
    for n, p in params.items():
        fill(p.data, n, config, seed)
    return model


def reference_drawer(config: Mapping, padded_vocab: int, seed: int, device):
    """``draw(name)``: parameter ``name`` drawn again, as float32."""
    specs = {n: (s, d) for n, s, d in weight_specs(config, padded_vocab)}

    def draw(name: str) -> torch.Tensor:
        shape, dt = specs[name]
        t = torch.empty(shape, dtype=dt, device=device)
        fill(t, name, config, seed)
        return t.float()

    return draw


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def block_params(cfg: Mapping) -> Dict[str, int]:
    """Matrix parameters each token multiplies in a block of each kind:
    the routed experts' ``num_experts_per_tok``, the shared expert, the
    router."""
    D = cfg["hidden_size"]
    H, P = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    GN = cfg["n_groups"] * cfg["ssm_state_size"]
    Din = H * P
    Hq, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    return {
        "M": D * (2 * Din + 2 * GN + H) + Din * D,
        "E": D * cfg["n_routed_experts"]
        + 2 * D * cfg["moe_intermediate_size"] * cfg["num_experts_per_tok"]
        + 2 * D * cfg["moe_shared_expert_intermediate_size"],
        "*": 2 * D * Hq * hd + 2 * D * KV * hd}


def scan_flops_per_token(cfg: Mapping) -> int:
    """The chunked SSD scan's products per token of an M block, at the
    published chunk c: C B^T within the chunk (G N c, the causal half)
    and its weights times x (H P c, the causal half), the token's share
    of its chunk's state (H P N) and the state read out by C (H P N),
    each a multiply and an add."""
    H, P = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    G, N, c = cfg["n_groups"], cfg["ssm_state_size"], cfg["chunk_size"]
    return 2 * (G * N * c // 2 + H * P * c // 2 + 2 * H * P * N)


def prefill_flops(cfg: Mapping, prompts: Sequence[int]) -> Dict[str, int]:
    """FLOPs of one prefill of prompts of the given lengths: 2 x the
    matrix parameters a token multiplies (`block_params`), the SSD scan
    (`scan_flops_per_token`), the causal attention products (2 x the
    attention blocks x H d_head S a token, as `counts` has them) and the
    head once a sequence. The attention products' share is
    ``attention``."""
    pattern = cfg["hybrid_override_pattern"]
    per = block_params(cfg)
    n_attn = pattern.count("*")
    token = 2 * sum(per[k] for k in pattern) \
        + pattern.count("M") * scan_flops_per_token(cfg)
    model = attention = 0
    for s in prompts:
        a = 2 * n_attn * cfg["num_attention_heads"] * cfg["head_dim"] * s * s
        attention += a
        model += token * s + 2 * cfg["hidden_size"] * cfg["vocab_size"] + a
    return {"model": model, "attention": attention}


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

class Replay(NamedTuple):
    """What the check reads of one replayed request."""

    slot: int                   # the batch slot whose blocks are read
    xs: List[torch.Tensor]      # each block's input there (S, D)
    ys: List[torch.Tensor]      # each block's mixer output there (S, D)
    routes: List[np.ndarray]    # each MoE block's experts (prompts S, k)
    last: torch.Tensor          # every prompt's last hidden state (n, D)


class Bench:
    unit_label = "request"
    labels = (unit_label,)
    spans = Spans(())

    def __init__(self, config, traffic, cell, seed, device, overrides):
        if traffic["generator"] != "lm_prefill":
            raise ValueError(f"this driver reads lm_prefill mixes, not "
                             f"{traffic['generator']!r}")
        harness.known_keys(traffic, TRAFFIC_KEYS, "the mix")
        self.config = sized(config, overrides)
        self.port = port_config(self.config)
        self.traffic = {**traffic, **{k: v for k, v in overrides.items()
                                      if k in traffic}}
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        t = self.traffic
        self.profile_units = int(t["profile_units"])
        self.shape = (t["prompts"], t["prompt_len"])
        self.flops = prefill_flops(self.config,
                                   [t["prompt_len"]] * t["prompts"])
        self.served: List[np.ndarray] = []
        self.replays: Dict[int, Replay] = {}
        self.replay_mismatch = 0
        self.route_share = None

    def prompts(self, i) -> torch.Tensor:
        return data.token_ids(self.config["vocab_size"], self.shape,
                              self.seed, ("request", i), self.device)

    def setup(self) -> None:
        from repro_torch.models import build

        cfg = self.port
        if cfg.padded_vocab != lm.padded(self.config["vocab_size"]):
            raise ValueError(f"the port pads the vocabulary to "
                             f"{cfg.padded_vocab}")
        t0 = time.perf_counter()
        self.model = load_model(cfg, self.config, self.seed, self.device)
        self.sync()
        t1 = time.perf_counter()
        self.bundle = build(cfg, device=self.device)
        for k in range(self.traffic["warmup_requests"]):
            self._request(self.prompts(("warmup", k)))
        log(f"weights drawn in {t1 - t0:.3f} s, warm-up requests in "
            f"{time.perf_counter() - t1:.3f} s")

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
        from repro_torch.obs import device as obs_device

        obs_device.start(self.device)

    def trace_off(self) -> Dict[str, float]:
        """The program's spans (device seconds) and counters over the
        stretch, in one dict."""
        from repro_torch.obs import device as obs_device

        got = obs_device.stop()
        log(f"spans {got['spans']}, counters {got['counters']}")
        return {**got["spans"], **got["counters"]}

    def e2e(self, win) -> Dict[str, float]:
        return {"prefill_tokens_per_s":
                self.counters()["tokens"] / win["seconds"]}

    def attempted(self) -> Tuple[int, int]:
        return len(self.served), 0

    def close(self) -> None:
        """Run the sampled requests once more with the program's taps read
        (`replay`), then free the model."""
        if hasattr(self, "model") and self.served:
            self.replay(self.sample())
        for name in ("model", "bundle"):
            if hasattr(self, name):
                delattr(self, name)

    def replay(self, requests) -> None:
        """Serve ``requests`` again, reading the taps into `replays` (on
        the host, in the program's dtype; the j-th request's blocks at
        batch slot (seed + j) mod prompts), and count in
        `replay_mismatch` those whose ids differ from the window's."""
        from repro_torch.obs import taps

        for j, i in enumerate(requests):
            slot = (self.seed + j) % self.shape[0]
            got = {"xs": [], "ys": [], "routes": [], "last": None}

            def read(site, v, slot=slot, got=got):
                if site == "block":
                    got["xs"].append(v["x"][slot].cpu())
                    got["ys"].append(v["y"][slot].cpu())
                elif site == "moe.route":
                    got["routes"].append(v["idx"].to(torch.uint8).cpu().numpy())
                elif site == "final":
                    got["last"] = v["x"].cpu()

            with taps.reading(read):
                ids = self._request(self.prompts(i))
            self.replay_mismatch += int(not np.array_equal(ids,
                                                           self.served[i]))
            self.replays[i] = Replay(slot, **got)
        if self.replay_mismatch:
            log(f"{self.replay_mismatch} of {len(requests)} replayed requests "
                "served other ids than in the window")

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
        (the control). Also sets ``route_share``."""
        draw = reference_drawer(self.config,
                                lm.padded(self.config["vocab_size"]),
                                self.seed, self.device)
        sample = self.sample()
        prompts = [p for i in sample for p in self.prompts(i)]
        with ref.full_float32():
            want, routes = ref.last_logits(draw, prompts, self.config)
            best = want.max(-1).values
            widest = {}
            for name, p in picks.items():
                if isinstance(p, str):
                    got = ref.last_logits(draw, prompts, self.config,
                                          p)[0].argmax(-1)
                else:
                    got = torch.as_tensor(
                        np.concatenate([p[i] for i in sample]),
                        device=want.device)
                gap = best - want.gather(-1, got.long()[:, None])[:, 0]
                widest[name] = float(gap.max())
        self.route_share = self._route_share(sample, routes)
        return widest

    def _route_share(self, sample, routes) -> float:
        """Share of the reference's routed slots whose expert the
        program's selection for that token lacks (None without the
        program's selections)."""
        if not self.replays or not routes:
            return None
        missed = total = 0
        for b, want in enumerate(routes):
            prog = torch.as_tensor(np.concatenate(
                [self.replays[i].routes[b] for i in sample]),
                device=want.device)
            hit = (want[:, :, None] == prog.long()[:, None, :]).any(-1)
            missed += int((~hit).sum())
            total += hit.numel()
        return missed / total

    def block_gaps(self, quant=None) -> Tuple[List[float], float]:
        """(Each block's gap: |the program's mixer output - the reference
        mixer's| over |the reference's|, each fed the program's input to
        the block, over the sampled requests' recorded prompts; the route
        gap: how far the program's experts fall short of the reference's
        choice, widest over the MoE blocks (`reference.nemotron_h.
        route_gap`)). An MoE block's reference runs on the program's
        experts, so that rounding which swaps two experts at a near-tie
        reads as the tie's width in the route gap and not as the two
        experts' difference in the block's. With ``quant`` the reference
        in that precision, on its own experts, stands in the program's
        place (the control)."""
        draw = reference_drawer(self.config,
                                lm.padded(self.config["vocab_size"]),
                                self.seed, self.device)
        cfg = self.config
        eps = cfg["layer_norm_epsilon"]
        reps = [self.replays[i] for i in sorted(self.replays)]
        S = self.shape[1]
        out, route, moe = [], 0.0, 0
        with ref.full_float32():
            for b, kind in enumerate(cfg["hybrid_override_pattern"]):
                w = ref.block_weights(draw, b, kind)
                xs = [r.xs[b].to(self.device).float() for r in reps]
                gots = [r.ys[b].to(self.device).float() for r in reps]
                sel = None
                if quant:
                    gots, sel = ref.mixer(xs, w, kind, cfg, quant)
                elif kind == "E":
                    sel = torch.cat([torch.as_tensor(
                        r.routes[moe][r.slot * S:(r.slot + 1) * S],
                        device=self.device) for r in reps])
                if kind == "E":
                    moe += 1
                    h = ref.rmsnorm(torch.cat(xs), w["ln"], eps)
                    route = max(route, ref.route_gap(h, w, cfg, sel))
                    del h
                wants = ref.mixer(xs, w, kind, cfg, sel=sel)[0]
                err = den = 0.0
                for got, want in zip(gots, wants):
                    err += float((got - want).double().pow(2).sum())
                    den += float(want.double().pow(2).sum())
                out.append(math.sqrt(err / max(den, 1e-30)))
                del w, xs, gots, wants, sel
        return out, route

    def head_gap(self, picks=None, quant=None) -> float:
        """The widest gap, over the sampled requests' prompts, between the
        reference head's best logit and its logit of the served id, the
        head (final norm, untied head) fed the program's own last hidden
        state. ``picks``: other ids by request (a fault); ``quant``: the
        ids the head in that precision puts first (the control)."""
        draw = reference_drawer(self.config,
                                lm.padded(self.config["vocab_size"]),
                                self.seed, self.device)
        picks = picks or self.picks()
        widest = 0.0
        with ref.full_float32():
            for i in sorted(self.replays):
                h = self.replays[i].last.to(self.device).float()
                want = ref.head(h, draw, self.config)
                if quant:
                    got = ref.head(h, draw, self.config, quant).argmax(-1)
                else:
                    got = torch.as_tensor(picks[i], device=want.device).long()
                gap = want.max(-1).values - want.gather(-1, got[:, None])[:, 0]
                widest = max(widest, float(gap.max()))
        return widest

    def picks(self) -> Dict[int, np.ndarray]:
        """The first served id of each prompt, by request."""
        return {i: s[:, 0] for i, s in enumerate(self.served)}

    def check(self) -> Dict[str, Tuple[float, float]]:
        """The numbers the cell's limits name, each beside its limit; the
        others are logged, not compared."""
        blocks, route = self.block_gaps()
        values = {"logit_gap": self.gaps({"program": self.picks()})["program"],
                  "replay_mismatch": float(self.replay_mismatch),
                  "block_gap": max(blocks), "route_gap": route,
                  "head_gap": self.head_gap()}
        limits = self.cell["limits"]
        log(f"block gaps {[round(b, 5) for b in blocks]}; route gap "
            f"{route:.3e}; route_share "
            f"{self.route_share!r}; not compared: "
            f"{ {k: v for k, v in values.items() if k not in limits} }")
        return {k: (values[k], limits[k]) for k in limits}
