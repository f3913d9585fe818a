"""Charge-sharing model of triple-row activation (paper §3.1-§3.3, Table 1).

The counterpart of `repro.core.spice`: the same analog model on float32
tensors, with the same constants.

  1. Charge sharing: with per-cell capacitances C_i (process variation) and
     bitline capacitance C_b, the post-sharing bitline deviation is
         delta = (sum_i V_i C_i + C_b*VDD/2) / (sum_i C_i + C_b) - VDD/2.
     Eq. 1 is the special case C_i = C_c: delta = (2k-3)C_c/(6C_c+2C_b)*VDD.
  2. Sensing: an RC-style latency t_sense = tau * ln(VDD/2 / |delta|) plus a
     restore term that is larger when driving cells to VDD than to 0
     (the paper's 20.9 ns charged vs 13.5 ns empty single-cell
     activations).
  3. Failure: the amplifier has a logic-1-biased offset under multi-wordline
     activation, so a "0"-majority TRA fails when delta > -delta_margin.
     Calibrated so the first failure appears at +-25% variation for the
     1s0w0w case and nowhere else, Table 1's structure.

`monte_carlo_tra` draws its stored values and capacitances from a
`torch.Generator` on its device (`draw_trials`) and evaluates them with
`tra_trials`, a pure step that takes the draws, so any source of draws
can be held to the same evaluation. Table 1 runs on ``device`` (default ``"cuda"``, which
raises where there is no card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class SpiceParams:
    c_cell_ff: float = 22.0      # cell capacitance (paper §3.3)
    c_bitline_ff: float = 85.0   # bitline capacitance (Rambus 55nm class)
    vdd: float = 1.2
    tau_ns: float = 1.82          # sense-amp RC constant (calibrated)
    t_restore_0_ns: float = 14.8  # drive bitline+cells to 0
    t_restore_1_ns: float = 20.7  # drive to VDD (slower, cf. 20.9 vs 13.5 ns)
    sense_offset_frac: float = 0.024  # logic-1-biased offset (fraction of VDD)


DEFAULT_SPICE = SpiceParams()


def bitline_deviation(cell_values: torch.Tensor, cell_caps_ff: torch.Tensor,
                      p: SpiceParams = DEFAULT_SPICE) -> torch.Tensor:
    """Generalized Eq. 1: deviation after charge sharing (volts).

    cell_values: (..., k) in {0,1}; cell_caps_ff: (..., k).
    """
    q_cells = (cell_values * cell_caps_ff).sum(-1) * p.vdd
    q_bl = p.c_bitline_ff * p.vdd / 2.0
    c_tot = cell_caps_ff.sum(-1) + p.c_bitline_ff
    return (q_cells + q_bl) / c_tot - p.vdd / 2.0


def eq1_deviation(k: int, p: SpiceParams = DEFAULT_SPICE) -> float:
    """Paper Eq. 1 (no variation)."""
    cc, cb = p.c_cell_ff, p.c_bitline_ff
    return (2 * k - 3) * cc / (6 * cc + 2 * cb) * p.vdd


def sense(delta: torch.Tensor, p: SpiceParams = DEFAULT_SPICE
          ) -> torch.Tensor:
    """Sensed logic value: amplifier has a +offset bias under TRA."""
    return (delta + p.sense_offset_frac * p.vdd) > 0


def tra_latency_ns(delta: torch.Tensor, result: torch.Tensor,
                   p: SpiceParams = DEFAULT_SPICE) -> torch.Tensor:
    """Activation latency: sense time grows as |delta| shrinks, plus the
    restore time of the final value."""
    mag = delta.abs().clamp_min(1e-6)
    t_sense = p.tau_ns * torch.log(p.vdd / 2.0 / mag)
    t_restore = torch.where(result, p.t_restore_1_ns, p.t_restore_0_ns)
    return t_sense + t_restore


# --------------------------------------------------------------------------
# Table 1 reproduction: strong/weak cell cases under +-variation.
# --------------------------------------------------------------------------

# (name, values (strong first), expected majority)
TABLE1_CASES: List[Tuple[str, Tuple[int, int, int], int]] = [
    ("0s0w0w", (0, 0, 0), 0),
    ("1s0w0w", (1, 0, 0), 0),
    ("0s1w1w", (0, 1, 1), 1),
    ("1s1w1w", (1, 1, 1), 1),
]

VARIATIONS = (0.0, 0.05, 0.10, 0.15, 0.20, 0.25)


def table1_entry(values: Tuple[int, int, int], variation: float,
                 p: SpiceParams = DEFAULT_SPICE,
                 device="cuda") -> Dict[str, float]:
    """Deterministic worst case: strong cell at C(1+v), weak at C(1-v),
    with the strong cell opposing the majority (paper's adversarial setup)."""
    dev = resolve_device(device)
    caps = torch.tensor([p.c_cell_ff * (1 + variation),
                         p.c_cell_ff * (1 - variation),
                         p.c_cell_ff * (1 - variation)],
                        dtype=torch.float32, device=dev)
    vals = torch.tensor(values, dtype=torch.float32, device=dev)
    delta = bitline_deviation(vals, caps, p)
    expected = int(np.sum(values) >= 2)
    sensed = sense(delta, p)
    result = bool(sensed)
    lat = float(tra_latency_ns(delta, sensed, p))
    return {
        "delta_v": float(delta),
        "latency_ns": lat,
        "result": result,
        "expected": expected,
        "fails": result != expected,
    }


def table1(p: SpiceParams = DEFAULT_SPICE, device="cuda"
           ) -> Dict[str, Dict[float, Dict]]:
    return {
        name: {v: table1_entry(vals, v, p, device) for v in VARIATIONS}
        for name, vals, _ in TABLE1_CASES
    }


def tra_trials(values: torch.Tensor, caps: torch.Tensor,
               p: SpiceParams = DEFAULT_SPICE) -> Dict[str, torch.Tensor]:
    """Evaluate TRA trials: values (n, 3) float32 in {0, 1}, caps (n, 3)
    float32 fF -> failure rate (digital-majority mismatch), failure count
    and mean latency, as 0-dim tensors on their device."""
    delta = bitline_deviation(values, caps, p)
    sensed = sense(delta, p)
    expected = values.sum(-1) >= 2
    fail = sensed != expected
    return {
        "failure_rate": fail.float().mean(),
        "n_fail": fail.sum(),
        "mean_latency_ns": tra_latency_ns(delta, sensed, p).mean(),
    }


def draw_trials(generator: torch.Generator, n_trials: int,
                variation_sigma: float, p: SpiceParams = DEFAULT_SPICE
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random stored values (n, 3) in {0, 1} and cell capacitances (n, 3)
    with Gaussian process variation, clipped to [0.5, 1.5] C_c, float32
    on ``generator``'s device."""
    dev = torch.device(generator.device)
    values = (torch.rand((n_trials, 3), generator=generator, device=dev)
              < 0.5).float()
    caps = p.c_cell_ff * (1.0 + variation_sigma * torch.randn(
        (n_trials, 3), generator=generator, device=dev))
    return values, caps.clamp(p.c_cell_ff * 0.5, p.c_cell_ff * 1.5)


def monte_carlo_tra(generator: torch.Generator, n_trials: int,
                    variation_sigma: float,
                    p: SpiceParams = DEFAULT_SPICE
                    ) -> Dict[str, torch.Tensor]:
    """Randomized reliability check: sample cell capacitances with Gaussian
    process variation and random stored values (`draw_trials`); report
    failure rate of TRA (digital-majority mismatch), the justification for
    `core.engine`'s digital abstraction."""
    return tra_trials(*draw_trials(generator, n_trials, variation_sigma, p),
                      p)
