"""Learning-rate schedules: pure functions of the step counter (the
counterpart of `repro.optim.schedules`), computed in float32 as the
reference's are and returned as Python floats."""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    def f(step):
        return float(np.float32(lr))
    return f


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        step = np.float32(int(step))
        if step < warmup_steps:
            return float(np.float32(peak_lr) * step
                         / np.float32(max(warmup_steps, 1)))
        t = np.clip((step - np.float32(warmup_steps))
                    / np.float32(max(total_steps - warmup_steps, 1)),
                    np.float32(0.0), np.float32(1.0))
        cos = np.float32(peak_lr) * (
            np.float32(final_frac) + np.float32((1 - final_frac) * 0.5)
            * (np.float32(1) + np.cos(np.float32(np.pi) * t)))
        return float(np.float32(cos))
    return f
