"""Learning-rate schedules (twin of ``repro.optim.schedule``): pure
functions of the step, computed in f32 as the reference computes them, and
returned as Python floats. Under warmup ``lr(0) == 0``."""

from __future__ import annotations

import numpy as np


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    f32 = np.float32

    def lr(step) -> float:
        step = f32(step)
        warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
        t = np.clip((step - f32(warmup_steps))
                    / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
        cos = f32(peak_lr) * (f32(final_frac) + f32(1 - final_frac) * f32(0.5)
                              * (f32(1) + np.cos(f32(np.pi) * t)))
        return float(warm if step < warmup_steps else cos)

    return lr


def constant_schedule(lr_value: float):
    def lr(step) -> float:
        return float(np.float32(lr_value))

    return lr
