"""LR schedules: linear warmup into cosine / linear / constant decay."""
from __future__ import annotations

import numpy as np


def make_schedule(kind: str, peak_lr: float, warmup_steps: int, total_steps: int):
    """sched(step) -> the learning rate at ``step`` as a float, computed in
    float32 as the JAX package does (so lr is 0 at step 0); the decay ends
    at a tenth of the peak."""
    f32 = np.float32
    final_frac = 0.1
    warmup = max(1, warmup_steps)

    def sched(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(f32(peak_lr) * min(f32(1), s / f32(warmup)))
        frac = np.clip((s - f32(warmup)) / f32(max(1, total_steps - warmup)),
                       f32(0), f32(1))
        if kind == "cosine":
            decay = f32(final_frac) + f32((1 - final_frac) * 0.5) * (
                f32(1) + np.cos(f32(np.pi) * frac))
        elif kind == "linear":
            decay = f32(1) - f32(1 - final_frac) * frac
        else:  # constant
            decay = f32(1)
        return float(f32(peak_lr) * decay)

    return sched
