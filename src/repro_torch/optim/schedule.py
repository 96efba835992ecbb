"""LR schedules (cosine / linear / constant with linear warmup), the port
of `repro.optim.schedule`."""
from __future__ import annotations

import math

import torch

from repro_torch.common import TrainConfig


def make_schedule(tc: TrainConfig):
    """step -> learning rate as a float32 0-dim tensor."""
    def schedule(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(s / max(tc.warmup_steps, 1), max=1.0)
        frac = torch.clamp((s - tc.warmup_steps)
                           / max(tc.total_steps - tc.warmup_steps, 1),
                           0.0, 1.0)
        if tc.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        elif tc.schedule == "linear":
            decay = 1.0 - frac
        else:
            decay = 1.0
        return tc.learning_rate * warm * decay
    return schedule
