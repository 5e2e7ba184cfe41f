"""LR schedules (mirror of ``repro/optim/schedule.py``): pure functions of
the step."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    """Multiplier in [floor, 1], f32: linear warmup then cosine decay.
    ``step`` is an int or a () tensor (the result lands on its
    device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    return warm * (floor + (1 - floor) * cos)
