"""Learning-rate schedules (mirror of ``repro.optim.schedules``): callables
of the step, a device int tensor, returning a 0-dim fp32 tensor on the
step's device, so the update never reads the step back to the host."""

from __future__ import annotations

import math
from typing import Callable

import torch


def constant(lr: float) -> Callable:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0) -> Callable:
    def fn(step):
        s = step.float()
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0, 1)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)
    return fn


def warmup_rsqrt(peak: float, warmup_steps: int) -> Callable:
    def fn(step):
        s = torch.clamp(step.float(), min=1.0)
        warm = peak * s / max(warmup_steps, 1)
        decay = peak * math.sqrt(warmup_steps) / torch.sqrt(s)
        return torch.where(s < warmup_steps, warm, decay)
    return fn


def linear_decay(peak: float, warmup_steps: int, total_steps: int) -> Callable:
    def fn(step):
        s = step.float()
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0, 1)
        return torch.where(s < warmup_steps, warm, peak * (1 - t))
    return fn
