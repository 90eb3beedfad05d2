"""Learning-rate schedules (multipliers on the base lr): the port's twin of
``repro/optim/schedule.py``.  Each takes the step as a tensor and returns
an f32 0-d tensor on its device, computed op for op as the reference."""

from __future__ import annotations

import math

import torch


def constant():
    return lambda step: torch.ones((), dtype=torch.float32, device=step.device)


def warmup_cosine(warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = s / max(1.0, warmup_steps)
        prog = torch.clamp((s - warmup_steps) / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


def warmup_linear(warmup_steps: int, total_steps: int):
    def fn(step):
        s = step.to(torch.float32)
        warm = s / max(1.0, warmup_steps)
        decay = torch.clamp(1.0 - (s - warmup_steps) / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
        return torch.where(s < warmup_steps, warm, decay)

    return fn
