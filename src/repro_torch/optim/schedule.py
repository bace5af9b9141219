"""Learning-rate schedules: functions of the 0-d step tensor that return a
0-d float32 tensor on its device (the reference's ``optim/schedule.py``).
Divisions are by tensors, so the card divides as the CPU does (CUDA turns
division by a Python scalar into a multiply by its rounded reciprocal)."""

from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def _div(s: torch.Tensor, d: int) -> torch.Tensor:
    return s / torch.tensor(float(d), device=s.device)


def linear_warmup(peak: float, warmup_steps: int):
    def f(step):
        s = torch.as_tensor(step).float()
        return peak * torch.clamp(_div(s, max(warmup_steps, 1)), max=1.0)
    return f


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).float()
        warm = peak * torch.clamp(_div(s, max(warmup_steps, 1)), max=1.0)
        frac = torch.clamp(_div(s - warmup_steps,
                                max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, peak * cos)
    return f
