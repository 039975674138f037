"""Learning-rate schedules, the reference's: a frozen copy of the port's
(`train/schedule.py`), the log-lerp of LiDAR-GS's get_expon_lr_func.
"""
from __future__ import annotations

import math

import torch

from .config import LrSchedule

_F32 = torch.float32


def _as_step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def expon_lr(s: LrSchedule):
    """Log-linear interpolation init->final over max_steps with an optional
    sine-eased delay: fn(step) -> lr."""
    if s.init == 0.0 and s.final == 0.0:
        return lambda step: torch.zeros((), dtype=_F32, device=_as_step(step).device)

    def fn(step):
        step = _as_step(step)
        log_init = torch.log(torch.full((), s.init, dtype=_F32, device=step.device))
        log_final = torch.log(torch.full((), s.final, dtype=_F32, device=step.device))
        if s.delay_steps > 0:
            delay = s.delay_mult + (1 - s.delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / s.delay_steps, 0.0, 1.0))
        else:
            delay = 1.0
        t = torch.clamp(step / s.max_steps, 0.0, 1.0)
        lr = torch.exp(log_init * (1 - t) + log_final * t)
        return torch.where(step < 0, torch.zeros_like(lr), delay * lr)

    return fn


def const_lr(value: float):
    return lambda step: torch.full((), value, dtype=_F32, device=_as_step(step).device)
