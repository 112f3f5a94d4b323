"""Learning-rate schedules (pure functions of the step), as the JAX package's
``optim/schedules.py``. ``step`` is an int or a 0-dim tensor (the optimizer
state's counter); the rate is a 0-dim fp32 tensor on the step's device."""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

Step = Union[int, torch.Tensor]


def _as_float(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(
    peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
) -> Callable[[Step], torch.Tensor]:
    def schedule(step):
        step = _as_float(step)
        # (step + 1): the first optimizer step must not be a zero-lr no-op
        warm = peak_lr * (step + 1.0) / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def constant(lr: float) -> Callable[[Step], torch.Tensor]:
    return lambda step: torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)


def linear_decay(peak_lr: float, warmup_steps: int, total_steps: int) -> Callable[[Step], torch.Tensor]:
    def schedule(step):
        step = _as_float(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp(1.0 - (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, peak_lr * frac)

    return schedule
