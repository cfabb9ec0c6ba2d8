"""Learning-rate schedules (pure functions of the step counter): port of
``repro/optim/schedule.py``, computed in float32 as the reference does.
The step may be a 0-d tensor (the optimizer's count, on its device) or a
Python int; the rate comes back as a 0-d float32 tensor on the step's
device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def constant_schedule(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32, device=_f32(step).device)
    return fn


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` then cosine decay to final_frac*peak."""
    def fn(step):
        step = _f32(step) + 1.0                        # lr > 0 from step 0
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return fn
