"""LR schedules (the counterpart of ``src/repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor *
    peak_lr``.  ``step`` is a python int or a 0-d tensor; returns a 0-d
    float32 tensor on the step's device (the CPU for an int).  As in the
    reference, a tensor step computes in float32 throughout, and an int
    step takes the warm-up and the cosine's phase in double precision
    before rounding them to float32."""
    if isinstance(step, torch.Tensor):
        s, dev = step.float(), step.device
    else:
        s, dev = float(step), torch.device("cpu")
    f32 = dict(dtype=torch.float32, device=dev)
    warm = torch.as_tensor(peak_lr * s / max(1, warmup), **f32)
    frac = torch.clamp(torch.as_tensor((s - warmup) / max(1, total - warmup), **f32),
                       0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(torch.as_tensor(s < warmup, device=dev), warm, cos)
