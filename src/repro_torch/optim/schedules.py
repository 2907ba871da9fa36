"""LR schedules (pure functions of the step)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10000,
                    min_ratio: float = 0.1):
    """Linear warmup, then cosine decay to ``min_ratio``: a float32 0-d
    tensor of the int step (an int or a tensor, on its device)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * (min_ratio + (1 - min_ratio) * cos)
