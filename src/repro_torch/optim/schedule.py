"""Learning-rate schedules.

The port of :mod:`repro.optim.schedule`: the schedule is computed in
float32 tensors, as the reference computes it in ``jnp.float32``, so that
both packages give the same learning rate to the bit; a step held in a
device tensor gives a learning rate on that device with no host sync.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps to ``base_lr``, then a cosine
    decay to ``min_ratio * base_lr`` at ``total``; a 0-d float32 tensor
    on the device of ``step`` (a tensor, or a number: the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=step.device)
    warm = base_lr * torch.minimum(
        step / torch.tensor(max(warmup, 1), **f32), torch.tensor(1.0, **f32))
    prog = torch.clamp((step - warmup) / torch.tensor(
        max(total - warmup, 1), **f32), 0, 1)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, **f32) * prog))
    return torch.where(step < warmup, warm, base_lr * cos)
