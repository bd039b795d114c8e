"""Plain PyTorch version of the cache probe: ``reps`` dots of the working
set with itself, one torch op each (so one launch a pass on a card, which
is why the card takes the kernel)."""

from __future__ import annotations

import torch


def llc_probe_ref(x: torch.Tensor, reps: int) -> torch.Tensor:
    """``reps * (x . x)`` as a 1-element tensor, summed pass by pass."""
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(reps):
        acc = acc + torch.dot(x, x)
    return acc.reshape(1)
