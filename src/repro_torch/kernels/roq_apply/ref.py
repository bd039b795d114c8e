"""Plain PyTorch version of the ROQ serving interpolant apply."""

from __future__ import annotations

import torch


def roq_apply_ref(B: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """``B @ F``: the empirical interpolant (N, k) applied to a (k, nb)
    batch of requests at the EIM nodes; returns (N, nb).

    On the CPU this is also the serving path.  Its per-column bits do not
    depend on nb with the CPU BLAS PyTorch ships (MKL), for every dtype —
    what ``tests/test_torch_serving.py`` holds it to.
    """
    return B @ F
