"""Plain PyTorch version of one iterated-Gram-Schmidt projection pass."""

from __future__ import annotations

import torch


def imgs_project_ref(v: torch.Tensor, Q: torch.Tensor):
    """One classical-GS pass: c = Q^H v; v' = v - Q c.

    Args:
      v: (N,) vector to orthogonalize.
      Q: (N, K) basis (zero columns are no-ops).

    Returns (v', c) with c: (K,).
    """
    c = Q.mH @ v
    return v - Q @ c, c
