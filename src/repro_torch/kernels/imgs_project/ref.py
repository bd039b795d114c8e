"""Plain PyTorch version of one iterated-Gram-Schmidt projection pass."""

from __future__ import annotations

import torch


def imgs_project_ref(v: torch.Tensor, Q: torch.Tensor,
                     active: torch.Tensor | None = None):
    """One classical-GS pass: c = Q^H v; v' = v - Q c.

    Args:
      v: (N,) vector to orthogonalize.
      Q: (N, K) basis (zero columns are no-ops).
      active: optional 0-d bool tensor; ``None`` means true.  Where it is
        false the pass is the one Q = 0 gives: ``(v, 0)``.

    Returns (v', c) with c: (K,).
    """
    c = Q.mH @ v
    v_out = v - Q @ c
    if active is None:
        return v_out, c
    return (torch.where(active, v_out, v),
            torch.where(active, c, torch.zeros_like(c)))
