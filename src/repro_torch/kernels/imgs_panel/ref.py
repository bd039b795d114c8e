"""Plain PyTorch version of one classical-GS panel projection pass."""

from __future__ import annotations

import torch


def imgs_panel_ref(V: torch.Tensor, Q: torch.Tensor):
    """One classical-GS pass on a whole candidate panel: C = Q^H V;
    V' = V - Q C.

    Args:
      V: (N, p) candidate panel (zero columns are no-ops).
      Q: (N, K) basis (zero columns are no-ops).

    Returns (V', C) with C: (K, p).
    """
    C = Q.mH @ V
    return V - Q @ C, C
