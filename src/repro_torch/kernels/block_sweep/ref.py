"""Plain PyTorch version of the fused blocked Eq.-(6.3) panel sweep."""

from __future__ import annotations

import torch


def block_sweep_ref(Qnew: torch.Tensor, S: torch.Tensor, acc: torch.Tensor):
    """Reference semantics of one blocked pivot-sweep update.

    Args:
      Qnew: (N, p) the block's new basis vectors (rejected in-block
            candidates are zero columns, exact no-ops).
      S:    (N, M) snapshot matrix.
      acc:  (M,) accumulated sum_j |c_j|^2 (real).

    Returns:
      C:       (p, M) = Qnew^H S (dtype of S), the block's rows of R.
      acc_out: (M,) = acc + sum_i |C[i]|^2.
    """
    C = Qnew.mH @ S
    return C, acc + (C.abs() ** 2).sum(0)
