"""Plain PyTorch version of the fused pivot-search update (paper Eq. 6.3)."""

from __future__ import annotations

import torch


def greedy_update_ref(q: torch.Tensor, S: torch.Tensor, acc: torch.Tensor,
                      norms_sq: torch.Tensor,
                      active: torch.Tensor | None = None):
    """Reference semantics of one pivot-search update.

    Args:
      q:        (N,) current basis vector (real or complex).
      S:        (N, M) snapshot matrix.
      acc:      (M,) accumulated sum_j |c_j|^2 (real).
      norms_sq: (M,) reference norms (real).
      active:   optional 0-d bool tensor; ``None`` means true.  Where it is
                false the update is the one q = 0 gives: c = 0,
                ``acc_out = acc``, and the max / first-index argmax of
                ``norms_sq - acc``.

    Returns:
      c:        (M,) = q^H S (dtype of S).
      acc_out:  (M,) = acc + |c|^2.
      max_res:  ()  max_i (norms_sq - acc_out)_i.
      argmax:   ()  int64 first index of that maximum.
    """
    c = q.conj() @ S
    acc_out = acc + c.abs() ** 2
    if active is not None:
        c = torch.where(active, c, torch.zeros_like(c))
        acc_out = torch.where(active, acc_out, acc)
    res = norms_sq - acc_out
    return c, acc_out, res.max(), res.argmax()
