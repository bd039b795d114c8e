"""Plain PyTorch version of the B-lane pivot-search sweep: the scalar
plain version (:func:`repro_torch.kernels.greedy_update.ref.
greedy_update_ref`) lane by lane."""

from __future__ import annotations

import torch

from repro_torch.kernels.greedy_update.ref import greedy_update_ref


def greedy_update_lanes_ref(q: torch.Tensor, S: torch.Tensor,
                            acc: torch.Tensor, norms_sq: torch.Tensor,
                            active: torch.Tensor | None = None):
    """Reference semantics of one lockstep sweep of B lanes.

    Args:
      q:        (B, N) one current basis vector a lane.
      S:        (N, M) shared by every lane, or (B, N, M) stacked (lane b
                reads ``S[b]``).
      acc:      (B, M) each lane's accumulated sum_j |c_j|^2.
      norms_sq: (B, M) each lane's reference norms.
      active:   optional (B,) bool tensor; ``None`` means every lane.  A
                false lane gets what q = 0 gives.

    Returns ``(c, acc_out, max_res, argmax)`` of shapes (B, M), (B, M),
    (B,), (B,): lane b is ``greedy_update_ref`` on its operands.
    """
    outs = [greedy_update_ref(q[b], S if S.dim() == 2 else S[b], acc[b],
                              norms_sq[b],
                              None if active is None else active[b])
            for b in range(q.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))
