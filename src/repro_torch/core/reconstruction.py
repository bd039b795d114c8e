"""Algorithm 4: the reconstruction approach to QR (Sec. 5.2.2).

PyTorch port of :mod:`repro.core.reconstruction`.  Run a partial pivoted
greedy/MGS to j terms (cheap: O(jNM)), then take the SVD of the *small*
(j x M) triangular factor R and rotate the QR basis by its left singular
vectors:

    X_k = Q_j @ Vbar[:, :k].

Theorem 5.11: |S - X_j X_j^H S|_2 <= sigma(S_1)_{j+1} + |R22|_2, i.e. the
reconstructed basis behaves like POD whenever |R22| is small (Remark 5.13) —
at QR cost (Remark 5.9: O(M j^2 + N j^2) on top of the partial QR instead
of a full N x M SVD).  The partial QR is :func:`rb_greedy`, so on a CUDA
tensor it runs through the ``greedy_update`` and ``imgs_project`` kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.greedy import rb_greedy
from repro_torch.core.pod import first_below


class ReconstructionResult(NamedTuple):
    X: torch.Tensor         # (N, j) reconstructed (SVD-rotated) basis
    Qj: torch.Tensor        # (N, j) greedy/QR basis actually computed
    sigmas_R: torch.Tensor  # (j,) singular values of R(1:j, 1:M)
    j: int                  # partial QR depth (tau_1 criterion)
    k: int                  # selected rank (tau_2 criterion)


def reconstruction(S, tau1: float, tau2: float, max_j: int | None = None,
                   backend: str | None = None,
                   device=None) -> ReconstructionResult:
    """Algorithm 4.

    Step 3: partial pivoted QR (RB-greedy == MGS, Prop 5.3) until
            R(j,j) < tau1.
    Step 5: SVD of R(1:j, 1:M)  (j x M — small).
    Step 6: pick k with sigma_{k+1} < tau2.
    Step 7: X_k = Q_j Vbar(:, 1:k)  (the full rotation is returned; the
            caller slices ``X[:, :k]``).

    ``S`` is placed on ``device`` (``cuda`` unless ``device="cpu"``).
    """
    res = rb_greedy(S, tau=tau1, max_k=max_j, backend=backend, device=device)
    j = int(res.k)
    Qj = res.Q[:, :j]
    Vbar, sig, _ = torch.linalg.svd(res.R[:j, :], full_matrices=False)
    return ReconstructionResult(X=Qj @ Vbar, Qj=Qj, sigmas_R=sig, j=j,
                                k=first_below(sig, tau2))
