"""Optimal RRQR (Theorem 5.1) and its exactness property.

PyTorch port of :mod:`repro.core.rrqr`.  Theorem 5.1 constructs a QR
factorization whose rank-k projection error is *exactly* ``sigma_{k+1}`` —
the POD optimum:

    S = V Sigma W^H              (SVD)
    Q_s R_s = qr(Sigma_k W_k^H)  (QR of the k x M top block)
    Q_k = V_k @ Q_s

The permutation is the identity.  This is the theoretical bridge between
the SVD and QR worlds; it is not a cheap algorithm (it needs an SVD), but it
proves the *existence* target the practical algorithms (Algs. 2/3) aim for.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OptimalRRQR(NamedTuple):
    Qk: torch.Tensor      # (N, k) basis with |S - Qk Qk^H S|_2 = sigma_{k+1}
    R: torch.Tensor       # (k, M) triangular factor rows (= R_s)
    sigmas: torch.Tensor  # singular values of S


def optimal_rrqr(S, k: int, device=None) -> OptimalRRQR:
    """Construct the Theorem-5.1 optimal RRQR of rank k.  ``S`` is placed on
    ``device`` (``cuda`` unless ``device="cpu"``)."""
    from repro_torch.data.providers import materialize_source

    S = materialize_source(S, device)
    V, sig, Wh = torch.linalg.svd(S, full_matrices=False)
    # Sigma_k W_k^H is (k, M): the top-k rows of Sigma @ W^H; its reduced
    # QR (wide: Q_s (k, k), R_s (k, M)) gives the factorization directly
    top = sig[:k, None].to(S.dtype) * Wh[:k, :]
    Qs, Rs = torch.linalg.qr(top, mode="reduced")
    return OptimalRRQR(Qk=V[:, :k] @ Qs, R=Rs, sigmas=sig)


def rrqr_error_2norm(S: torch.Tensor, Qk: torch.Tensor) -> torch.Tensor:
    """|S - Qk Qk^H S|_2 (equals sigma_{k+1} for the optimal RRQR)."""
    return torch.linalg.matrix_norm(S - Qk @ (Qk.mH @ S), ord=2)
