"""Algorithm 1 (POD) and the POD error identities of Theorem 3.2.

PyTorch port of :mod:`repro.core.pod`.  POD computes the optimal rank-k
*-norm approximation of the snapshot matrix ``S`` (* = 2 or F): compute the
SVD, pick the smallest k with ``sigma_{k+1} < tau``, return the first k left
singular vectors.  Singular vectors are unique only up to a phase per
column, so a basis from here and one from another SVD (LAPACK, cuSOLVER,
XLA) agree as subspaces, not column by column.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PODResult(NamedTuple):
    """Result of Algorithm 1.

    Attributes:
      basis:  (N, min(N, M)) left singular vectors; columns beyond ``k`` are
              still valid singular vectors (full economy SVD) — use
              ``basis[:, :k]`` for the tolerance-selected POD basis.
      sigmas: (min(N, M),) singular values, non-increasing.
      k:      smallest k such that sigma_{k+1} < tau  (Algorithm 1, step 4).
    """

    basis: torch.Tensor
    sigmas: torch.Tensor
    k: int


def _svd(S, device=None):
    from repro_torch.data.providers import materialize_source

    S = materialize_source(S, device)
    return torch.linalg.svd(S, full_matrices=False)


def first_below(sigmas: torch.Tensor, tau: float) -> int:
    """The first index j with ``sigmas[j] < tau`` (``len(sigmas)`` if none):
    Algorithm 1's k, since the paper's sigma_{k+1} is ``sigmas[k]``."""
    below = torch.nonzero(sigmas < tau)
    return int(below[0, 0]) if below.numel() else int(sigmas.shape[0])


def pod_basis(S, k: int, device=None) -> torch.Tensor:
    """First k left singular vectors of S (the rank-k POD basis)."""
    return _svd(S, device)[0][:, :k]


def pod(S, tau: float, device=None) -> PODResult:
    """Algorithm 1: POD with error tolerance ``tau`` (2-norm criterion).

    By Theorem 3.2(ii), ``|S - V_k V_k^H S|_2 = sigma_{k+1}``, so choosing
    the smallest k with ``sigma_{k+1} < tau`` guarantees a 2-norm projection
    error below ``tau``.  ``S`` may be anything
    :func:`repro_torch.data.providers.materialize_source` accepts; it is
    placed on ``device`` (``cuda`` unless ``device="cpu"``).
    """
    V, sig, _ = _svd(S, device)
    return PODResult(basis=V, sigmas=sig, k=first_below(sig, tau))


def _pod_residual(S, k, device):
    from repro_torch.data.providers import materialize_source

    S = materialize_source(S, device)
    Vk = pod_basis(S, k, S.device)
    return S - Vk @ (Vk.mH @ S)


def pod_error_2norm(S, k: int, device=None) -> torch.Tensor:
    """|S - V_k V_k^H S|_2 — equals sigma_{k+1} by Theorem 3.2(ii)."""
    return torch.linalg.matrix_norm(_pod_residual(S, k, device), ord=2)


def pod_error_fro(S, k: int, device=None) -> torch.Tensor:
    """|S - V_k V_k^H S|_F — equals sqrt(sum_{j>k} sigma_j^2)
    (Thm 3.2(i))."""
    return torch.linalg.matrix_norm(_pod_residual(S, k, device))
