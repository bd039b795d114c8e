"""The paper's error identities (Thms 3.2, 4.1, 4.3; Cors 4.4, 5.6, 5.7).

The functions that form ``E = S - Q Q^H S`` work in column chunks of
``col_chunk`` columns, so that at full width (S of 10.5 GB) no second
S-sized tensor exists; each column's value does not depend on the chunk.
"""

from __future__ import annotations

import torch

from repro_torch.sums import column_norms_sq

COL_CHUNK = 8192


def project_chunk(X: torch.Tensor, Q: torch.Tensor):
    """``C = Q^H X`` and ``|X - Q C|^2`` per column of one column chunk:
    the refresh's residuals, the products by ``torch.matmul`` and the
    squares summed in a fixed order (:mod:`repro_torch.sums`).  On the card
    a chunk's columns do not depend on where the chunk's view starts
    (checked by ``chip_smoke.py``)."""
    C = Q.mH @ X
    return C, column_norms_sq(X - Q @ C)


def residual_chunks(S: torch.Tensor, Q: torch.Tensor, col_chunk: int):
    """``S - Q Q^H S``, ``col_chunk`` columns at a time, in column order."""
    Qh = Q.mH
    for lo in range(0, S.shape[1], col_chunk):
        Sc = S[:, lo:lo + col_chunk]
        yield Sc - Q @ (Qh @ Sc)


def per_column_errors(S: torch.Tensor, Q: torch.Tensor,
                      col_chunk: int = COL_CHUNK) -> torch.Tensor:
    """|s_i - Q Q^H s_i|_2 for every column (Thm 4.3: equals |r~_i|_2)."""
    return torch.cat([torch.linalg.vector_norm(E, dim=0)
                      for E in residual_chunks(S, Q, col_chunk)])


def proj_error_max(S: torch.Tensor, Q: torch.Tensor,
                   col_chunk: int = COL_CHUNK) -> torch.Tensor:
    """max_i |s_i - Q Q^H s_i|_2  (Eq. 4.6; RB-greedy's error functional)."""
    return per_column_errors(S, Q, col_chunk).max()


def proj_error_fro(S: torch.Tensor, Q: torch.Tensor,
                   col_chunk: int = COL_CHUNK) -> torch.Tensor:
    """|S - Q Q^H S|_F."""
    return torch.linalg.vector_norm(per_column_errors(S, Q, col_chunk))


def proj_error_2norm(S: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """|S - Q Q^H S|_2  (Thm 4.1 LHS).  Forms E whole: small S only."""
    return torch.linalg.matrix_norm(S - Q @ (Q.mH @ S), ord=2)


def r22_norm(R: torch.Tensor, k: int, ord=2) -> torch.Tensor:
    """|R22|_* for a full triangular factor R and split index k (Thm 4.1);
    ``ord`` 2, or ``"fro"`` / None for the Frobenius norm."""
    return torch.linalg.matrix_norm(R[k:, k:], ord="fro" if ord is None
                                    else ord)


def greedy_error_determinant_identity(sigmas: torch.Tensor,
                                      r_diag: torch.Tensor,
                                      k: int) -> torch.Tensor:
    """Corollary 5.7 RHS: (prod_{i<=k+1} sigma_i) / (prod_{i<=k} R(i,i)).

    Computed in log space for stability.
    """
    log_num = torch.log(sigmas[:k + 1]).sum()
    log_den = torch.log(r_diag[:k]).sum()
    return torch.exp(log_num - log_den)


def orthogonality_defect(Q: torch.Tensor) -> torch.Tensor:
    """|I - Q^H Q|_2 — Hoffmann's conjecture: ~ kappa * eps * sqrt(M)."""
    k = Q.shape[1]
    eye = torch.eye(k, dtype=Q.dtype, device=Q.device)
    return torch.linalg.matrix_norm(eye - Q.mH @ Q, ord=2)
