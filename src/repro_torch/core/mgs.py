"""Algorithm 2: modified Gram-Schmidt with column pivoting.

PyTorch port of :mod:`repro.core.mgs`: the faithful, column-sweep MGS of
the paper (the linear-algebra community's presentation), kept as the
*reference* implementation for the equivalence result (Proposition 5.3):
it selects the same pivots as :func:`repro_torch.core.greedy.rb_greedy` and
spans the same subspace.

The working matrix V is one copy of S, deflated IN PLACE by a rank-1
update per step (``V.addr_``): no second S-sized temporary, so the build
holds S plus one working copy — Remark 5.4's memory overhead relative to
RB-greedy — and each step reads V twice and writes it once, where
RB-greedy reads S once (MGS's O(6kNM) against greedy's O(2kNM)).

The pivot is the argmax of the squared column norms, summed as the greedy
driver sums its initial ones (in column chunks, so they add no S-sized
temporary either): at step 0 both algorithms then compare the same
numbers.  Columns whose norms agree to the last bit — unnormalized TaylorF2
snapshots have one amplitude whatever the masses — otherwise part the two
pivot orders on rounding at the very first step.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch


class MGSResult(NamedTuple):
    Q: torch.Tensor        # (N, k) orthonormal basis (pivoted order)
    R: torch.Tensor        # (k, M) triangular rows in ORIGINAL column order
    pivots: torch.Tensor   # (k,) int32 selected columns
    r_diag: torch.Tensor   # (k,) float64 R(j, j) == column norms at pick
    k: int


def mgs_pivoted_qr(S, tau: float, max_k: int | None = None,
                   device=None) -> MGSResult:
    """Deprecated entry point: use ``repro_torch.api.build_basis(source=S,
    strategy="mgs", tau=tau)``.

    Pivoted MGS selects the same pivots as RB-greedy (Prop. 5.3) — as a
    *public* entry point it is redundant with the front door, which also
    returns the unified :class:`~repro_torch.api.artifact.ReducedBasis`
    artifact.  This wrapper delegates to the Prop.-5.3 oracle unchanged.
    """
    warnings.warn(
        "mgs_pivoted_qr is deprecated: call repro_torch.api.build_basis("
        "source=S, strategy='mgs', tau=tau) instead (identical pivots and "
        "basis, unified ReducedBasis result)",
        DeprecationWarning,
        stacklevel=2,
    )
    return _mgs_pivoted_qr_impl(S, tau, max_k, device)


def _mgs_pivoted_qr_impl(S, tau: float, max_k: int | None = None,
                         device=None) -> MGSResult:
    """Algorithm 2 (host-loop reference implementation).

    Stops when ``R(k,k) = max_j |V(:,j)|_2 < tau`` (the paper's criterion,
    equal to the RB-greedy max-residual by Cor. 5.6) or at ``max_k``.  One
    host sync per step (the pivot and its norm).

    ``S`` may be anything
    :func:`repro_torch.data.providers.materialize_source` accepts; it is
    placed on ``device`` (``cuda`` unless ``device="cpu"``).
    """
    from repro_torch.core.greedy import _column_norms_sq
    from repro_torch.data.providers import materialize_source

    S = materialize_source(S, device)
    N, M = S.shape
    if max_k is None:
        max_k = min(N, M)
    max_k = min(max_k, N, M)

    V = S.clone()
    Q = torch.zeros((N, max_k), dtype=S.dtype, device=S.device)
    R = torch.zeros((max_k, M), dtype=S.dtype, device=S.device)
    pivots, r_diag = [], []
    for k in range(max_k):
        # max along a dim gives the first index of the maximum, as argmax
        rkk_sq, j = _column_norms_sq(V).max(dim=0)
        rkk = torch.sqrt(rkk_sq)
        rkk_f, j = float(rkk), int(j)
        if rkk_f < tau:
            break
        q = V[:, j] / rkk.to(V.dtype)
        # MGS deflation: R(k, :) = q^H V are the coefficients against the
        # *current* working columns; by Prop 5.3 these equal q^H S for the
        # not-yet-pivoted columns.
        r_row = q.conj() @ V
        V.addr_(q, r_row, alpha=-1)
        # Freeze the pivoted column at zero to avoid re-selection.
        V[:, j] = 0
        Q[:, k] = q
        # R in original column order as q^H S (identical for the active
        # columns; makes cross-checking with rb_greedy trivial).
        R[k] = q.conj() @ S
        pivots.append(j)
        r_diag.append(rkk_f)
    del V
    k = len(pivots)
    return MGSResult(
        Q=Q[:, :k].contiguous(),
        R=R[:k],
        pivots=torch.tensor(pivots, dtype=torch.int32, device=S.device),
        r_diag=torch.tensor(r_diag, dtype=torch.float64, device=S.device),
        k=k,
    )
