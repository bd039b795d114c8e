"""Empirical interpolation (EIM/DEIM) and reduced-order quadrature (ROQ).

PyTorch port of :mod:`repro.core.eim`:

- :func:`eim_nodes` — greedy node selection (DEIM): node i maximizes the
  magnitude of the i-th basis vector's interpolation residual.
- :func:`empirical_interpolant` — evaluates I_k[f] = B @ f[nodes] with
  B = Q (Q[nodes, :])^{-1}.
- :func:`roq_weights` — reduced-order quadrature weights: for an inner
  product <d, h> = sum_x w_x conj(d_x) h_x, omega such that
  <d, h> ~= sum_j omega_j h(node_j)  (the paper's GW application).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EIMResult(NamedTuple):
    nodes: torch.Tensor  # (k,) int64 interpolation rows ("empirical nodes")
    B: torch.Tensor      # (N, k) interpolant matrix: I[f] = B @ f[nodes]


def eim_nodes(Q: torch.Tensor) -> EIMResult:
    """Greedy EIM node selection for the basis columns of Q (N, k).

    Iteration i solves for the interpolation coefficients of basis vector
    i on the i nodes chosen so far and takes the row where its residual is
    largest.  The node indices stay on the device (no host sync per
    iteration).
    """
    N, k = Q.shape
    nodes = torch.zeros((k,), dtype=torch.int64, device=Q.device)
    nodes[0] = torch.argmax(Q[:, 0].abs())
    for i in range(1, k):
        qi = Q[:, i]
        sel = nodes[:i]
        c = torch.linalg.solve_ex(Q[sel, :i], qi[sel])[0]
        r = qi - Q[:, :i] @ c
        nodes[i] = torch.argmax(r.abs())
    B = Q @ torch.linalg.inv_ex(Q[nodes, :])[0]
    return EIMResult(nodes=nodes, B=B)


def empirical_interpolant(B: torch.Tensor, nodes: torch.Tensor,
                          f: torch.Tensor) -> torch.Tensor:
    """Evaluate the empirical interpolant of f (vector or batch of columns)."""
    return B @ f[nodes]


def roq_weights(data: torch.Tensor, quad_w: torch.Tensor,
                B: torch.Tensor) -> torch.Tensor:
    """Reduced-order quadrature weights for <data, .>:
    omega = B^T (w * conj(d))."""
    return B.mT @ (quad_w.to(B.dtype) * data.conj())
