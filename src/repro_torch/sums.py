"""Column sums in an order fixed by the row count.

A column's result here depends on that column alone: not on the width of
the matrix, the column's position in it, the device's reduction kernels or
its vector units.  The sums fold rows by halving, ``X[:h] + X[h:2h]`` (an
odd last row carried to the next level), a fixed binary tree of
elementwise additions; ``|x|^2`` is formed from real parts, each
multiply and add its own elementwise operation (a complex multiply on the
CPU rounds differently in its vector body and its scalar tail).

The streamed greedy build relies on it: its tiles and the resident S must
give each column the same norms, or the two builds part at the first
near-tie.  The greedy drivers, MGS, the randomized range-finder and the
refresh sum their column norms through :func:`column_norms_sq`: on a CUDA
tensor that is the ``column_norms`` kernel (``csrc/column_norms.cu``, the
same tree in one read of X, the same bits), on a CPU tensor the tree
below.  The CUDA sweep kernels give each column a fixed-order sum by
design.
"""

from __future__ import annotations

import torch


def column_sums(X: torch.Tensor) -> torch.Tensor:
    """Column sums of a 2-D tensor by halving over its rows."""
    while X.shape[0] > 1:
        h = X.shape[0] // 2
        top = X[:h] + X[h:2 * h]
        X = torch.cat([top, X[2 * h:]]) if X.shape[0] % 2 else top
    return X[0] if X.shape[0] else X.new_zeros(X.shape[1:])


def column_norms_sq(X: torch.Tensor) -> torch.Tensor:
    """``sum_n |X[n, i]|^2`` per column, in the working precision;
    ``|x|^2`` is ``re*re + im*im``.  A CUDA tensor goes to the
    ``column_norms`` kernel, a CPU tensor to :func:`column_sums`."""
    from repro_torch.kernels.column_norms.ops import column_norms_sq as norms

    return norms(X)
