"""Plain PyTorch version of the column-norm kernel: the halving tree of
:mod:`repro_torch.sums`, one elementwise torch op a level."""

from __future__ import annotations

import torch

from repro_torch.sums import column_sums


def column_norms_sq_ref(X: torch.Tensor) -> torch.Tensor:
    """``sum_n |X[n, i]|^2`` per column, in the working precision, summed
    by :func:`repro_torch.sums.column_sums`; ``|x|^2`` is ``re*re +
    im*im``, each multiply and add its own elementwise operation."""
    if X.is_complex():
        re, im = X.real, X.imag
        return column_sums(re * re + im * im)
    return column_sums(X * X)
