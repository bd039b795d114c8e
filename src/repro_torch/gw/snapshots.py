"""Snapshot-matrix construction (the greedycpp model interface).

greedycpp forms S from the model over a parameter grid.  Here a
:class:`WaveformGrid` holds the grid's factored TaylorF2 terms on a device
and generates any column range of S through one entry point,
:meth:`WaveformGrid.tile`: the ``taylorf2_tile`` kernel on the card, its
plain version on the CPU.  :func:`build_snapshot_matrix` (the resident S)
and :class:`repro_torch.data.providers.WaveformProvider` (the streamed
tiles) both call it, so a column has the same bits in S, in every tile and
alone.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.gw.waveform import taylorf2_terms


class WaveformGrid:
    """TaylorF2 columns over ``(f, m1s, m2s)`` (Hz, Msun), generated on
    ``device`` (``cuda`` unless asked) as ``dtype`` (complex64 or
    complex128), unit-normalized unless ``normalize=False``.

    Holds only the terms: (4, N) and (8, M) float64, 32 M + 32 N bytes.
    """

    def __init__(self, f, m1s, m2s, dtype: torch.dtype = torch.complex64,
                 normalize: bool = True, device=None):
        self.device = resolve_device(device)
        m1 = np.asarray(m1s, np.float64)
        m2 = np.asarray(m2s, np.float64)
        if m1.shape != m2.shape or m1.ndim != 1:
            raise ValueError("m1s/m2s must be equal-length 1-D arrays")
        self.rows, self.cols = taylorf2_terms(
            torch.as_tensor(np.asarray(f, np.float64), device=self.device),
            torch.as_tensor(m1, device=self.device),
            torch.as_tensor(m2, device=self.device))
        self.dtype = dtype
        self.normalize = normalize

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows.shape[1], self.cols.shape[1])

    def tile(self, lo: int, hi: int, out: torch.Tensor | None = None
             ) -> torch.Tensor:
        """Columns ``[lo, hi)`` as an (N, hi - lo) tensor, written into
        ``out`` (which may be a column slice of a row-major matrix) when
        given."""
        from repro_torch.kernels.taylorf2.ops import taylorf2_tile

        return taylorf2_tile(self.rows, self.cols, lo, hi, self.normalize,
                             self.dtype, out)


def build_snapshot_matrix(f, m1s, m2s, dtype: torch.dtype = torch.complex64,
                          chunk: int = 4096, device=None,
                          normalize: bool = True) -> torch.Tensor:
    """Build S (N, M) on ``device`` (``cuda`` unless asked): ``chunk``
    columns at a time generated straight into one preallocated row-major
    tensor (no N x M float64 temporary)."""
    grid = WaveformGrid(f, m1s, m2s, dtype, normalize, device)
    N, M = grid.shape
    S = torch.empty((N, M), dtype=dtype, device=grid.device)
    for lo in range(0, M, chunk):
        hi = min(lo + chunk, M)
        grid.tile(lo, hi, out=S[:, lo:hi])
    return S
