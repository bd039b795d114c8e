"""Plain PyTorch version of the TaylorF2 tile generator."""

from __future__ import annotations

import torch


def taylorf2_tile_ref(rows: torch.Tensor, cols: torch.Tensor,
                      normalize: bool = True,
                      dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """The (N, w) waveform tile of the row terms ``rows`` (4, N) and the
    column terms ``cols`` (8, w) of
    :func:`repro_torch.gw.waveform.taylorf2_terms`: what
    :func:`repro_torch.gw.waveform.taylorf2_batch` computes for those mass
    pairs, operation for operation.  A column's bits depend on its own
    terms only (elementwise operations and a fixed-order norm), not on the
    tile it is generated in."""
    from repro_torch.gw.waveform import taylorf2_from_terms

    return taylorf2_from_terms(rows, cols, normalize, dtype)
