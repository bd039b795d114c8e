"""Snapshot-matrix construction (the greedycpp model interface).

greedycpp forms S from the model over a parameter grid.  Here S is
generated on the device in column chunks, so no N x M float64 temporary
exists: at the full width (10,000 x 131,072) four of them would be 40 GB.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.gw.waveform import taylorf2_batch


def build_snapshot_matrix(f, m1s, m2s, dtype: torch.dtype = torch.complex64,
                          chunk: int = 4096, device=None) -> torch.Tensor:
    """Build S (N, M) on ``device`` (``cuda`` unless asked), ``chunk``
    columns at a time into one preallocated row-major tensor."""
    dev = resolve_device(device)
    f = torch.as_tensor(np.asarray(f, np.float64), device=dev)
    m1s = torch.as_tensor(np.asarray(m1s, np.float64), device=dev)
    m2s = torch.as_tensor(np.asarray(m2s, np.float64), device=dev)
    M = m1s.shape[0]
    S = torch.empty((f.shape[0], M), dtype=dtype, device=dev)
    for lo in range(0, M, chunk):
        hi = min(lo + chunk, M)
        S[:, lo:hi] = taylorf2_batch(f, m1s[lo:hi], m2s[lo:hi], dtype=dtype)
    return S
