"""Frequency-band workload splitting for batched many-basis builds.

PyTorch port of :mod:`repro.data.bands`: FFT the sample axis of one
snapshot matrix, slice the spectrum into B contiguous bands, and reduce
each band with its own basis.  A narrow band's family is far smoother than
the broadband signal, so per-band bases are much smaller than one global
basis at equal tau, and the B band matrices share one (N_b, M) shape: the
stacked workload ``strategy="batched"`` builds in one lockstep pass
(:mod:`repro_torch.core.batch_greedy`).  The per-band artifacts register
with the serving router, one route a band (``examples/
torch_banded_bases.py``).  The transform is ``torch.fft`` on the source's
device (the reference's ``jnp.fft`` is no Pallas kernel either).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class BandSplit(NamedTuple):
    """A banded snapshot workload (the output of :func:`band_split`).

    Attributes:
      stack: (B, N_b, M) complex tensor, band b's spectrum rows for every
        snapshot column; feed it to ``build_basis(source=split,
        strategy="batched")`` (or any (B, N, M)-accepting driver).
      edges: tuple of (lo, hi) frequency-bin index pairs, one a band: band
        b covers spectrum rows ``lo <= r < hi`` of the full FFT.
      n_freq: number of frequency bins the FFT produced (before the
        truncation to equal band heights).
      from_real: True when the input was real (one-sided rFFT spectrum).
    """

    stack: torch.Tensor
    edges: tuple
    n_freq: int
    from_real: bool

    @property
    def batch(self) -> int:
        return int(self.stack.shape[0])


def band_split(source: Any, bands: int, device=None) -> BandSplit:
    """FFT the sample axis and split the spectrum into ``bands`` equal bands.

    Args:
      source: the snapshot matrix, anything
        :func:`repro_torch.data.providers.materialize_source` accepts,
        shaped (N, M) with snapshots in columns; placed on ``device``
        (``cuda`` unless ``device="cpu"``).  Real input takes the one-sided
        rFFT (N // 2 + 1 bins), complex input the full FFT (N bins).
      bands: number of equal-height bands B (>= 1).  The topmost
        ``n_freq % bands`` bins are dropped so that every band has the same
        height (the lockstep driver needs one (N_b, M) shape).

    Returns a :class:`BandSplit`; ``.stack`` is (B, n_freq // B, M), a view
    of the transform.
    """
    from repro_torch.data.providers import materialize_source

    if bands < 1:
        raise ValueError(f"bands must be >= 1, got {bands}")
    if getattr(source, "ndim", 2) != 2:
        raise ValueError(
            f"band_split needs a 2-D (N, M) source, got "
            f"{tuple(source.shape)}")
    S = materialize_source(source, device)
    from_real = not S.is_complex()
    F = torch.fft.rfft(S, dim=0) if from_real else torch.fft.fft(S, dim=0)
    n_freq = int(F.shape[0])
    height = n_freq // bands
    if height < 1:
        raise ValueError(
            f"{bands} bands from {n_freq} frequency bins leaves empty bands")
    edges = tuple((b * height, (b + 1) * height) for b in range(bands))
    stack = F[: bands * height].reshape(bands, height, F.shape[1])
    return BandSplit(stack=stack, edges=edges, n_freq=n_freq,
                     from_real=from_real)
