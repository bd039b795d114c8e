"""GW snapshot generation (TaylorF2 over parameter grids), in PyTorch."""

from repro_torch.gw.grids import (
    chirp_grid, frequency_grid, mass_grid, random_mass_samples,
)
from repro_torch.gw.snapshots import WaveformGrid, build_snapshot_matrix
from repro_torch.gw.waveform import taylorf2, taylorf2_batch

__all__ = [
    "frequency_grid", "mass_grid", "chirp_grid", "random_mass_samples",
    "build_snapshot_matrix", "WaveformGrid", "taylorf2", "taylorf2_batch",
]
