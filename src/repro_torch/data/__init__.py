"""Snapshot sources for the port's drivers, the banded workload, and the
step-keyed token pipelines of the trainer."""

from repro_torch.data.bands import BandSplit, band_split
from repro_torch.data.pipeline import FileLMData, SyntheticLMData
from repro_torch.data.providers import (
    ArrayProvider,
    FaultPlan,
    FaultyProvider,
    MemmapProvider,
    SnapshotProvider,
    WaveformProvider,
    as_provider,
    create_snapshot_npy,
    materialize_source,
    write_snapshot_npy,
)

__all__ = [
    "SnapshotProvider", "ArrayProvider", "MemmapProvider",
    "WaveformProvider", "FaultPlan", "FaultyProvider", "as_provider",
    "materialize_source", "write_snapshot_npy", "create_snapshot_npy",
    "BandSplit", "band_split", "SyntheticLMData", "FileLMData",
]
