"""Snapshot providers: column-tile access to an (N, M) snapshot matrix.

PyTorch port of the resident part of :mod:`repro.data.providers`.  A
:class:`SnapshotProvider` hands out column tiles ``S[:, lo:hi]`` as tensors
on its device; the resident drivers materialize the whole matrix through
:func:`materialize_source`.

- :class:`ArrayProvider`   — a resident numpy array or torch tensor.
- :class:`MemmapProvider`  — a memory-mapped ``.npy`` file; a tile reads
  only its own columns.

Every tensor a provider returns is C-contiguous (row-major), the layout the
CUDA kernels read.
"""

from __future__ import annotations

import abc
import os
import time

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype


def _read_with_retry(fn, what: str):
    """Run an I/O-backed read with bounded retry + exponential backoff.

    Retries ``REPRO_IO_RETRIES`` times (default 3) with backoff
    ``REPRO_IO_RETRY_BASE_S * 2**attempt`` (default base 0.05 s); the last
    failure re-raises with ``what`` and the attempt count in the message.
    """
    retries = int(os.environ.get("REPRO_IO_RETRIES", "3"))
    base = float(os.environ.get("REPRO_IO_RETRY_BASE_S", "0.05"))
    for attempt in range(retries + 1):
        try:
            return fn()
        except (IOError, OSError) as e:
            if attempt >= retries:
                raise IOError(
                    f"{what} failed after {retries + 1} attempts: {e}"
                ) from e
            time.sleep(base * (2.0 ** attempt))


def to_device(a, device: torch.device) -> torch.Tensor:
    """A contiguous tensor on ``device`` from a tensor or array-like; a
    read-only array (a memmap, a JAX array's view) is copied first, since
    a tensor must own writable memory."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        a = torch.from_numpy(a)
    return a.to(device).contiguous()


class SnapshotProvider(abc.ABC):
    """Column-tile access to an (N, M) snapshot matrix.

    Implementations supply :attr:`shape`, :attr:`dtype` (a torch dtype),
    :attr:`device` and :meth:`tile`.
    """

    @property
    @abc.abstractmethod
    def shape(self) -> tuple[int, int]:
        """(N, M): rows (physical dimension) x columns (parameter values)."""

    @property
    @abc.abstractmethod
    def dtype(self) -> torch.dtype:
        """Element dtype of the snapshot matrix."""

    @property
    @abc.abstractmethod
    def device(self) -> torch.device:
        """Device the tiles are placed on."""

    @abc.abstractmethod
    def tile(self, lo: int, hi: int) -> torch.Tensor:
        """Return columns [lo, hi) as a contiguous (N, hi - lo) tensor."""

    def materialize(self) -> torch.Tensor:
        """The full matrix as ONE tile."""
        return self.tile(0, self.shape[1])


class ArrayProvider(SnapshotProvider):
    """A resident (N, M) numpy array or torch tensor behind the provider
    interface; tiles are copied to ``device`` (``cuda`` unless asked)."""

    def __init__(self, S, device=None):
        self._S = S if isinstance(S, (torch.Tensor, np.ndarray)) \
            else np.asarray(S)
        if self._S.ndim != 2:
            raise ValueError(f"expected a 2-D snapshot matrix, got shape "
                             f"{tuple(self._S.shape)}")
        self._device = resolve_device(device)

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self._S.shape)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self._S.dtype)

    @property
    def device(self) -> torch.device:
        return self._device

    def tile(self, lo: int, hi: int) -> torch.Tensor:
        return to_device(self._S[:, lo:hi], self._device)


class MemmapProvider(SnapshotProvider):
    """A memory-mapped ``.npy`` snapshot matrix on disk.

    Only the requested columns of a tile are read (and copied to the
    device).  Column-major files (``fortran_order=True``) give contiguous
    tile reads; row-major files work with strided reads.
    """

    def __init__(self, path: str | os.PathLike, device=None):
        self.path = os.fspath(path)
        self._mm = _read_with_retry(
            lambda: np.load(self.path, mmap_mode="r"),
            f"open {self.path}")
        if self._mm.ndim != 2:
            raise ValueError(
                f"{self.path}: expected a 2-D snapshot matrix, got shape "
                f"{self._mm.shape}")
        self._device = resolve_device(device)

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self._mm.shape)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self._mm.dtype)

    @property
    def device(self) -> torch.device:
        return self._device

    def tile(self, lo: int, hi: int) -> torch.Tensor:
        return to_device(_read_with_retry(
            lambda: np.array(self._mm[:, lo:hi]),
            f"read {self.path}[:, {lo}:{hi}]"), self._device)


def as_provider(source, device=None) -> SnapshotProvider:
    """Coerce an array / tensor / ``.npy`` path / provider into a provider
    (an existing provider is returned as it is)."""
    if isinstance(source, SnapshotProvider):
        return source
    if isinstance(source, (str, os.PathLike)):
        return MemmapProvider(source, device)
    return ArrayProvider(source, device)


def materialize_source(source, device=None) -> torch.Tensor:
    """Coerce anything :func:`as_provider` accepts into a resident,
    row-major tensor on ``device`` (``cuda`` unless asked otherwise).

    A contiguous tensor already on that device passes through uncopied.
    """
    dev = resolve_device(device)
    if isinstance(source, (torch.Tensor, np.ndarray)):
        if source.ndim != 2:
            raise ValueError(
                f"expected a 2-D snapshot matrix, got shape "
                f"{tuple(source.shape)}")
        return to_device(source, dev)
    prov = as_provider(source, dev)
    if prov.device != dev:
        raise ValueError(f"provider places tiles on {prov.device}, "
                         f"requested {dev}")
    return prov.materialize()
