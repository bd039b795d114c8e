"""Snapshot providers: column-tile access to an (N, M) snapshot matrix.

PyTorch port of :mod:`repro.data.providers`.  A :class:`SnapshotProvider`
hands out column tiles ``S[:, lo:hi]`` as tensors on its device, so the
streamed driver (:func:`repro_torch.core.streaming.rb_greedy_streamed`)
holds O(N * tile_m) of S on the device whatever M is; the resident drivers
materialize the whole matrix through :func:`materialize_source`.

- :class:`ArrayProvider`    — a resident numpy array or torch tensor.  A
  host matrix stays on the host: each tile is copied to the card through a
  pinned buffer on a side stream (:class:`_HostStager`), so the next
  tile's copy overlaps the current tile's sweep.
- :class:`MemmapProvider`   — a memory-mapped ``.npy`` file; a tile reads
  only its own columns (into the same pinned buffers on the card).
- :class:`WaveformProvider` — GW snapshot columns generated on the device
  (:class:`repro_torch.gw.snapshots.WaveformGrid`: the ``taylorf2_tile``
  kernel on the card), so S never exists anywhere.
- :class:`FaultyProvider`   — wraps any provider and injures it on a
  :class:`FaultPlan`'s schedule; :func:`as_provider` applies one armed by
  the ``REPRO_FAULT_*`` environment variables.

Every tensor a provider returns is C-contiguous (row-major), the layout the
CUDA kernels read.
"""

from __future__ import annotations

import abc
import os
import time
from dataclasses import dataclass
from typing import Iterator, Optional

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


class _HostStager:
    """Copies host tiles to the card through two pinned buffers on a side
    stream.

    :meth:`put` fills the next pinned buffer on the host (waiting only for
    that buffer's previous copy), issues its copy on the side stream, and
    makes the current stream wait for it: the caller's kernels already
    queued on the current stream keep running while the host reads and the
    copy runs.  ``bytes`` counts what was copied.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers = [None, None]
        self.copied = [None, None]
        self.turn = 0
        self.bytes = 0

    def put(self, shape: tuple[int, int], dtype: torch.dtype, fill
            ) -> torch.Tensor:
        """A device tensor of ``shape`` holding what ``fill(buf)`` writes
        into the pinned host tensor ``buf`` of that shape."""
        b, self.turn = self.turn, self.turn ^ 1
        if self.copied[b] is not None:
            self.copied[b].synchronize()
        n = shape[0] * shape[1]
        buf = self.buffers[b]
        if buf is None or buf.numel() < n or buf.dtype != dtype:
            buf = self.buffers[b] = torch.empty(n, dtype=dtype,
                                                pin_memory=True)
        host = buf[:n].view(shape)
        fill(host)
        current = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            out = torch.empty(shape, dtype=dtype, device=self.device)
            out.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.copied[b] = done
        current.wait_event(done)
        out.record_stream(current)
        self.bytes += host.nbytes
        return out


class SnapshotProvider(abc.ABC):
    """Column-tile access to an (N, M) snapshot matrix.

    Implementations supply :attr:`shape`, :attr:`dtype` (a torch dtype),
    :attr:`device` and :meth:`tile`; the rest is defined in terms of
    those.  A tile request costs O(N * (hi - lo)) memory, never O(N * M).
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

    def column(self, j: int) -> torch.Tensor:
        """One snapshot column (N,).  Default: a width-1 tile."""
        return self.tile(j, j + 1)[:, 0]

    def tiles(self, tile_m: int) -> Iterator[tuple[int, int]]:
        """Tile boundaries [lo, hi) covering all M columns in order."""
        M = self.shape[1]
        for lo in range(0, M, tile_m):
            yield lo, min(lo + tile_m, M)

    def materialize(self) -> torch.Tensor:
        """The full matrix as ONE tile."""
        return self.tile(0, self.shape[1])


class ArrayProvider(SnapshotProvider):
    """A resident (N, M) numpy array or torch tensor behind the provider
    interface; tiles are placed on ``device`` (``cuda`` unless asked).

    A host matrix (numpy, or a CPU tensor, pinned or not) stays on the
    host, and a tile for the card goes through :class:`_HostStager`;
    :attr:`bytes_to_device` counts those copies.  A matrix already on the
    device gives copies of its column slices.
    """

    def __init__(self, S, device=None):
        self._S = S if isinstance(S, (torch.Tensor, np.ndarray)) \
            else np.asarray(S)
        if self._S.ndim != 2:
            raise ValueError(f"expected a 2-D snapshot matrix, got shape "
                             f"{tuple(self._S.shape)}")
        self._device = resolve_device(device)
        on_host = not isinstance(self._S, torch.Tensor) \
            or self._S.device.type == "cpu"
        self._stager = _HostStager(self._device) \
            if on_host and self._device.type == "cuda" else None

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self._S.shape)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self._S.dtype)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def bytes_to_device(self) -> int:
        return 0 if self._stager is None else self._stager.bytes

    def tile(self, lo: int, hi: int) -> torch.Tensor:
        if self._stager is None:
            return to_device(self._S[:, lo:hi], self._device)
        src = self._S[:, lo:hi]
        if isinstance(src, np.ndarray):
            src = torch.from_numpy(src)
        return self._stager.put((self.shape[0], hi - lo), self.dtype,
                                lambda buf: buf.copy_(src))


class MemmapProvider(SnapshotProvider):
    """A memory-mapped ``.npy`` snapshot matrix on disk.

    Only the requested columns of a tile are read (and copied to the
    device, through pinned buffers on a side stream on the card).
    Column-major files (``fortran_order=True``, what
    :func:`write_snapshot_npy` writes by default) give contiguous tile
    reads; row-major files work with strided reads.  The page-in runs
    under the bounded-retry wrapper.
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
        self._stager = _HostStager(self._device) \
            if self._device.type == "cuda" else None

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
        what = f"read {self.path}[:, {lo}:{hi}]"
        if self._stager is None:
            return to_device(_read_with_retry(
                lambda: np.array(self._mm[:, lo:hi]), what), self._device)
        return self._stager.put(
            (self.shape[0], hi - lo), self.dtype,
            lambda buf: _read_with_retry(
                lambda: np.copyto(buf.numpy(), self._mm[:, lo:hi]), what))


class WaveformProvider(SnapshotProvider):
    """On-the-fly GW snapshot tiles: columns are TaylorF2 waveforms.

    Holds a :class:`repro_torch.gw.snapshots.WaveformGrid` over ``(f, m1s,
    m2s)`` on ``device`` (``cuda`` unless asked); ``tile(lo, hi)``
    generates the waveforms of parameters [lo, hi) there — the
    ``taylorf2_tile`` kernel on the card, its plain version on the CPU —
    so the snapshot matrix is never materialized on the host or the
    device.  A column has the same bits in every tile, alone
    (:meth:`column`) and in :func:`repro_torch.gw.build_snapshot_matrix`'s
    S of the same grid.
    """

    def __init__(self, f, m1s, m2s, dtype=torch.complex64,
                 normalize: bool = True, device=None):
        from repro_torch.gw.snapshots import WaveformGrid

        self.grid = WaveformGrid(f, m1s, m2s, torch_dtype(dtype), normalize,
                                 device)

    @property
    def shape(self) -> tuple[int, int]:
        return self.grid.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.grid.dtype

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def tile(self, lo: int, hi: int) -> torch.Tensor:
        return self.grid.tile(lo, hi)


@dataclass(frozen=True)
class FaultPlan:
    """What to break, and when — the fault-injection schedule.

    Counted in provider *tile reads* (0-based), the unit of forward
    progress in a streamed build:

    - ``kill_at_tile``:    ``os._exit`` the process on that read — the
      stand-in for OOM-kills / preemption at an arbitrary point.
    - ``raise_at_tile``:   raise a hard ``IOError`` on that read (survives
      retry; the build dies with a diagnosable error).
    - ``transient_every``: every n-th read raises ``IOError`` once, then
      succeeds — exercises the bounded-retry path, the build completes.

    ``from_env`` builds the plan from ``REPRO_FAULT_KILL_AT_TILE``,
    ``REPRO_FAULT_RAISE_AT_TILE``, ``REPRO_FAULT_TRANSIENT_EVERY`` (and
    ``REPRO_FAULT_EXIT_CODE``), so a supervised subprocess can be injured
    without code changes.  One-shot faults honor ``REPRO_FAULT_ONCE`` (see
    :mod:`repro_torch.checkpoint.io`): after a restart the same kill does
    not fire again.
    """

    kill_at_tile: Optional[int] = None
    raise_at_tile: Optional[int] = None
    transient_every: Optional[int] = None
    exit_code: int = 42

    @classmethod
    def from_env(cls) -> "FaultPlan":
        def geti(name):
            v = os.environ.get(name)
            return int(v) if v else None

        return cls(
            kill_at_tile=geti("REPRO_FAULT_KILL_AT_TILE"),
            raise_at_tile=geti("REPRO_FAULT_RAISE_AT_TILE"),
            transient_every=geti("REPRO_FAULT_TRANSIENT_EVERY"),
            exit_code=geti("REPRO_FAULT_EXIT_CODE") or 42,
        )

    def active(self) -> bool:
        return any(v is not None for v in
                   (self.kill_at_tile, self.raise_at_tile,
                    self.transient_every))


class FaultyProvider(SnapshotProvider):
    """Fault-injecting wrapper around any :class:`SnapshotProvider`.

    Transparent (shape, dtype, device, tiles delegate) until the
    :class:`FaultPlan` says otherwise.  Counts tile reads across its
    lifetime in ``reads`` (a column read is a tile read); the count is
    per process, so a resumed run's counter restarts at 0 — pair one-shot
    faults with ``REPRO_FAULT_ONCE`` to keep the relaunch unharmed.
    """

    def __init__(self, inner: SnapshotProvider,
                 plan: Optional[FaultPlan] = None):
        self.inner = inner
        self.plan = plan if plan is not None else FaultPlan.from_env()
        self.reads = 0

    @property
    def shape(self) -> tuple[int, int]:
        return self.inner.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def tile(self, lo: int, hi: int) -> torch.Tensor:
        from repro_torch.checkpoint.io import _fault_once

        plan, n = self.plan, self.reads
        self.reads += 1
        if (plan.kill_at_tile is not None and n >= plan.kill_at_tile
                and _fault_once("kill_at_tile")):
            os._exit(plan.exit_code)
        if (plan.raise_at_tile is not None and n >= plan.raise_at_tile
                and _fault_once("raise_at_tile")):
            raise IOError(
                f"injected hard I/O fault at tile read {n} "
                f"(columns [{lo}:{hi}))")
        first = [True]

        def attempt():
            if (plan.transient_every and (n + 1) % plan.transient_every == 0
                    and first[0]):
                first[0] = False
                raise IOError(
                    f"injected transient I/O fault at tile read {n}")
            return self.inner.tile(lo, hi)

        return _read_with_retry(attempt, f"tile [{lo}:{hi})")


def write_snapshot_npy(path: str | os.PathLike, S,
                       fortran_order: bool = True) -> str:
    """Write a snapshot matrix (array or tensor) as ``.npy`` for
    :class:`MemmapProvider`; returns the file name written.

    ``fortran_order=True`` stores columns contiguously, so a streamed
    column tile is one sequential read instead of N strided ones.
    """
    path = os.fspath(path)
    if not path.endswith(".npy"):
        path += ".npy"  # np.save appends it; return the real file name
    arr = S.detach().cpu().numpy() if isinstance(S, torch.Tensor) \
        else np.asarray(S)
    np.save(path, np.asfortranarray(arr) if fortran_order
            else np.ascontiguousarray(arr))
    return path


def create_snapshot_npy(path: str | os.PathLike, shape: tuple[int, int],
                        dtype, fortran_order: bool = True) -> np.memmap:
    """Create an empty on-disk ``.npy`` to be filled tile by tile.

    Returns a writable memmap; fill ``mm[:, lo:hi]`` per tile (and
    ``mm.flush()`` when done) to build matrices larger than host memory.
    """
    from repro_torch.device import numpy_dtype

    dt = numpy_dtype(dtype) if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype)
    return np.lib.format.open_memmap(
        os.fspath(path), mode="w+", dtype=dt, shape=tuple(shape),
        fortran_order=fortran_order)


def as_provider(source, device=None) -> SnapshotProvider:
    """Coerce an array / tensor / ``.npy`` path / provider into a provider
    (an existing provider is returned as it is).

    When ``REPRO_FAULT_*`` environment variables arm a :class:`FaultPlan`,
    the provider comes back wrapped in a :class:`FaultyProvider` — the hook
    a fault-injection harness uses to injure a supervised subprocess from
    the outside.  A wrapped provider is never wrapped twice.
    """
    if isinstance(source, SnapshotProvider):
        prov = source
    elif isinstance(source, (str, os.PathLike)):
        prov = MemmapProvider(source, device)
    else:
        prov = ArrayProvider(source, device)
    if not isinstance(prov, FaultyProvider):
        plan = FaultPlan.from_env()
        if plan.active():
            prov = FaultyProvider(prov, plan)
    return prov


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
