"""Multi-basis routing: request key -> loaded ``ReducedBasis`` + EIM.

Port of :mod:`repro.serving.router`.  The router loads each artifact onto
its ``device`` (``cuda`` unless asked) and measures a basis's working set
from the tensors' sizes, without reading them back.

A production ROQ service holds MANY bases — e.g. one per parameter region
of the GW space, each cheap to build with the randomized sketch — but the
device cannot hold all of them at once.  :class:`BasisRouter` owns that
working set:

- ``register(basis_id, source)`` declares a basis by artifact directory
  (lazily loaded, evictable) or as an in-memory ``ReducedBasis`` (pinned:
  with no directory to reload from, evicting it would lose it).
- ``get(basis_id)`` returns the loaded ``(basis, eim)`` pair, loading on
  first use and counting the persisted-vs-recomputed EIM path.
- Loaded bases form an LRU under a device-memory budget following the
  ``REPRO_DEVICE_MEM_BUDGET`` convention (default:
  :func:`repro_torch.api.build.device_memory_budget`); crossing it evicts
  least-recently-used directory-backed bases, firing ``on_evict`` so the
  engine can drop their warm interpolant-cache entries too.  A later
  ``get`` reloads from the artifact directory — bit-identical arrays, by
  the artifact round-trip guarantee.
- ``refresh(basis_id)`` hot-swaps a refreshed on-disk artifact (e.g. an
  ``enrich()``-ed basis, or a per-region rebuild) into live traffic: the
  candidate's NEWEST artifact step is CRC-verified first, then the
  routed entry is replaced under the lock with a bumped **generation**
  counter and ``on_refresh(basis_id, old_gen, new_gen)`` fires so the
  engine retires the old generation's warm interpolant-cache entries.
  In-flight batches that already resolved the old entry finish on the
  old generation (their arrays are immutable); a corrupt candidate
  raises and leaves the live basis untouched.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from typing import Callable, NamedTuple, Optional

from repro_torch.device import resolve_device

logger = logging.getLogger("repro_torch.serving")


class _Entry(NamedTuple):
    basis: object          # ReducedBasis
    eim: object            # EIMResult (nodes, B)
    nbytes: int            # device working-set estimate
    evictable: bool        # directory-backed (reloadable) vs pinned
    generation: int = 0    # bumped by refresh(); keys warm-cache entries


def _entry_bytes(basis, eim) -> int:
    """Device working set of one routed basis: Q + interpolant B + nodes
    (sizes only: nothing is read back from the card)."""
    return sum(t.numel() * t.element_size()
               for t in (basis.Q, eim.B, eim.nodes))


class BasisRouter:
    """The routed working set of bases (see the module docstring).

    ``device``: where directory-backed artifacts are loaded (``cuda``
    unless ``device="cpu"``); an in-memory basis stays where it is.
    """

    def __init__(self, memory_budget_bytes: Optional[int] = None,
                 on_evict: Optional[Callable[[str], None]] = None,
                 on_refresh: Optional[Callable[[str, int, int], None]] = None,
                 metrics=None, device=None):
        self.device = resolve_device(device)
        if memory_budget_bytes is None:
            from repro_torch.api.build import device_memory_budget

            memory_budget_bytes = device_memory_budget(self.device)
        self.memory_budget_bytes = int(memory_budget_bytes)
        self._on_evict = on_evict
        self._on_refresh = on_refresh
        self._metrics = metrics
        self._sources: dict[str, object] = {}   # id -> dir | ReducedBasis
        self._live: collections.OrderedDict[str, _Entry] = \
            collections.OrderedDict()           # LRU: oldest first
        self._generations: dict[str, int] = {}  # survives eviction
        self._lock = threading.RLock()

    # ---------------------------------------------------------- registry ----
    def register(self, basis_id: str, source) -> None:
        """Declare ``basis_id`` -> artifact directory or ReducedBasis.

        Directories stay on disk until routed to; an in-memory basis with
        a backing :attr:`~repro_torch.api.ReducedBasis.directory` is registered
        by that directory (evictable), one without is pinned.
        """
        from repro_torch.api import ReducedBasis

        with self._lock:
            if basis_id in self._sources:
                raise ValueError(f"basis_id {basis_id!r} already registered")
            if isinstance(source, (str, os.PathLike)):
                self._sources[basis_id] = os.fspath(source)
            elif isinstance(source, ReducedBasis):
                if source.directory is not None:
                    self._sources[basis_id] = source.directory
                else:
                    self._sources[basis_id] = source  # pinned
            else:
                raise TypeError(
                    f"register() wants an artifact directory or a "
                    f"ReducedBasis, got {type(source).__name__}")

    def ids(self) -> list[str]:
        with self._lock:
            return list(self._sources)

    def loaded_ids(self) -> list[str]:
        """Currently-resident ids, least recently used first."""
        with self._lock:
            return list(self._live)

    def __contains__(self, basis_id: str) -> bool:
        with self._lock:
            return basis_id in self._sources

    # ------------------------------------------------------------ lookup ----
    def get(self, basis_id: str):
        """Resident ``(basis, eim)`` for ``basis_id`` (loads, LRU-bumps,
        and evicts colder bases as needed).  KeyError on unknown ids —
        the engine turns that into a per-request failure."""
        entry = self.get_entry(basis_id)
        return entry.basis, entry.eim

    def get_entry(self, basis_id: str) -> _Entry:
        """Like :meth:`get` but returns the full routed entry, including
        the reload ``generation`` the engine keys warm-cache entries on."""
        with self._lock:
            if basis_id not in self._sources:
                raise KeyError(f"unknown basis_id {basis_id!r}; "
                               f"registered: {sorted(self._sources)}")
            entry = self._live.get(basis_id)
            if entry is None:
                entry = self._load(basis_id)
                self._live[basis_id] = entry
                self._shrink_to_budget(keep=basis_id)
            else:
                self._live.move_to_end(basis_id)
            return entry

    @staticmethod
    def _maybe_inject_load_fault(basis_id: str) -> None:
        """Chaos hook, on the checkpoint fault conventions:
        ``REPRO_FAULT_SERVE_RAISE_AT_LOAD=<basis_id|any>`` makes the
        router's artifact load fail (at most once under
        ``REPRO_FAULT_ONCE``) — the consecutive-batch-failure signal the
        per-basis circuit breaker trips on."""
        at = os.environ.get("REPRO_FAULT_SERVE_RAISE_AT_LOAD")
        if not at or at not in ("any", basis_id):
            return
        from repro_torch.checkpoint.io import _fault_once

        if _fault_once(f"serve_raise_at_load.{basis_id}"):
            raise IOError(
                f"injected router load fault for {basis_id!r} "
                f"(REPRO_FAULT_SERVE_RAISE_AT_LOAD)")

    def _load(self, basis_id: str) -> _Entry:
        from repro_torch.api import ReducedBasis

        self._maybe_inject_load_fault(basis_id)
        source = self._sources[basis_id]
        if isinstance(source, str):
            basis = ReducedBasis.load(source, self.device)
            evictable = True
        else:
            basis = source
            evictable = False
        persisted = "_eim" in vars(basis)
        eim = basis.eim()   # instant when the artifact carried the leaves
        if self._metrics is not None:
            self._metrics.count("basis_loads")
        entry = _Entry(basis, eim, _entry_bytes(basis, eim), evictable,
                       self._generations.get(basis_id, 0))
        logger.info(
            "router loaded %r: k=%d N=%d dtype=%s eim=%s gen=%d (%.1f MiB)",
            basis_id, basis.k, basis.N, basis.Q.dtype,
            "persisted" if persisted else "computed",
            entry.generation, entry.nbytes / 2**20)
        return entry

    # ------------------------------------------------------- hot reload ----
    def verify_artifact(self, directory: str) -> int:
        """CRC-verify the NEWEST artifact step in ``directory``; returns
        the verified step number or raises ``IOError``/``KeyError``.

        Unlike :meth:`ReducedBasis.load` — which *skips* damaged steps
        and falls back to older intact ones (right for startup, wrong for
        a refresh: silently re-serving the stale artifact would report a
        successful swap that swapped nothing) — this checks exactly the
        candidate a refresh is about to go live with.
        """
        from repro_torch.checkpoint.io import list_steps, load_checkpoint_raw

        if os.environ.get("REPRO_FAULT_SERVE_CORRUPT_RELOAD"):
            from repro_torch.checkpoint.io import _fault_once

            if _fault_once("serve_corrupt_reload"):
                raise IOError(
                    "injected corrupt reload candidate "
                    "(REPRO_FAULT_SERVE_CORRUPT_RELOAD)")
        steps = list_steps(directory)
        if not steps:
            raise IOError(f"no artifact steps in {directory}")
        newest = steps[-1]
        tree = load_checkpoint_raw(directory, step=newest)  # raises on CRC
        if "artifact_version" not in tree:
            raise KeyError(
                f"newest step {newest} in {directory} is not a "
                f"ReducedBasis artifact")
        return newest

    def refresh(self, basis_id: str, source=None) -> int:
        """Atomically swap ``basis_id``'s live entry for the artifact now
        on disk; returns the new generation.

        The candidate (``source`` directory if given, else the registered
        one) is loaded and CRC-verified OUTSIDE the lock — a corrupt or
        unreadable candidate raises (counted as ``reload_failures``) and
        the live basis keeps serving untouched.  On success the entry is
        replaced under the lock with generation ``old+1`` and
        ``on_refresh(basis_id, old_gen, new_gen)`` fires, so the engine
        retires the old generation's warm interpolant-cache entries;
        batches already holding the old entry finish on the old
        generation.  Works on non-resident ids too (the bumped generation
        just applies to the next load).
        """
        from repro_torch.api import ReducedBasis

        with self._lock:
            if basis_id not in self._sources:
                raise KeyError(f"unknown basis_id {basis_id!r}")
            registered = self._sources[basis_id]
            directory = os.fspath(source) if source is not None \
                else registered
        if not isinstance(directory, str):
            raise ValueError(
                f"refresh({basis_id!r}) needs an artifact directory; the "
                f"basis is registered in-memory (pinned) — pass source=")
        try:
            self.verify_artifact(directory)
            basis = ReducedBasis.load(directory, self.device)
            eim = basis.eim()
        except Exception:
            if self._metrics is not None:
                self._metrics.count("reload_failures")
            logger.exception(
                "refresh(%r) rejected candidate in %s; live basis "
                "untouched", basis_id, directory)
            raise
        with self._lock:
            old_gen = self._generations.get(basis_id, 0)
            if basis_id in self._live:
                old_gen = self._live[basis_id].generation
            new_gen = old_gen + 1
            self._generations[basis_id] = new_gen
            self._sources[basis_id] = directory
            entry = _Entry(basis, eim, _entry_bytes(basis, eim), True,
                           new_gen)
            was_live = basis_id in self._live
            self._live[basis_id] = entry   # keeps / takes LRU slot
            if was_live:
                self._live.move_to_end(basis_id)
            self._shrink_to_budget(keep=basis_id)
        if self._metrics is not None:
            self._metrics.count("reloads")
        logger.info("refresh(%r): generation %d -> %d (k=%d, %s)",
                    basis_id, old_gen, new_gen, basis.k, directory)
        if self._on_refresh is not None:
            self._on_refresh(basis_id, old_gen, new_gen)
        return new_gen

    def _shrink_to_budget(self, keep: str) -> None:
        """Evict LRU evictable entries (never ``keep``) while over budget.

        A single basis larger than the whole budget stays resident — the
        router serves it and logs, rather than thrashing or failing."""
        def resident():
            return sum(e.nbytes for e in self._live.values())

        while resident() > self.memory_budget_bytes:
            victim = next(
                (bid for bid, e in self._live.items()
                 if bid != keep and e.evictable), None)
            if victim is None:
                logger.warning(
                    "router over memory budget (%d > %d bytes) with no "
                    "evictable basis left; keeping %d resident",
                    resident(), self.memory_budget_bytes, len(self._live))
                return
            self._live.pop(victim)
            if self._metrics is not None:
                self._metrics.count("basis_evictions")
            logger.info("router evicted %r (LRU, over budget)", victim)
            if self._on_evict is not None:
                self._on_evict(victim)

    def stats(self) -> dict:
        with self._lock:
            return {
                "registered": len(self._sources),
                "resident": len(self._live),
                "resident_bytes": sum(e.nbytes
                                      for e in self._live.values()),
                "memory_budget_bytes": self.memory_budget_bytes,
                "generations": dict(self._generations),
            }
