"""`ReducedBasisSet`: one artifact holding B per-basis children.

Port of :mod:`repro.api.basis_set`.  The batched strategy builds B bases
in one lockstep pass (:mod:`repro_torch.core.batch_greedy`): per
parameter region, per frequency band (:func:`repro_torch.data.bands.
band_split`), or per tau in a sweep.  They ship as ONE artifact
directory, the reference's layout::

    <dir>/basis_0/ ... basis_<B-1>/   one ReducedBasis artifact each
    <dir>/set.json                    the set manifest (commit marker)

Each child is a complete, independently loadable
:class:`~repro_torch.api.artifact.ReducedBasis`, so the serving
:class:`~repro_torch.serving.router.BasisRouter` registers the children
directly (:meth:`ReducedBasisSet.register`).  ``set.json`` is written
after every child, through a temporary file and a rename, so a reader that
finds it finds B intact children.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional

from repro_torch.api.artifact import ReducedBasis

SET_VERSION = 1

_SET_MANIFEST = "set.json"


def _child_name(i: int) -> str:
    return f"basis_{i}"


def _write_manifest(directory: str, manifest: dict) -> None:
    """``set.json`` by write-to-temp, fsync and rename: the commit marker
    appears whole or not at all."""
    final = os.path.join(directory, _SET_MANIFEST)
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


@dataclasses.dataclass(frozen=True)
class ReducedBasisSet:
    """B reduced bases built, and shipped, together.

    Attributes:
      children: one :class:`~repro_torch.api.artifact.ReducedBasis` a
        lane, in build order (band order for banded workloads, source
        order for stacked and list workloads, tau order for shared-S
        sweeps).
      provenance: the batched build's provenance (each child carries its
        own copy with its lane index, tau and stop code under ``"lane"``).
    """

    children: tuple
    provenance: Optional[dict] = None

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))
        if not self.children:
            raise ValueError("ReducedBasisSet needs at least one basis")

    @property
    def batch(self) -> int:
        return len(self.children)

    def __len__(self) -> int:
        return len(self.children)

    def __getitem__(self, i: int) -> ReducedBasis:
        return self.children[i]

    def __iter__(self) -> Iterator[ReducedBasis]:
        return iter(self.children)

    def save(self, directory: str) -> str:
        """Persist every child under ``directory``, then the set manifest.

        Children save first (each its own atomic artifact step), the
        manifest last by write-to-temp and rename: a save cut short leaves
        child directories but no ``set.json``, so :meth:`load` never sees a
        partial set, and saving again completes it.
        """
        os.makedirs(directory, exist_ok=True)
        for i, child in enumerate(self.children):
            child.save(os.path.join(directory, _child_name(i)))
        _write_manifest(directory, {
            "set_version": SET_VERSION,
            "batch": self.batch,
            "children": [_child_name(i) for i in range(self.batch)],
            "provenance": self.provenance,
        })
        return directory

    @classmethod
    def load(cls, directory: str, device=None) -> "ReducedBasisSet":
        """Load a set saved by :meth:`save` (either package's), children
        bit-identical, their tensors on ``device`` (``cuda`` unless
        asked).  Needs the ``set.json`` commit marker; each child keeps its
        directory, so the router can load it again after an eviction."""
        path = os.path.join(directory, _SET_MANIFEST)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no basis-set manifest at {path} (incomplete save, or "
                f"not a ReducedBasisSet directory)") from None
        if manifest.get("set_version") != SET_VERSION:
            raise IOError(
                f"unsupported set_version {manifest.get('set_version')!r} "
                f"in {path}")
        children = tuple(
            ReducedBasis.load(os.path.join(directory, name), device)
            for name in manifest["children"])
        return cls(children=children, provenance=manifest.get("provenance"))

    def register(self, router, prefix: str = "basis",
                 names=None) -> list:
        """Register every child with a serving router; returns the ids.

        ``names`` overrides the default ``"{prefix}_{i}"`` ids (one a
        child).  A child backed by a directory (the set was saved or
        loaded) registers by directory, evictable under the router's
        memory budget; an unsaved child is pinned, as
        :meth:`repro_torch.serving.router.BasisRouter.register` does.
        """
        if names is None:
            names = [f"{prefix}_{i}" for i in range(self.batch)]
        if len(names) != self.batch:
            raise ValueError(f"{len(names)} names for {self.batch} children")
        for name, child in zip(names, self.children):
            router.register(name, child)
        return list(names)
