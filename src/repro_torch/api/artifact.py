"""`ReducedBasis`: the result artifact of a reduction.

Port of :mod:`repro.api.artifact`.  Wraps the trimmed basis Q (plus R /
pivots / errs) with build provenance, and carries the downstream workflow
as methods: projection / reconstruction / per-column errors, EIM nodes and
ROQ weights, and durable ``save``/``load`` on
:mod:`repro_torch.checkpoint.io`.  The on-disk artifact is the
reference's: a basis saved by either package loads in the other with
bit-equal arrays.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

_ARTIFACT_VERSION = 1
# EIM leaves ride in the same artifact step behind their own version gate.
_EIM_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ReducedBasis:
    """A built reduced basis plus provenance.

    Attributes:
      Q:      (N, k) orthonormal basis tensor, trimmed to the accepted rank.
      pivots: (k,) int32 selected snapshot columns (numpy).
      errs:   (k,) per-basis greedy errors (error *before* adding basis j).
      k:      accepted rank (== Q.shape[1]).
      R:      (k, M) rows ``R[j] = q_j^H S`` in ORIGINAL column order, or
              None (numpy).
      provenance: how the basis was built — strategy, backend, device,
              dtype, snapshot shape, wall time and the originating spec.
    """

    Q: torch.Tensor
    pivots: np.ndarray
    errs: np.ndarray
    k: int
    R: Optional[np.ndarray] = None
    provenance: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_arrays(cls, Q, pivots, errs, k: Optional[int] = None, R=None,
                    provenance: Optional[dict] = None,
                    device=None) -> "ReducedBasis":
        """A basis from host arrays (e.g. another package's outputs), with
        Q placed on ``device`` (``cuda`` unless asked)."""
        from repro_torch.data.providers import to_device

        Q = to_device(Q, resolve_device(device))
        return cls(Q=Q, pivots=np.asarray(pivots), errs=np.asarray(errs),
                   k=int(Q.shape[1]) if k is None else int(k),
                   R=None if R is None else np.asarray(R),
                   provenance=dict(provenance or {}))

    # ---------------------------------------------------------- reuse ----
    @property
    def N(self) -> int:
        return int(self.Q.shape[0])

    def _on_device(self, f) -> torch.Tensor:
        from repro_torch.data.providers import to_device

        return to_device(f, self.Q.device)

    def project(self, f) -> torch.Tensor:
        """Basis coefficients ``c = Q^H f`` for a vector or (N, m) batch."""
        return self.Q.mH @ self._on_device(f).to(self.Q.dtype)

    def reconstruct(self, f) -> torch.Tensor:
        """Orthogonal projection ``Q Q^H f`` onto the reduced subspace."""
        return self.Q @ self.project(f)

    def per_column_errors(self, S) -> torch.Tensor:
        """``|s_i - Q Q^H s_i|_2`` per column of S (Thm 4.3)."""
        from repro_torch.core.errors import per_column_errors
        from repro_torch.data.providers import materialize_source

        return per_column_errors(materialize_source(S, self.Q.device),
                                 self.Q)

    @functools.cached_property
    def _eim(self):
        from repro_torch.core.eim import eim_nodes

        return eim_nodes(self.Q)

    def eim(self):
        """EIM/DEIM node selection for this basis (cached EIMResult)."""
        return self._eim

    def roq_weights(self, data, quad_w) -> torch.Tensor:
        """Reduced-order quadrature weights for ``<data, .>`` at the EIM
        nodes (the paper's GW likelihood application)."""
        from repro_torch.core.eim import roq_weights

        return roq_weights(self._on_device(data), self._on_device(quad_w),
                           self._eim.B)

    def enrich(self, source, tau: Optional[float] = None,
               max_k: Optional[int] = None, tile_m: int = 8192,
               save: bool = True, **stream_kwargs) -> "ReducedBasis":
        """Extend this basis with new snapshots; returns the grown basis.

        Streams the columns of ``source`` (anything
        :func:`repro_torch.data.providers.as_provider` accepts, with tiles
        on Q's device) through the streamed greedy driver warm-started from
        this basis's Q: the existing bases are kept verbatim (bit-identical
        leading columns), and new ones are appended only where ``source``
        has residual above ``tau`` (default: the original build's tau,
        else 1e-6).  Pivot indices ``< self.k`` refer to the ORIGINAL
        build's source; new pivots index ``source``.

        When this basis is directory-backed (:attr:`directory`, set by
        :meth:`save` / :meth:`load`) and ``save=True``, the enriched basis
        is saved there as a NEW artifact step; the old one stays on disk
        one step back.
        """
        from repro_torch.core.greedy import STOP_NAMES
        from repro_torch.core.streaming import rb_greedy_streamed

        if tau is None:
            tau = float(self.provenance.get("tau", 1e-6))
        warm = {"Q": self.Q, "pivots": np.asarray(self.pivots),
                "errs": np.asarray(self.errs)}
        stream_kwargs.setdefault("device", self.Q.device)
        res = rb_greedy_streamed(source, tau=tau, max_k=max_k,
                                 tile_m=tile_m, warm_start=warm,
                                 **stream_kwargs)
        k = int(res.k)
        provenance = {
            **self.provenance,
            "enriched_from_k": int(self.k),
            "enrich_tau": tau,
            "stop": STOP_NAMES.get(int(res.stop), str(int(res.stop))),
        }
        basis = ReducedBasis(
            Q=res.Q[:, :k].contiguous(),
            pivots=res.pivots[:k].numpy(), errs=res.errs[:k].numpy(), k=k,
            R=None if res.R is None else res.R[:k].numpy(),
            provenance=provenance)
        directory = self.directory
        if save and directory is not None:
            basis.save(directory)
        return basis

    # ------------------------------------------------------ persistence ----
    def save(self, directory: str) -> str:
        """Persist to ``directory`` (atomic; one NEW step dir under it,
        numbered past any existing step, tagged ``final``).

        Arrays round-trip bit-identically (CRC-checked ``.npy`` leaves);
        provenance rides along as a JSON leaf; the EIM nodes and
        interpolant are stored too (``eim_version`` gate), so a load skips
        the EIM build.  Returns the written step directory.
        """
        from repro_torch.checkpoint.io import latest_step, save_checkpoint

        ei = self.eim()
        tree = {
            "artifact_version": np.asarray(_ARTIFACT_VERSION, np.int64),
            "Q": self.Q,
            "pivots": np.asarray(self.pivots),
            "errs": np.asarray(self.errs),
            "k": np.asarray(self.k, np.int64),
            "eim_version": np.asarray(_EIM_VERSION, np.int64),
            # int32 on disk, as the reference writes its node indices
            "eim_nodes": ei.nodes.to(torch.int32),
            "eim_B": ei.B,
            "provenance_json": np.asarray(
                json.dumps(self.provenance, default=str)),
        }
        if self.R is not None:
            tree["R"] = np.asarray(self.R)
        last = latest_step(directory)
        out = save_checkpoint(tree, directory,
                              0 if last is None else last + 1,
                              meta={"final": True})
        object.__setattr__(self, "_directory", directory)
        return out

    @property
    def directory(self) -> Optional[str]:
        """Where this basis was last saved/loaded from (None if neither)."""
        return getattr(self, "_directory", None)

    @classmethod
    def load(cls, directory: str, device=None) -> "ReducedBasis":
        """Load a basis saved by :meth:`save` (either package's), with Q
        and the EIM leaves on ``device`` (``cuda`` unless asked).

        Scans step directories newest-first and returns the newest INTACT
        artifact step: corrupt steps and non-artifact steps are skipped.
        """
        from repro_torch.checkpoint.io import list_steps, load_checkpoint_raw

        dev = resolve_device(device)
        steps = list_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no artifact steps in {directory}")
        errors = []
        for s in reversed(steps):
            try:
                tree = load_checkpoint_raw(directory, s)
                if "artifact_version" not in tree:
                    raise KeyError(
                        f"step {s} has no artifact_version leaf "
                        f"(not a ReducedBasis artifact)")
                break
            except (IOError, KeyError) as e:
                errors.append(str(e))
        else:
            raise IOError(
                f"no intact ReducedBasis artifact in {directory}; tried "
                f"steps {list(reversed(steps))}: " + "; ".join(errors))
        version = int(tree["artifact_version"])
        if version != _ARTIFACT_VERSION:
            raise ValueError(
                f"ReducedBasis artifact version {version} != supported "
                f"{_ARTIFACT_VERSION}")
        basis = cls.from_arrays(
            tree["Q"], tree["pivots"], tree["errs"], k=int(tree["k"]),
            R=tree.get("R"),
            provenance=json.loads(str(tree["provenance_json"])), device=dev)
        object.__setattr__(basis, "_directory", directory)
        if ("eim_nodes" in tree and "eim_B" in tree
                and int(tree.get("eim_version", -1)) == _EIM_VERSION):
            from repro_torch.core.eim import EIMResult
            from repro_torch.data.providers import to_device

            object.__setattr__(basis, "_eim", EIMResult(
                nodes=to_device(tree["eim_nodes"], dev).to(torch.int64),
                B=to_device(tree["eim_B"], dev),
            ))
        return basis

    def __repr__(self) -> str:  # compact, log-friendly
        p = self.provenance
        return (
            f"ReducedBasis(k={self.k}, N={self.N}, "
            f"dtype={self.Q.dtype}, strategy={p.get('strategy')!r}, "
            f"backend={p.get('backend')!r}, device={p.get('device')!r})"
        )
