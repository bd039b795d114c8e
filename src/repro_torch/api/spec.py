"""`ReductionSpec`: one declarative description of a basis build.

Port of :mod:`repro.api.spec`, limited to the fields the ported builders
(``greedy``, ``block_greedy``, ``streamed``, ``randomized``,
``sketch+greedy``, ``pod``, ``mgs``) read, plus ``device``.  The other
strategies of the reference (``batched``, ``distributed``) are named in
``STRATEGIES``; asking for one of them raises ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

STRATEGIES = (
    "pod", "mgs", "greedy", "block_greedy", "streamed", "distributed",
    "randomized", "sketch+greedy", "batched", "auto",
)

# Strategy -> the ROADMAP.md item that ports it.
_NOT_PORTED = {
    "batched": "queue 1 item 6 (batched many-basis greedy)",
    "distributed": "queue 1 item 7 (distributed greedy)",
}


@dataclasses.dataclass(frozen=True)
class ReductionSpec:
    """Everything :func:`repro_torch.api.build_basis` needs to build a basis.

    Attributes:
      source: the snapshot matrix — anything
        :func:`repro_torch.data.providers.as_provider` accepts (a numpy
        array, a torch tensor, a ``.npy`` path or a provider, e.g. a
        :class:`~repro_torch.data.providers.WaveformProvider` generating
        GW snapshot tiles on the fly; see :meth:`waveform`).
      strategy: ``"greedy"``, ``"block_greedy"``, ``"streamed"`` (the
        out-of-core driver: S streamed through the device in column
        tiles, never resident), ``"randomized"`` (the streamed randomized
        range-finder: 1 + 2 * sketch_power passes over S whatever k is),
        ``"sketch+greedy"`` (that sketch, then the streamed greedy driver
        refining its basis to tau), ``"pod"`` (Algorithm 1, an SVD),
        ``"mgs"`` (Algorithm 2, pivoted MGS), or ``"auto"`` (which
        resolves to ``"greedy"``).  The reference's other strategies raise
        ``NotImplementedError``.
      tau: stopping tolerance (the paper's ``tau``; for ``pod`` the
        smallest k with ``sigma_{k+1} < tau``).
      max_k: basis-size cap (default ``min(N, M)``).
      backend: hot-loop backend (:mod:`repro_torch.core.backend`):
        ``"auto" | "ref"`` or None (env/default).
      chunk: greedy iterations per host sync (``block_greedy`` runs
        ``max(1, chunk // block_p)`` blocks per sync).
      tile_m: streamed tile width in columns (``streamed``,
        ``randomized``, ``sketch+greedy``).
      block_p: pivots per sweep of S (``block_greedy``, ``streamed``);
        ``1`` is the
        paper's stepwise selection, > 1 amortizes each read of S over
        block_p bases at the cost of pivot staleness.
      panel_ortho: orthogonalize each block through the BLAS-3 panel path
        (:func:`repro_torch.core.greedy.panel_imgs_orthogonalize`) instead
        of p sequential GS chains (``block_p > 1``).
      adaptive_block: treat ``block_p`` as a ceiling and retune the live
        width between chunks from the rank guard's rejection rate; the
        width trajectory lands in the provenance (``p_trajectory``).
      kappa, max_passes: Hoffmann iterated-GS controls.
      refresh, refresh_safety: Eq.-(6.3) exact-refresh policy
        (``"never"`` is the paper-faithful mode).
      keep_R: accumulate the (k, M) R factor (``streamed``: on the host;
        the one result piece that scales with M).
      workdir: directory owning the build's lifecycle: mid-build
        checkpoints in ``<workdir>/build/``, the finished basis finalized
        atomically into ``<workdir>``, the scratch removed.  Mutually
        exclusive with ``checkpoint_dir``.
      checkpoint_dir / checkpoint_every_tiles / resume: mid-build
        checkpointing (``checkpoint_every_tiles`` is ``streamed``-only:
        also save every that many tiles of a sweep); ``resume`` also
        governs ``workdir``.
      callback: per-chunk callback, forwarded to the driver.
      sketch_p, sketch_power, sketch_seed, sketch_kind: randomized
        range-finder knobs (``randomized`` / ``sketch+greedy``):
        oversampling columns beyond ``max_k`` (the bound's p),
        subspace-iteration rounds (2 extra passes over S each), the
        test-matrix seed, and its distribution (``"gaussian"`` or
        ``"rademacher"``) — blocks are drawn per tile from
        ``fold_in(PRNGKey(sketch_seed), tile_index)``, the JAX package's
        own stream, so builds are reproducible and resumable.
      device: where the build runs — ``"cuda"`` (default) or ``"cpu"``.
    """

    source: Any = None
    strategy: str = "auto"
    tau: float = 1e-6
    max_k: Optional[int] = None
    backend: Optional[str] = None
    chunk: int = 16
    tile_m: int = 8192
    block_p: int = 1
    panel_ortho: bool = True
    adaptive_block: bool = False
    kappa: float = 2.0
    max_passes: int = 3
    refresh: str = "auto"
    refresh_safety: float = 100.0
    keep_R: bool = True
    workdir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every_tiles: int = 0
    resume: bool = False
    callback: Optional[Callable] = None
    sketch_p: int = 10
    sketch_power: int = 0
    sketch_seed: int = 0
    sketch_kind: str = "gaussian"
    device: str = "cuda"

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; valid: {STRATEGIES}")
        if self.strategy in _NOT_PORTED:
            raise NotImplementedError(
                f"strategy {self.strategy!r} is not ported to repro_torch "
                f"yet: ROADMAP.md {_NOT_PORTED[self.strategy]}")
        if self.source is None:
            raise ValueError("ReductionSpec requires a source")
        if self.workdir is not None and self.checkpoint_dir is not None:
            raise ValueError(
                "workdir and checkpoint_dir are mutually exclusive: "
                "workdir manages its own build/ checkpoint directory")

    @classmethod
    def waveform(cls, f, m1s, m2s, dtype=None, normalize: bool = True,
                 **kwargs) -> "ReductionSpec":
        """Spec over a GW waveform grid: columns generated on the fly.

        Wraps ``(f, m1s, m2s)`` in a
        :class:`~repro_torch.data.providers.WaveformProvider` on the spec's
        device (``kwargs["device"]``, ``cuda`` unless asked): the snapshot
        matrix is never materialized, so this pairs with
        ``strategy="streamed"``.
        """
        import torch

        from repro_torch.data.providers import WaveformProvider

        prov = WaveformProvider(
            f, m1s, m2s, dtype=torch.complex64 if dtype is None else dtype,
            normalize=normalize, device=kwargs.get("device", "cuda"))
        return cls(source=prov, **kwargs)

    def describe(self) -> dict:
        """JSON-serializable provenance view of this spec (source and
        callback summarized, not embedded)."""
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)}
        src = self.source
        shape = getattr(src, "shape", None)
        d["source"] = {
            "kind": type(src).__name__,
            "shape": list(shape) if shape is not None else None,
            "dtype": str(getattr(src, "dtype", None)),
            **({"path": os.fspath(src)}
               if isinstance(src, (str, os.PathLike)) else {}),
        }
        d["callback"] = None if self.callback is None else "<callback>"
        d["device"] = str(self.device)
        return d
