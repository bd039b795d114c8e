"""`ReductionSpec`: one declarative description of a basis build.

Port of :mod:`repro.api.spec`: the reference's fields, plus ``device``.
Every strategy of the reference is ported; ``mesh`` is a
``torch.distributed`` device mesh
(:func:`repro_torch.compat.make_auto_mesh`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

# Reduction strategies build_basis dispatches on.  "auto" resolves to
# "greedy" / "block_greedy" (the problem fits the device memory budget;
# blocked when the Eq.-(6.3) sweep is DRAM-roof-bound), "streamed" (it
# does not fit; blocked under the same roofline test), or "randomized" (a
# max_k is given or sketch-estimated and the roofline model predicts the
# greedy pass count costs more than twice the sketch's 1 + 2*sketch_power
# passes) — see repro_torch.api.build.  A many-basis workload (batch=, a
# stacked, list, tuple or BandSplit source) resolves to "batched"; a mesh
# resolves to "distributed", before any roofline work.
STRATEGIES = (
    "pod", "mgs", "greedy", "block_greedy", "streamed", "distributed",
    "randomized", "sketch+greedy", "batched", "auto",
)


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
        refining its basis to tau), ``"distributed"`` (the paper's
        Sec. 6 system: S split by column over the ranks of ``mesh``,
        :func:`repro_torch.core.distributed.distributed_greedy`; every
        rank of the mesh calls ``build_basis``), ``"pod"`` (Algorithm 1,
        an SVD),
        ``"mgs"`` (Algorithm 2, pivoted MGS), ``"batched"`` (B bases in
        one lockstep pass, :func:`repro_torch.api.build.build_basis_set`:
        a (B, N, M), list, tuple or ``BandSplit`` source, or an (N, M) one
        with ``batch`` or a length-B ``tau``), or ``"auto"``, which picks
        from the problem shape, the device-memory budget and a roofline
        model of the device, and logs its choice.
      tau: stopping tolerance (the paper's ``tau``; for ``pod`` the
        smallest k with ``sigma_{k+1} < tau``); ``"batched"`` also takes
        one a lane (a tau sweep).
      max_k: basis-size cap (default ``min(N, M)``).
      backend: hot-loop backend (:mod:`repro_torch.core.backend`):
        ``"auto" | "ref"`` or None (env/default).
      chunk: greedy iterations per host sync (``block_greedy`` runs
        ``max(1, chunk // block_p)`` blocks per sync; ``distributed``
        runs ``chunk`` steps, or blocks, per sync, as the reference's).
      tile_m: streamed tile width in columns (``streamed``,
        ``randomized``, ``sketch+greedy``).
      mesh: a ``torch.distributed`` device mesh over every rank of the
        process group (:func:`repro_torch.compat.make_auto_mesh`) —
        required by ``distributed``, and flips ``"auto"`` to it.  Its
        device type must be the spec's ``device``'s.
      block_p: pivots per sweep of S (``block_greedy``, ``streamed``,
        ``distributed``);
        ``1`` is the
        paper's stepwise selection, > 1 amortizes each read of S over
        block_p bases at the cost of pivot staleness.  ``"auto"`` may
        raise it on roof-bound shapes (logged).
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
      memory_budget_bytes: device-memory budget ``"auto"`` decides
        against (default: detected device memory, overridable with the
        ``REPRO_DEVICE_MEM_BUDGET`` env var).
      bandwidth_gbps, peak_gflops, cache_bytes: the DRAM-roofline machine
        model ``"auto"`` uses to detect roof-bound Eq.-(6.3) sweeps (and
        pick a blocked strategy).  ``None`` falls back to the
        ``REPRO_DRAM_BW_GBPS`` / ``REPRO_PEAK_GFLOPS`` /
        ``REPRO_LLC_BYTES`` env vars, then to a one-time on-device
        measurement (:mod:`repro_torch.api.roofline`;
        ``REPRO_ROOFLINE_MEASURE=0`` opts out), then to per-device
        defaults (see :func:`repro_torch.api.build.machine_roofline`).
      sketch_p, sketch_power, sketch_seed, sketch_kind: randomized
        range-finder knobs (``randomized`` / ``sketch+greedy``):
        oversampling columns beyond ``max_k`` (the bound's p),
        subspace-iteration rounds (2 extra passes over S each), the
        test-matrix seed, and its distribution (``"gaussian"`` or
        ``"rademacher"``) — blocks are drawn per tile from
        ``fold_in(PRNGKey(sketch_seed), tile_index)``, the JAX package's
        own stream, so builds are reproducible and resumable.
      batch: lane count B for the many-basis lockstep build
        (``"batched"``; setting it also flips ``"auto"`` to it).
      device: where the build runs — ``"cuda"`` (default) or ``"cpu"``.
    """

    source: Any = None
    strategy: str = "auto"
    tau: float = 1e-6
    max_k: Optional[int] = None
    backend: Optional[str] = None
    chunk: int = 16
    tile_m: int = 8192
    mesh: Any = None
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
    memory_budget_bytes: Optional[int] = None
    bandwidth_gbps: Optional[float] = None
    peak_gflops: Optional[float] = None
    cache_bytes: Optional[int] = None
    sketch_p: int = 10
    sketch_power: int = 0
    sketch_seed: int = 0
    sketch_kind: str = "gaussian"
    batch: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; valid: {STRATEGIES}")
        if self.source is None:
            raise ValueError("ReductionSpec requires a source")
        if self.workdir is not None and self.checkpoint_dir is not None:
            raise ValueError(
                "workdir and checkpoint_dir are mutually exclusive: "
                "workdir manages its own build/ checkpoint directory")
        if self.batch is not None:
            if self.batch < 1:
                raise ValueError(f"batch must be >= 1, got {self.batch}")
            if self.strategy not in ("batched", "auto"):
                raise ValueError(
                    f"batch= only applies to the batched strategy "
                    f"(got strategy={self.strategy!r})")
        if self.strategy == "batched" and self.checkpoint_dir is not None:
            raise ValueError(
                "the batched strategy does not support checkpoint_dir; "
                "use workdir= (the finished set finalizes atomically)")

    @classmethod
    def waveform(cls, f, m1s, m2s, dtype=None, normalize: bool = True,
                 **kwargs) -> "ReductionSpec":
        """Spec over a GW waveform grid: columns generated on the fly.

        Wraps ``(f, m1s, m2s)`` in a
        :class:`~repro_torch.data.providers.WaveformProvider` on the spec's
        device (``kwargs["device"]``, ``cuda`` unless asked): the snapshot
        matrix is never materialized, so this pairs with
        ``strategy="streamed"`` (or ``"auto"``, which picks a streaming
        strategy when the grid exceeds the memory budget).
        """
        import torch

        from repro_torch.data.providers import WaveformProvider

        prov = WaveformProvider(
            f, m1s, m2s, dtype=torch.complex64 if dtype is None else dtype,
            normalize=normalize, device=kwargs.get("device", "cuda"))
        return cls(source=prov, **kwargs)

    def describe(self) -> dict:
        """JSON-serializable provenance view of this spec (source, mesh
        and callback summarized, not embedded)."""
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
        d["mesh"] = (
            None if self.mesh is None
            else {"axis_names": list(self.mesh.mesh_dim_names or ()),
                  "shape": [int(s) for s in self.mesh.mesh.shape]})
        d["callback"] = None if self.callback is None else "<callback>"
        d["device"] = str(self.device)
        return d
