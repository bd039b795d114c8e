"""Randomized sketch (range-finder) model reduction over snapshot providers.

PyTorch port of :mod:`repro.core.randomized`.  The greedy family reads S
once per accepted basis vector (or per ``block_p`` bases); the randomized
range-finder (Halko, Martinsson and Tropp; RPOD) folds every tile of S
into a small sketch in ONE streamed pass,

    Y = S @ Omega,          Omega: (M, ell) test matrix, ell = k + p,

after which a dense QR/SVD of the (N, ell) sketch yields a basis whose
projection error matches the optimal rank-k (POD) error up to the
oversampling factor (E ||(I - QQ^H) S||_F^2 <= (1 + k/(p-1))
sum_{j>k} sigma_j^2).

The test matrix is never formed: tile t meets its own block ``Omega_t``,
drawn on the device by the ``sketch_omega`` kernel from
``fold_in(PRNGKey(seed), t)`` — the reference's own ``jax.random`` stream
(:mod:`repro_torch.kernels.sketch_omega.ref`): bitwise on rademacher
blocks, through another ``erfinv`` on gaussian ones.  So the pass is
order-deterministic and resumable, and the port's sketch can be held
against the reference's numerically.

``power=q`` adds q rounds of subspace iteration, two passes each (``Z =
S^H Q``, then ``Y = S Z``), orthonormalizing between applications: ``1 +
2 * power`` passes over S in all.  With ``power=0`` the sketch's singular
values over ``sqrt(ell)`` estimate the spectrum; with ``power>=1`` they
are Ritz values of S.  The rank is Algorithm 1's criterion on those
estimates (the count of ``sigma_hat >= tau``), capped at ``max_k``.

Where the port departs from the reference:

* tiles come through the streamed driver's reader
  (:class:`repro_torch.core.streaming._Tiles`: the next tile is requested
  while the current one is folded);
* the sketch ``Y``, the co-range ``Z`` (M x ell) and the column norms stay
  on the device, with no host sync per tile; the reference holds ``Z`` and
  the norms on the host and syncs every tile.  They reach the host only in
  a checkpoint;
* a tile's column norms are summed in the streamed driver's fixed order
  (:func:`repro_torch.sums.column_norms_sq`), so ``norms_sq`` is its bit
  for bit.

Mid-build checkpoints persist the partial sketch (phase, tile cursor, Y, Z,
norms) in the reference's v1 tree through :mod:`repro_torch.checkpoint.io`;
a killed pass resumes from the last saved tile and lands on the same bits.
A partial sketch that the JAX package wrote resumes here too, under its
backend's counterpart (``xla`` and ``pallas`` -> ``auto``, ``xla_ref`` ->
``ref``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import backend as _backend
from repro_torch.core.streaming import _BACKEND_COUNTERPART, _sync, _Tiles
from repro_torch.data.providers import as_provider
from repro_torch.device import resolve_device
from repro_torch.kernels.sketch_omega.ref import KINDS as SKETCH_KINDS
from repro_torch.sums import column_norms_sq

_STATE_VERSION = 1

__all__ = ["SKETCH_KINDS", "RandomizedSketchResult", "RankEstimate",
           "estimate_rank", "rb_randomized_streamed"]


class RandomizedSketchResult(NamedTuple):
    """Result of the streamed randomized range-finder.

    Attributes:
      Q:        (N, k) orthonormal basis (left singular vectors of the
                sketch) in the provider's dtype, on its device.
      svals:    (ell,) numpy singular-value ESTIMATES of S (see the module
                docstring), real dtype, non-increasing.
      k:        selected rank (the tau criterion on ``svals``, capped at
                ``max_k``).
      ell:      sketch width ``min(max_k + sketch_p, N, M)``.
      n_passes: streamed passes over the provider (``1 + 2 * power``).
      tile_m / n_tiles: tiling the pass used.
      sketch_p / power / seed / kind: the sketch parameters (provenance).
      norms_sq: (M,) snapshot column norms^2 from the first pass, on the
                provider's device.
    """

    Q: torch.Tensor
    svals: np.ndarray
    k: int
    ell: int
    n_passes: int
    tile_m: int
    n_tiles: int
    sketch_p: int
    power: int
    seed: int
    kind: str
    norms_sq: torch.Tensor


def _thin_q(Y: torch.Tensor) -> torch.Tensor:
    """Orthonormalize between power-iteration applications (a thin QR of a
    tall-skinny array; Halko Alg. 4.4's stabilization)."""
    return torch.linalg.qr(Y, mode="reduced")[0]


class _SketchState:
    """Resumable state of the streamed sketch pass(es).

    ``phase`` counts applications of S: 0 is the sketch fold ``Y = S
    Omega``; odd phases fill ``Z = S^H Y``; even phases >= 2 re-apply ``Y =
    S Z``.  ``cursor`` is the next tile INDEX of the current phase; the
    orthonormalizations run at ``cursor == 0`` of a phase and are replayed
    deterministically on resume.  Y, Z and norms_sq live on the device.
    """

    __slots__ = ("tile_m", "ell", "seed", "kind", "backend", "phase",
                 "cursor", "Y", "Z", "norms_sq", "done", "seq")

    def to_tree(self) -> dict:
        """Flat numpy tree in the reference's v1 layout (keys, dtypes)."""
        _sync(self.Y.device)
        tree = {
            "version": np.asarray(_STATE_VERSION, np.int64),
            # the cursor is in tile units and the blocks are drawn per
            # (seed, tile): a resume must replay the same tiling, width,
            # seed and kind; the backend too (a partial Y carries one
            # backend's draws and summation order)
            "tile_m": np.asarray(self.tile_m, np.int64),
            "ell": np.asarray(self.ell, np.int64),
            "seed": np.asarray(self.seed, np.int64),
            "kind": np.asarray(self.kind),
            "backend": np.asarray(self.backend),
            "phase": np.asarray(self.phase, np.int64),
            "cursor": np.asarray(self.cursor, np.int64),
            "Y": self.Y.cpu().numpy(),
            "norms_sq": self.norms_sq.cpu().numpy(),
            "done": np.asarray(self.done, np.int64),
        }
        if self.Z is not None:
            tree["Z"] = self.Z.cpu().numpy()
        return tree

    @classmethod
    def from_tree(cls, tree: dict, device: torch.device) -> "_SketchState":
        from repro_torch.data.providers import to_device

        version = int(tree["version"])
        if version != _STATE_VERSION:
            raise ValueError(
                f"sketch checkpoint version {version} != supported "
                f"{_STATE_VERSION}")
        st = cls()
        st.tile_m = int(tree["tile_m"])
        st.ell = int(tree["ell"])
        st.seed = int(tree["seed"])
        st.kind = str(tree["kind"])
        name = str(tree["backend"])
        st.backend = _BACKEND_COUNTERPART.get(name, name)
        st.phase = int(tree["phase"])
        st.cursor = int(tree["cursor"])
        st.Y = to_device(np.asarray(tree["Y"]), device)
        Z = tree.get("Z")
        st.Z = None if Z is None else to_device(np.asarray(Z), device)
        st.norms_sq = to_device(np.asarray(tree["norms_sq"]), device)
        st.done = int(tree["done"])
        st.seq = 0
        return st


def _save_state(st: _SketchState, directory: str, keep: int = 2) -> None:
    """Persist the state as a new step and prune all but the newest
    ``keep``."""
    from repro_torch.checkpoint.io import prune_steps, save_checkpoint

    st.seq += 1
    save_checkpoint(st.to_tree(), directory, st.seq)
    prune_steps(directory, keep)


def _load_state(directory: str, device: torch.device
                ) -> Optional[_SketchState]:
    from repro_torch.checkpoint.io import latest_step, load_checkpoint_raw

    step = latest_step(directory)
    if step is None:
        return None
    st = _SketchState.from_tree(load_checkpoint_raw(directory), device)
    # the tree carries no step number (the reference's keys): number the
    # resumed run's saves after the newest one on disk, so the pruner
    # keeps them and retires the old ones
    st.seq = step
    return st


def _check_resumed(st: _SketchState, tile_m, ell, seed, kind, N, M, dtype,
                   backend) -> None:
    if st.tile_m != tile_m:
        raise ValueError(
            f"sketch checkpoint tile_m mismatch: saved {st.tile_m}, "
            f"requested {tile_m}")
    if st.ell != ell:
        raise ValueError(
            f"sketch checkpoint width mismatch: saved ell={st.ell}, "
            f"requested {ell} (max_k + sketch_p changed?)")
    if st.seed != seed or st.kind != kind:
        raise ValueError(
            f"sketch checkpoint test-matrix mismatch: saved "
            f"(seed={st.seed}, kind={st.kind!r}), requested "
            f"(seed={seed}, kind={kind!r})")
    if tuple(st.Y.shape) != (N, ell) or st.norms_sq.shape[0] != M:
        raise ValueError(
            f"sketch checkpoint shape mismatch: Y {tuple(st.Y.shape)} / M "
            f"{st.norms_sq.shape[0]} vs requested ({N}, {ell}) / {M}")
    if st.Y.dtype != dtype:
        raise ValueError(
            f"sketch checkpoint dtype mismatch: saved {st.Y.dtype}, "
            f"provider {dtype}")
    if st.backend != backend and not st.done:
        # a partial Y/Z carries one backend's draws and summation order
        raise ValueError(
            f"sketch checkpoint was written under backend {st.backend!r}; "
            f"resume with that backend (requested {backend!r})")


class RankEstimate(NamedTuple):
    """Result of :func:`estimate_rank`.

    Attributes:
      k: estimated numerical rank at ``tau`` (the count of sketched
        singular-value estimates ``>= tau``).
      ell: final sketch width the estimate came from.
      saturated: True when every sketched singular value sat above ``tau``
        even at the widest sketch tried — the true rank is ``>= k`` and the
        estimate is only a lower bound.
      passes: total streamed passes over the provider spent estimating
        (one per doubling round).
    """

    k: int
    ell: int
    saturated: bool
    passes: int


def estimate_rank(
    source,
    tau: float,
    *,
    ell0: int = 32,
    max_ell: int = 512,
    seed: int = 0,
    kind: str = "gaussian",
    tile_m: int = 8192,
    backend: str | None = None,
    device=None,
) -> RankEstimate:
    """Sketch-based numerical-rank estimate.

    One randomized pass at width ``ell`` counts the sketched singular-value
    estimates above ``tau`` (:func:`rb_randomized_streamed`'s rank
    criterion, at ``sketch_p = 0``).  A SATURATED estimate (all ``ell``
    values above ``tau``) doubles ``ell`` and streams again, up to
    ``min(max_ell, N, M)``: a rank-r family costs ``O(log2(r / ell0))``
    passes.  The estimate is good enough for planning, not a substitute
    for a build's own stopping test.
    """
    prov = as_provider(source, device)
    N, M = prov.shape
    hard_cap = min(max_ell, N, M)
    ell = min(max(int(ell0), 1), hard_cap)
    passes = 0
    while True:
        res = rb_randomized_streamed(
            prov, tau=tau, max_k=ell, sketch_p=0, power=0, seed=seed,
            kind=kind, tile_m=tile_m, backend=backend)
        passes += res.n_passes
        saturated = int(res.k) >= res.ell
        if not saturated or res.ell >= hard_cap:
            return RankEstimate(k=int(res.k), ell=res.ell,
                                saturated=saturated, passes=passes)
        ell = min(2 * ell, hard_cap)


def rb_randomized_streamed(
    source,
    tau: float | None = None,
    max_k: int | None = None,
    *,
    sketch_p: int = 10,
    power: int = 0,
    seed: int = 0,
    kind: str = "gaussian",
    tile_m: int = 8192,
    backend: str | None = None,
    checkpoint_dir: str | os.PathLike | None = None,
    checkpoint_every_tiles: int = 0,
    resume: bool = False,
    device=None,
) -> RandomizedSketchResult:
    """The streamed randomized range-finder over a snapshot provider.

    ``source`` may be a provider, a resident array or tensor, or a ``.npy``
    path (:func:`repro_torch.data.providers.as_provider`, with tiles on
    ``device``: ``cuda`` unless asked; a provider keeps its own device).
    With ``power=0`` the provider is streamed EXACTLY ONCE (one ``tile()``
    call per tile); each power round costs two more passes.

    Args:
      tau: the rank rule's tolerance on the singular-value estimates
        (``None`` keeps all ``max_k``).
      max_k: target rank cap (default ``min(N, M)``); the sketch width is
        ``min(max_k + sketch_p, N, M)``.
      sketch_p: oversampling columns beyond ``max_k``.
      power: subspace-iteration rounds (two extra passes each).
      seed / kind: the test matrix, ``"gaussian"`` or ``"rademacher"``
        blocks drawn per tile from ``fold_in(PRNGKey(seed), tile_index)``.
      tile_m / backend: as in :func:`repro_torch.core.streaming.
        rb_greedy_streamed`.
      checkpoint_dir / checkpoint_every_tiles / resume: persist the partial
        sketch every N tiles (phase boundaries always checkpoint when a
        directory is given); a resumed pass redraws the remaining blocks
        and gives the uninterrupted pass's bits.
    """
    prov = as_provider(source, device)
    if device is not None and prov.device != resolve_device(device):
        raise ValueError(f"provider places tiles on {prov.device}, "
                         f"requested {resolve_device(device)}")
    dev = prov.device
    N, M = prov.shape
    if max_k is None:
        max_k = min(N, M)
    max_k = min(max_k, N, M)
    if sketch_p < 0:
        raise ValueError(f"sketch_p must be >= 0, got {sketch_p}")
    if power < 0:
        raise ValueError(f"power must be >= 0, got {power}")
    if kind not in SKETCH_KINDS:
        raise ValueError(f"unknown sketch kind {kind!r}; valid: "
                         f"{SKETCH_KINDS}")
    if tile_m < 1:
        raise ValueError(f"tile_m must be >= 1, got {tile_m}")
    if checkpoint_every_tiles < 0:
        raise ValueError("checkpoint_every_tiles must be >= 0")
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True requires checkpoint_dir")
    backend = _backend.resolve_backend(backend)
    ckpt_dir = os.fspath(checkpoint_dir) if checkpoint_dir is not None \
        else None

    ell = min(max_k + sketch_p, N, M)
    tiles = list(prov.tiles(tile_m))
    n_tiles = len(tiles)
    n_phases = 1 + 2 * power
    dtype = prov.dtype
    rdt = dtype.to_real()

    st = _load_state(ckpt_dir, dev) if (resume and ckpt_dir) else None
    if st is not None:
        _check_resumed(st, tile_m, ell, seed, kind, N, M, dtype, backend)
    else:
        st = _SketchState()
        st.tile_m, st.ell = tile_m, ell
        st.seed, st.kind, st.backend = seed, kind, backend
        st.phase, st.cursor = 0, 0
        st.Y = torch.zeros((N, ell), dtype=dtype, device=dev)
        st.Z = None
        st.norms_sq = torch.zeros((M,), dtype=rdt, device=dev)
        st.done, st.seq = 0, 0
        if ckpt_dir:
            from repro_torch.checkpoint.io import latest_step

            st.seq = latest_step(ckpt_dir) or 0

    def maybe_ckpt(mid_sweep: bool) -> None:
        if not ckpt_dir:
            return
        if mid_sweep and not (checkpoint_every_tiles
                              and st.cursor < n_tiles
                              and st.cursor % checkpoint_every_tiles == 0):
            return
        _save_state(st, ckpt_dir)

    while not st.done:
        ph = st.phase
        if ph % 2 == 1 and st.cursor == 0:
            # odd pass: Z = S^H Q, the co-range of the orthonormal range
            st.Y = _thin_q(st.Y)
            st.Z = torch.zeros((M, ell), dtype=dtype, device=dev)
        elif ph > 0 and ph % 2 == 0 and st.cursor == 0:
            # even pass: orthonormalize the co-range, so the final sketch's
            # singular values are Ritz values of S
            st.Z = _thin_q(st.Z)
            st.Y = torch.zeros((N, ell), dtype=dtype, device=dev)
        stream = _Tiles(prov, tiles, st.cursor)
        for i, (lo, hi), T in stream:
            if ph == 0:
                Om = _backend.sketch_block(seed, i, (hi - lo, ell), dtype,
                                           kind, dev, backend)
                st.Y = _backend.sketch_fold(T, Om, st.Y, backend)
                st.norms_sq[lo:hi] = column_norms_sq(T)
            elif ph % 2 == 1:
                st.Z[lo:hi] = _backend.sketch_project(T, st.Y, backend)
            else:
                st.Y = _backend.sketch_fold(T, st.Z[lo:hi], st.Y, backend)
            stream.prefetch()
            st.cursor = i + 1
            maybe_ckpt(mid_sweep=True)
        st.phase += 1
        st.cursor = 0
        if st.phase >= n_phases:
            st.done = 1
            st.Z = None
        maybe_ckpt(mid_sweep=False)

    # --- small dense SVD of the sketch (negligible next to one pass) ----
    U, s, _ = torch.linalg.svd(st.Y, full_matrices=False)
    s = s.cpu().numpy()
    if power == 0:
        # E ||x^H Omega||^2 = ell ||x||^2 for unit-variance test columns
        svals = s / np.sqrt(float(ell))
    else:
        svals = s  # Ritz values of S on the orthonormal co-range
    if tau is None:
        k = min(max_k, ell)
    else:
        # Algorithm 1's criterion on the estimates
        k = int(np.sum(svals >= tau))
        k = min(k, max_k, ell)
    Q = U[:, :k].to(dtype).contiguous()
    return RandomizedSketchResult(
        Q=Q, svals=svals, k=k, ell=ell, n_passes=n_phases, tile_m=tile_m,
        n_tiles=n_tiles, sketch_p=sketch_p, power=power, seed=seed,
        kind=kind, norms_sq=st.norms_sq)
