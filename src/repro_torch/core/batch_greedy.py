"""Lockstep batched RB-greedy: B independent builds in one pass.

PyTorch port of :mod:`repro.core.batch_greedy`.  The offline stage of a GW
pipeline builds many bases: one per parameter region for the serving
router, one per frequency band (:func:`repro_torch.data.bands.band_split`,
then reduce each band), one per tau in a tolerance sweep.  Each scalar
build spends its time in the Eq.-(6.3) sweep, which reads S once per basis
vector; this driver runs the B builds in LOCKSTEP, one round advancing
every live lane by one basis vector, in two snapshot layouts:

  stacked   ``S``: (B, N, M), one matrix a lane (banded / per-region
            workloads).  One launch of the ``greedy_update_lanes`` kernel
            sweeps every lane's S[b] a round.
  shared    ``S``: (N, M), one matrix swept by B basis states (tau
            sweeps).  The same kernel reads S once a round for up to 16
            lanes, where B sequential builds read it B times.

In both layouts every lane is BITWISE the port's scalar
:func:`repro_torch.core.greedy.rb_greedy` on its matrix and tau: Q, R,
pivots, errs, rnorms, pass counts, rank and stop code.  The sweep kernel
gives each lane the scalar kernel's bits; the GS passes are the scalar
kernels launched once a lane; every other operation is elementwise, a
lane's own reduction on a row placed as the scalar driver's tensors are
(:func:`repro_torch.core.backend.lane_rows`), or the scalar driver's own
function on the lane's views (the refresh).  The reference's shared lanes
match its scalar driver pivot for pivot only (a GEMM's sums in place of a
GEMV's).

Per-lane semantics are the scalar driver's: independent pivots; tau, rank
guard, refresh and floor stop per lane, with the same host float64
comparisons.  Inside a device-resident chunk a lane's stop code latches and
the lane freezes; its flag is false in every later round, so its sweep
lane does no multiply-adds and its GS passes read nothing, while the other
lanes keep stepping.  The host reads ``(k, stops)`` once per chunk and
handles each latched code as the scalar driver does.  The build ends when
every lane has stopped; :meth:`BatchGreedyResult.lane` is the scalar
result of one lane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import backend as _backend
from repro_torch.core.greedy import (
    STOP_FLOOR,
    STOP_NONE,
    STOP_RANK,
    STOP_REFRESH,
    STOP_TAU,
    GreedyResult,
    GreedyState,
    _column_norms_sq,
    floor_estimate,
    greedy_refresh,
)
from repro_torch.device import resolve_device


class BatchGreedyState(NamedTuple):
    """B-lane greedy state: every :class:`~repro_torch.core.greedy.
    GreedyState` tensor with a leading lane axis.  Lane b of every tensor is
    the scalar state of build b; ``Q``'s lanes start on
    :data:`~repro_torch.core.backend.LANE_ALIGN` bytes."""

    Q: torch.Tensor         # (B, N, max_k) per-lane basis, zero-padded
    R: torch.Tensor         # (B, max_k, M)
    norms_sq: torch.Tensor  # (B, M) per-lane reference residual^2
    acc: torch.Tensor       # (B, M) per-lane sum_j |c_j|^2 since refresh
    pivots: torch.Tensor    # (B, max_k) int32
    errs: torch.Tensor      # (B, max_k) real
    n_passes: torch.Tensor  # (B, max_k) int32
    rnorms: torch.Tensor    # (B, max_k) real
    k: torch.Tensor         # (B,) int64 per-lane accepted rank


class BatchGreedyResult(NamedTuple):
    """Result of a lockstep build (tensors zero-padded to max_k; per-lane
    ranks in ``k``, per-lane stop codes in ``stops``) and its cadence:
    ``rounds`` (lockstep rounds run: sweep launches), ``live_rounds``
    (rounds with a live lane: reads of S in the shared layout, for up to
    16 lanes), ``chunks`` and ``refreshes`` (lane refreshes, each a pass
    over its S).  :meth:`lane` gives one lane as the scalar driver's
    result."""

    Q: torch.Tensor          # (B, N, max_k)
    R: torch.Tensor          # (B, max_k, M)
    pivots: torch.Tensor     # (B, max_k)
    errs: torch.Tensor       # (B, max_k)
    k: np.ndarray            # (B,) accepted ranks
    n_ortho_passes: torch.Tensor
    rnorms: torch.Tensor
    stops: np.ndarray        # (B,) STOP_* codes
    rounds: int = 0
    live_rounds: int = 0
    chunks: int = 0
    refreshes: int = 0

    @property
    def batch(self) -> int:
        return int(self.Q.shape[0])

    def lane(self, b: int) -> GreedyResult:
        """Lane ``b`` as a :class:`~repro_torch.core.greedy.GreedyResult`
        (zero-padded tensors, as the scalar drivers return them)."""
        return GreedyResult(
            Q=self.Q[b], R=self.R[b], pivots=self.pivots[b],
            errs=self.errs[b], k=int(self.k[b]),
            n_ortho_passes=self.n_ortho_passes[b], rnorms=self.rnorms[b],
            stop=int(self.stops[b]),
        )


def _lane_norms(x: torch.Tensor) -> torch.Tensor:
    """(B,) 2-norms of the rows of ``x``, each taken on its own row, as the
    scalar driver takes the norm of its vector."""
    return torch.stack([torch.linalg.vector_norm(x[b])
                        for b in range(x.shape[0])])


def batched_imgs_orthogonalize(v: torch.Tensor, Q: torch.Tensor,
                               kappa: float = 2.0, max_passes: int = 3,
                               backend: str | None = None,
                               active: torch.Tensor | None = None):
    """B-lane Hoffmann iterated classical GS: lane b orthogonalizes
    ``v[b]`` against its own ``Q[b]``.

    The B-lane image of :func:`repro_torch.core.greedy.imgs_orthogonalize`:
    every pass is launched, and pass n of lane b runs under ``active[b] &
    rerun[b]`` (pass 1 under ``active[b]``), the kappa test taken per lane
    on the device, so nothing syncs and a lane past its test reads nothing.
    Each lane's floats are the scalar function's on that lane.  ``active``:
    an optional (B,) bool device tensor (``None``: every lane).

    Returns ``(q, coeffs, rnorm, n_passes)`` with a leading lane axis on
    each; ``q``'s lanes sit in :func:`~repro_torch.core.backend.lane_rows`.
    """
    B = v.shape[0]
    norm_prev = _lane_norms(v)
    v_cur, coeffs = _backend.batched_project_pass(v, Q, backend=backend,
                                                  active=active)
    norm_cur = _lane_norms(v_cur)
    n = torch.ones((B,), dtype=torch.int32, device=v.device)
    for _ in range(1, max_passes):
        rerun = (norm_cur < norm_prev / kappa) & (n < max_passes)
        v_next, c = _backend.batched_project_pass(
            v_cur, Q, backend=backend,
            active=rerun if active is None else active & rerun)
        v_cur = _backend.stack_lanes(torch.where(rerun[:, None], v_next,
                                                 v_cur))
        coeffs = torch.where(rerun[:, None], coeffs + c, coeffs)
        norm_prev = torch.where(rerun, norm_cur, norm_prev)
        norm_cur = torch.where(rerun, _lane_norms(v_next), norm_cur)
        n = n + rerun.to(n.dtype)
    safe = torch.clamp(norm_cur, min=torch.finfo(norm_cur.dtype).tiny)
    q = _backend.stack_lanes([v_cur[b] / safe[b].to(v_cur.dtype)
                              for b in range(B)])
    return q, coeffs, norm_cur, n


def batch_greedy_init(S: torch.Tensor, max_k: int,
                      batch: int | None = None) -> BatchGreedyState:
    """Initial B-lane state on S's device.  ``S`` (B, N, M) stacked
    (``batch`` ignored) or (N, M) shared (``batch`` required).  Shared
    lanes share one column-norm pass, broadcast; stacked lanes take one
    on each ``S[b]``: each lane's norms are the scalar
    :func:`repro_torch.core.greedy.greedy_init`'s bits."""
    dev, rdt = S.device, S.dtype.to_real()
    if S.dim() == 2:
        if batch is None:
            raise ValueError("shared-S batched init requires batch=")
        B, (N, M) = batch, S.shape
        norms_sq = _column_norms_sq(S).expand(B, M).contiguous()
    else:
        B, N, M = S.shape
        norms_sq = torch.stack([_column_norms_sq(S[b]) for b in range(B)])
    return BatchGreedyState(
        Q=_backend.lane_rows(B, (N, max_k), S.dtype, dev),
        R=torch.zeros((B, max_k, M), dtype=S.dtype, device=dev),
        norms_sq=norms_sq,
        acc=torch.zeros((B, M), dtype=rdt, device=dev),
        pivots=torch.zeros((B, max_k), dtype=torch.int32, device=dev),
        errs=torch.zeros((B, max_k), dtype=rdt, device=dev),
        n_passes=torch.zeros((B, max_k), dtype=torch.int32, device=dev),
        rnorms=torch.zeros((B, max_k), dtype=rdt, device=dev),
        k=torch.zeros((B,), dtype=torch.int64, device=dev),
    )


def _pivot_columns(S: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Column ``j[b]`` of lane b's S, for every lane, in lane rows."""
    if S.dim() == 2:
        cols = S.index_select(1, j).T
    else:
        B, N, _ = S.shape
        cols = torch.gather(S, 2, j.view(B, 1, 1).expand(B, N, 1))[..., 0]
    return _backend.stack_lanes(cols)


def _step(S, state: BatchGreedyState, active, kappa, max_passes, backend):
    """One masked lockstep round; returns ``(state, err, rnorm)``, each
    lane's update that of the scalar driver's step under ``active[b]``."""
    B, _, max_k = state.Q.shape
    # max with dim gives the first index of each lane's maximum on the
    # device, like the scalar step's
    err_sq, j = torch.clamp(state.norms_sq - state.acc, min=0.0).max(dim=1)
    err = torch.sqrt(err_sq)
    v = _pivot_columns(S, j)
    q, _, rnorm, n_pass = batched_imgs_orthogonalize(
        v, state.Q, kappa, max_passes, backend=backend, active=active)
    c, acc, _, _ = _backend.batched_pivot_update(
        q, S, state.acc, state.norms_sq, backend=backend, active=active)
    # slot k of every lane, written where the lane is live; a lane at
    # max_k is never live, so its clamped slot takes its old value back
    lanes = torch.arange(B, device=S.device)
    kk = torch.clamp(state.k, max=max_k - 1)
    on = active[:, None]
    state.Q[lanes, :, kk] = torch.where(on, q, state.Q[lanes, :, kk])
    state.R[lanes, kk] = torch.where(on, c, state.R[lanes, kk])
    state.acc.copy_(torch.where(on, acc, state.acc))
    for buf, new in ((state.pivots, j.to(torch.int32)), (state.errs, err),
                     (state.n_passes, n_pass),
                     (state.rnorms, rnorm.to(state.rnorms.dtype))):
        buf[lanes, kk] = torch.where(active, new, buf[lanes, kk])
    return state._replace(k=state.k + active.to(state.k.dtype)), err, rnorm


def batch_greedy_step(S: torch.Tensor, state: BatchGreedyState,
                      kappa: float = 2.0, max_passes: int = 3,
                      backend: str | None = None) -> BatchGreedyState:
    """One lockstep iteration: every lane picks ITS argmax pivot,
    orthogonalizes it against ITS basis and appends it at its own slot
    ``k[b]``: the B-lane image of :func:`repro_torch.core.greedy.
    greedy_step`.  Updates ``state``'s tensors in place; every lane must
    have ``k[b] < max_k``."""
    active = torch.ones(state.k.shape, dtype=torch.bool, device=S.device)
    return _step(S, state, active, kappa, max_passes, backend)[0]


def _batch_chunk(S, state, n_steps, taus, scales, ref_sqs, refresh_safety,
                 done, kappa, max_passes, backend, check_refresh):
    """Run ``n_steps`` masked lockstep rounds with per-lane latched device
    stop codes (checked in the scalar driver's order: rank guard, tau,
    refresh trigger).  A lane is live while its code is unset, the host
    has not finished it (``done``) and it has a free slot; a latched lane
    freezes.  Returns ``(state, stops)`` with ``stops`` (B,) int32 on the
    device."""
    B, _, max_k = state.Q.shape
    eps = torch.finfo(state.norms_sq.dtype).eps
    stop = torch.full((B,), STOP_NONE, dtype=torch.int32, device=S.device)
    none = torch.full_like(stop, STOP_NONE)
    for _ in range(n_steps):
        active = (stop == STOP_NONE) & ~done & (state.k < max_k)
        state, err, rnorm = _step(S, state, active, kappa, max_passes,
                                  backend)
        refresh_hit = (err * err < refresh_safety * eps * ref_sqs) \
            if check_refresh else torch.zeros_like(active)
        code = torch.where(
            rnorm < 50.0 * eps * scales, STOP_RANK,
            torch.where(err < taus, STOP_TAU,
                        torch.where(refresh_hit, STOP_REFRESH, none)))
        stop = torch.where(active, code.to(stop.dtype), stop)
    return state, stop


def _drop_last_lane(state: BatchGreedyState, b: int,
                    k: int) -> BatchGreedyState:
    """Remove lane ``b``'s most recent basis (tau stop / rank guard), in
    place."""
    state.Q[b, :, k] = 0
    state.R[b, k, :] = 0
    state.pivots[b, k] = -1
    state.k[b] = k
    return state


def _refresh_lane(S, state: BatchGreedyState, b: int) -> BatchGreedyState:
    """Exact residual refresh of ONE lane, in place: the scalar driver's
    :func:`repro_torch.core.greedy.greedy_refresh` on the lane's views."""
    greedy_refresh(S if S.dim() == 2 else S[b],
                   GreedyState(*(x[b] for x in state)))
    return state


def _batched_source(S, device) -> torch.Tensor:
    """The lockstep driver's snapshots on ``device``: a list or tuple of
    equal-shape 2-D sources (each anything
    :func:`repro_torch.data.providers.materialize_source` accepts) stacked,
    else a (B, N, M) or (N, M) array or tensor."""
    from repro_torch.data.providers import materialize_source, to_device

    dev = resolve_device(device)
    if isinstance(S, (list, tuple)):
        mats = [materialize_source(s, dev) for s in S]
        shapes = {tuple(m.shape) for m in mats}
        if len(shapes) != 1:
            raise ValueError(
                f"batched sources must share one (N, M) shape, got "
                f"{sorted(shapes)}")
        return torch.stack(mats)
    if getattr(S, "ndim", None) not in (2, 3):
        raise ValueError(
            f"batched snapshots must be (B, N, M) stacked or (N, M) "
            f"shared, got shape {tuple(getattr(S, 'shape', ()))}")
    return to_device(S, dev)


def batch_rb_greedy(
    S,
    tau,
    max_k: int | None = None,
    batch: int | None = None,
    kappa: float = 2.0,
    max_passes: int = 3,
    refresh: str = "auto",
    refresh_safety: float = 100.0,
    chunk: int = 16,
    backend: str | None = None,
    callback=None,
    device=None,
) -> BatchGreedyResult:
    """Run B greedy builds in lockstep; every lane stops on its own terms.

    Args:
      S: the snapshot workload, placed on ``device`` (``cuda`` unless
         ``device="cpu"``):
         * (B, N, M) array or tensor, or a list or tuple of equal-shape 2-D
           sources: the STACKED layout;
         * (N, M) with ``batch=B`` (or ``tau`` a length-B sequence): the
           SHARED layout, one read of S a round for up to 16 lanes.
         Every lane is bitwise :func:`repro_torch.core.greedy.rb_greedy`
         on its matrix and tau.
      tau: scalar (every lane) or a length-B sequence (a tau sweep).
      max_k / kappa / max_passes / refresh / refresh_safety / chunk /
        backend: as on :func:`repro_torch.core.greedy.rb_greedy`, applied
        per lane (one shared chunk cadence; stop decisions, refreshes and
        the floor gate per lane, with the same host float64 comparisons).
      callback: fires once per chunk with a copy of the
        :class:`BatchGreedyState`.

    Returns a :class:`BatchGreedyResult`; ``result.lane(b)`` is build b.
    """
    S = _batched_source(S, device)
    taus_in = np.atleast_1d(np.asarray(tau, np.float64))
    if S.dim() == 3:
        B = int(S.shape[0])
        if batch is not None and batch != B:
            raise ValueError(f"batch={batch} != stacked batch {B}")
    else:
        B = batch if batch is not None else int(taus_in.shape[0])
        if B < 1:
            raise ValueError(f"batch must be >= 1, got {B}")
    if taus_in.shape[0] == 1:
        taus_in = np.full((B,), float(taus_in[0]))
    if taus_in.shape[0] != B:
        raise ValueError(
            f"tau must be scalar or length-{B}, got {taus_in.shape[0]}")
    taus_host = [float(t) for t in taus_in]

    N, M = int(S.shape[-2]), int(S.shape[-1])
    max_k = min(N, M) if max_k is None else min(max_k, N, M)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    backend = _backend.resolve_backend(backend)

    state = batch_greedy_init(S, max_k, batch=B if S.dim() == 2 else None)
    rdt, dev = state.norms_sq.dtype, S.device
    eps = torch.finfo(rdt).eps
    # per-lane host loop variables, exactly the scalar driver's floats
    ref_sqs = state.norms_sq.max(dim=1).values.tolist()
    scales = [r ** 0.5 for r in ref_sqs]
    done = np.zeros((B,), bool)
    final = np.full((B,), STOP_NONE, np.int64)

    def lane_values(xs):
        return torch.tensor(xs, dtype=rdt, device=dev)

    taus_d, scales_d = lane_values(taus_host), lane_values(scales)
    safety_d = torch.tensor(refresh_safety, dtype=rdt, device=dev)
    ref_sqs_d = lane_values(ref_sqs)
    ks = [0] * B
    rounds = live_rounds = chunks = refreshes = 0
    while not done.all():
        n_steps = min(chunk, max_k - min(ks[b] for b in range(B)
                                         if not done[b]))
        state, stops = _batch_chunk(
            S, state, n_steps, taus_d, scales_d, ref_sqs_d, safety_d,
            torch.as_tensor(done, device=dev), kappa, max_passes, backend,
            refresh == "auto")
        host = torch.cat([state.k, stops.to(torch.int64)]).tolist()
        ks_new, stops_h = host[:B], host[B:]
        rounds += n_steps
        chunks += 1
        # a lane is live in a prefix of the chunk's rounds
        live_rounds += max(k1 - k0 for k0, k1 in zip(ks, ks_new))
        ks = ks_new
        if callback is not None:
            callback(BatchGreedyState(*(x.clone() for x in state)))
        ref_changed = False
        for b in range(B):
            if done[b]:
                continue
            stop, k = stops_h[b], ks[b]
            if stop in (STOP_RANK, STOP_TAU):
                # the scalar driver's drop: the newest basis was rank-guard
                # noise, or was selected at an error already below tau
                ks[b] = k - 1
                state = _drop_last_lane(state, b, k - 1)
                done[b], final[b] = True, stop
            elif stop == STOP_REFRESH:
                state = _refresh_lane(S, state, b)
                refreshes += 1
                ref_sqs[b] = max(float(state.norms_sq[b].max()), 1e-300)
                ref_changed = True
                if ref_sqs[b] ** 0.5 < taus_host[b]:
                    done[b], final[b] = True, STOP_TAU
                elif ref_sqs[b] ** 0.5 <= floor_estimate(eps, scales[b], k):
                    done[b], final[b] = True, STOP_FLOOR
            if not done[b] and ks[b] >= max_k:
                done[b] = True  # ran to capacity; stays STOP_NONE
        if ref_changed:
            ref_sqs_d = lane_values(ref_sqs)
    return BatchGreedyResult(
        Q=state.Q, R=state.R, pivots=state.pivots, errs=state.errs,
        k=np.asarray(ks, np.int64), n_ortho_passes=state.n_passes,
        rnorms=state.rnorms, stops=final, rounds=rounds,
        live_rounds=live_rounds, chunks=chunks, refreshes=refreshes,
    )
