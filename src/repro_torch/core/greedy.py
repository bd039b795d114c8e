"""Algorithm 3: RB-greedy with well-conditioned iterated Gram-Schmidt.

PyTorch port of :mod:`repro.core.greedy`.  The per-iteration structure
follows the paper's Sec. 6.1.2:

  pivot search:      sigma_k^2(s_i) = |s_i|^2 - sum_j |c_j|^2,  c_j = q_j^H s_i
                     (Eq. 6.3 — squared form, monotone accumulated sum),
  orthogonalization: Hoffmann's iterated (classical) Gram-Schmidt, kappa = 2.

The two hot primitives (the Eq.-6.3 sweep and the GS projection pass) go
through :mod:`repro_torch.core.backend`: hand-written CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.

PyTorch has no ``lax.while_loop``, so the two data-dependent loops run
without host syncs this way:

- the GS re-run loop runs ``max_passes`` passes; a pass past the kappa test
  is masked out with ``torch.where`` on the device, which leaves ``v``,
  the coefficients and the pass count equal to the conditional loop's;
- the chunk loop runs up to ``chunk`` steps with a stop code latched on the
  device (checked in the order rank -> tau -> refresh); a step after a
  latched stop writes nothing.  The host reads ``(k, stop)`` once per
  chunk.

Both masks also reach the kernels as an on-device ``active`` flag: a pass
past the kappa test, and every pass and sweep of a step after the latched
stop, return without reading Q or S (what a zero vector would give), so
the masked work costs a launch, not a read of the data.

The driver state is updated IN PLACE (``Q``, ``R``, ``acc`` and the
per-step vectors), where the reference donated its buffers.

Two drivers:

- :func:`rb_greedy` — the chunked device-resident driver.
- :func:`rb_greedy_stepwise` — one step and one host sync per basis
  vector; the parity oracle, identical pivot for pivot.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import backend as _backend
from repro_torch.device import numpy_dtype, resolve_device


class GreedyResult(NamedTuple):
    """Result of Algorithm 3.

    Attributes:
      Q:      (N, max_k) orthonormal basis; columns >= k are zero.
      R:      (max_k, M) rows of the triangular factor in ORIGINAL column
              order: R[j] = q_j^H S.
      pivots: (max_k,) int32 selected column indices (the permutation Pi);
              a basis dropped by the tau stop or the rank guard leaves -1.
      errs:   (max_k,) greedy error *before* adding basis j (Cor. 5.6).
      k:      number of valid bases.
      n_ortho_passes: (max_k,) int32 iterated-GS pass count per basis.
      rnorms: (max_k,) orthogonalization residual norm of each pivot.
      stop:   why the build terminated (one of the STOP_* codes).
    """

    Q: torch.Tensor
    R: torch.Tensor
    pivots: torch.Tensor
    errs: torch.Tensor
    k: int
    n_ortho_passes: torch.Tensor
    rnorms: torch.Tensor
    stop: int = 0


class GreedyState(NamedTuple):
    """Carried state of the greedy iteration.

    ``norms_sq``/``acc`` implement Eq. (6.3): residual_i^2 = norms_sq_i -
    acc_i.  After an exact refresh (:func:`greedy_refresh`) ``norms_sq``
    holds the exact residuals and ``acc`` restarts from zero.  The tensors
    are updated in place by :func:`greedy_step`; ``k`` is a 0-d int64
    tensor on the state's device.
    """

    Q: torch.Tensor         # (N, max_k) basis, zero-padded
    R: torch.Tensor         # (max_k, M)
    norms_sq: torch.Tensor  # (M,) reference residual^2 at last refresh
    acc: torch.Tensor       # (M,) sum_j |c_j|^2 since refresh
    pivots: torch.Tensor    # (max_k,) int32
    errs: torch.Tensor      # (max_k,) real
    n_passes: torch.Tensor  # (max_k,) int32
    rnorms: torch.Tensor    # (max_k,) real
    k: torch.Tensor         # () int64


def imgs_orthogonalize(v: torch.Tensor, Q: torch.Tensor, kappa: float = 2.0,
                       max_passes: int = 3, backend: str | None = None,
                       active: torch.Tensor | None = None):
    """Hoffmann iterated (classical) Gram-Schmidt with ratio test kappa.

    Orthogonalizes ``v`` against the columns of ``Q`` (zero columns are
    no-ops).  A pass re-runs while the norm dropped by more than a factor
    ``kappa``, up to ``max_passes``.  All ``max_passes`` passes are
    launched; the ones past the test are masked on the device, so nothing
    syncs, and are told so by their ``active`` flag, so they do not read
    ``Q``.

    ``active``: an optional 0-d bool device tensor (``None``: true) that
    masks the whole call: pass 1 gets it, pass n > 1 ``active & rerun``.
    Where it is false the result is meaningless and the caller discards it.

    Returns ``(q, coeffs, rnorm, n_passes)`` with
    ``v = Q @ coeffs + rnorm * q`` and ``|q|_2 = 1`` (when rnorm > 0);
    ``rnorm`` and ``n_passes`` are 0-d device tensors.
    """
    norm_prev = torch.linalg.vector_norm(v)
    v_cur, coeffs = _backend.project_pass(v, Q, backend=backend,
                                          active=active)
    norm_cur = torch.linalg.vector_norm(v_cur)
    n = torch.ones((), dtype=torch.int32, device=v.device)
    for _ in range(1, max_passes):
        rerun = (norm_cur < norm_prev / kappa) & (n < max_passes)
        v_next, c = _backend.project_pass(
            v_cur, Q, backend=backend,
            active=rerun if active is None else active & rerun)
        v_cur = torch.where(rerun, v_next, v_cur)
        coeffs = torch.where(rerun, coeffs + c, coeffs)
        norm_prev = torch.where(rerun, norm_cur, norm_prev)
        norm_cur = torch.where(rerun, torch.linalg.vector_norm(v_next),
                               norm_cur)
        n = n + rerun.to(n.dtype)
    safe = torch.clamp(norm_cur, min=torch.finfo(norm_cur.dtype).tiny)
    return v_cur / safe.to(v_cur.dtype), coeffs, norm_cur, n


def panel_imgs_orthogonalize(V: torch.Tensor, Q: torch.Tensor,
                             kappa: float = 2.0, max_passes: int = 3,
                             thresh=0.0, backend: str | None = None,
                             active: torch.Tensor | None = None):
    """BLAS-3 panel orthogonalization: p candidates against Q at once.

    The steps of the reference (:func:`repro.core.greedy`'s namesake):

    1. iterated classical-GS projection of the whole (N, p) panel against
       ``Q`` (:func:`repro_torch.core.backend.panel_project`), with
       Hoffmann's kappa re-run test per column; the ``max_passes - 1``
       re-run passes always run, and a column past its test keeps its
       value (``torch.where``), so values and pass counts equal the
       reference's conditional loop;
    2. a within-panel sequential sweep: candidate i against the finished
       panel columns < i, through :func:`imgs_orthogonalize`;
    3. the rank guard: a candidate whose residual norm is not strictly
       above ``thresh`` becomes a zero column;
    4. the BCGS2 re-orthogonalization cycle (a second vs-Q panel pass and
       one within-panel sweep on the normalized panel), needed when an
       accepted candidate lost more than ``kappa`` in step 2.  It is
       always launched and selected with ``torch.where``, so nothing
       syncs; its sweep's passes are told by their ``active`` flag
       whether it is needed, and skip reading the panel when not.

    ``active``: an optional 0-d bool device tensor (``None``: true); where
    it is false the within-panel passes do not read the panel, and the
    result is meaningless (the caller discards it).

    Returns ``(P, oks, rnorms, n_passes)``: the (N, p) panel (rejected
    columns zero), the (p,) rank-guard verdicts, the (p,) residual norms
    after steps 1-3 and the (p,) int32 pass counts (vs-Q passes, plus the
    re-orthogonalization cycle, plus within-panel re-runs beyond the
    first).
    """
    p = V.shape[1]
    norm_prev = torch.linalg.vector_norm(V, dim=0)
    V_cur, _ = _backend.panel_project(V, Q, backend=backend)
    norm_cur = torch.linalg.vector_norm(V_cur, dim=0)
    n_col = torch.ones((p,), dtype=torch.int32, device=V.device)
    for _ in range(1, max_passes):
        rerun = (norm_cur < norm_prev / kappa) & (n_col < max_passes)
        V_next, _ = _backend.panel_project(V_cur, Q, backend=backend)
        V_cur = torch.where(rerun, V_next, V_cur)
        norm_prev = torch.where(rerun, norm_cur, norm_prev)
        norm_cur = torch.where(rerun, torch.linalg.vector_norm(V_next, dim=0),
                               norm_cur)
        n_col = n_col + rerun.to(n_col.dtype)

    P = torch.zeros_like(V)
    oks, rnorms, extra = [], [], []
    for i in range(p):
        q, _, rnorm, n_pass = imgs_orthogonalize(
            V_cur[:, i].contiguous(), P, kappa, max_passes, backend=backend,
            active=active)
        ok = rnorm > thresh
        P[:, i] = torch.where(ok, q, torch.zeros_like(q))
        oks.append(ok)
        rnorms.append(rnorm)
        extra.append(n_pass - 1)  # re-runs beyond the unconditional pass
    oks = torch.stack(oks)
    rnorms = torch.stack(rnorms)

    need_reortho = torch.any(oks & (rnorms * kappa < norm_cur))
    reortho = need_reortho if active is None else active & need_reortho
    P2, _ = _backend.panel_project(P, Q, backend=backend)
    P_re = torch.zeros_like(P)
    for i in range(p):
        v, _ = _backend.project_pass(P2[:, i].contiguous(), P_re,
                                     backend=backend, active=reortho)
        nrm = torch.linalg.vector_norm(v)
        safe = torch.clamp(nrm, min=torch.finfo(nrm.dtype).tiny)
        P_re[:, i] = torch.where(oks[i], v / safe.to(v.dtype),
                                 torch.zeros_like(v))
    P = torch.where(need_reortho, P_re, P)
    n_passes = n_col + need_reortho.to(torch.int32) + torch.stack(
        extra).to(torch.int32)
    return P, oks, rnorms, n_passes


def _column_norms_sq(S: torch.Tensor, col_chunk: int = 8192) -> torch.Tensor:
    """sum_n |S[n, i]|^2 per column.

    Each column is summed in an order fixed by N alone
    (:func:`repro_torch.sums.column_norms_sq`), so the streamed
    driver's tiles give the same bits as the resident S: normalized GW
    snapshots have norms equal to an ulp, and the first pivot is their
    argmax.  On the card S goes to the kernel in one launch; on the CPU
    the plain tree runs in column chunks of ``col_chunk`` (its levels
    are S-sized temporaries)."""
    from repro_torch.sums import column_norms_sq

    if S.device.type != "cpu":
        return column_norms_sq(S)
    out = torch.empty(S.shape[1], dtype=S.dtype.to_real(), device=S.device)
    for lo in range(0, S.shape[1], col_chunk):
        out[lo:lo + col_chunk] = column_norms_sq(S[:, lo:lo + col_chunk])
    return out


def greedy_init(S: torch.Tensor, max_k: int) -> GreedyState:
    """Initial greedy state on S's device."""
    N, M = S.shape
    rdt, dev = S.dtype.to_real(), S.device
    return GreedyState(
        Q=torch.zeros((N, max_k), dtype=S.dtype, device=dev),
        R=torch.zeros((max_k, M), dtype=S.dtype, device=dev),
        norms_sq=_column_norms_sq(S),
        acc=torch.zeros((M,), dtype=rdt, device=dev),
        pivots=torch.zeros((max_k,), dtype=torch.int32, device=dev),
        errs=torch.zeros((max_k,), dtype=rdt, device=dev),
        n_passes=torch.zeros((max_k,), dtype=torch.int32, device=dev),
        rnorms=torch.zeros((max_k,), dtype=rdt, device=dev),
        k=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _put(buf: torch.Tensor, dim: int, idx: torch.Tensor, new: torch.Tensor,
         active: torch.Tensor) -> None:
    """``buf[idx] = new`` along ``dim`` where ``active``, in place; ``idx``
    is a device index, so nothing syncs."""
    old = buf.index_select(dim, idx)
    buf.index_copy_(dim, idx, torch.where(active, new, old))


def _step(S, state: GreedyState, active, kappa, max_passes, backend):
    """One masked iteration; returns ``(state, err, rnorm)``."""
    # max with dim gives the first index of the maximum, like argmax, and
    # keeps both on the device (indexing with a 0-d tensor would sync)
    err_sq, j = torch.clamp(state.norms_sq - state.acc, min=0.0).max(dim=0)
    err = torch.sqrt(err_sq)
    v = S.index_select(1, j.view(1)).squeeze(1)
    q, _, rnorm, n_pass = imgs_orthogonalize(v, state.Q, kappa, max_passes,
                                             backend=backend, active=active)
    # Row k of R and the Eq.-(6.3) update in one fused S pass.  The kernel's
    # post-update max/argmax belong to the NEXT pivot; this step re-derives
    # the pivot from norms_sq - acc above.  A masked step does not read S.
    c, acc, _, _ = _backend.pivot_update(q, S, state.acc, state.norms_sq,
                                         backend=backend, active=active)
    kk = state.k.view(1)
    _put(state.Q, 1, kk, q.unsqueeze(1), active)
    _put(state.R, 0, kk, c.unsqueeze(0), active)
    state.acc.copy_(torch.where(active, acc, state.acc))
    _put(state.pivots, 0, kk, j.to(torch.int32).view(1), active)
    _put(state.errs, 0, kk, err.view(1), active)
    _put(state.n_passes, 0, kk, n_pass.view(1), active)
    _put(state.rnorms, 0, kk, rnorm.to(state.rnorms.dtype).view(1), active)
    return state._replace(k=state.k + active.to(state.k.dtype)), err, rnorm


def greedy_step(S: torch.Tensor, state: GreedyState, kappa: float = 2.0,
                max_passes: int = 3, backend: str | None = None
                ) -> GreedyState:
    """One iteration of Algorithm 3 (pivot search + orthogonalization).

    The pivot is the argmax of ``clamp(norms_sq - acc, min=0)``, gathered
    with a device index; the column is orthogonalized with iterated GS and
    written to slot ``k`` of Q; the sweep writes row ``k`` of R and the new
    ``acc``.  Updates ``state``'s tensors in place and returns the state
    with ``k + 1``.  Requires ``k < max_k``.
    """
    active = torch.ones((), dtype=torch.bool, device=S.device)
    return _step(S, state, active, kappa, max_passes, backend)[0]


def greedy_refresh(S: torch.Tensor, state: GreedyState,
                   col_chunk: int = 8192) -> GreedyState:
    """Exact residual recomputation (beyond-paper deep-tolerance mode).

    Eq. (6.3) tracks residual^2 = |s|^2 - sum|c|^2, whose subtraction has
    an absolute error floor of eps * |s|^2.  This refresh recomputes the
    exact residual^2 of every column, ``|S - Q (Q^H S)|^2``, stores it as
    the new reference and restarts ``acc`` from zero — in place.  The
    products are formed in column chunks
    (:func:`repro_torch.core.errors.project_chunk`: ``torch.matmul`` on the
    card, as the reference left them to XLA), so that no second S-sized
    tensor exists; the streamed driver's refresh forms the same chunks.
    """
    from repro_torch.core.errors import project_chunk

    for lo in range(0, S.shape[1], col_chunk):
        hi = min(lo + col_chunk, S.shape[1])
        state.norms_sq[lo:hi] = project_chunk(S[:, lo:hi], state.Q)[1]
    state.acc.zero_()
    return state


# Stop codes reported by a device-resident chunk (the host reads ONE scalar
# per chunk).  STOP_FLOOR is a host-side verdict only (the post-refresh
# floor gate), never an in-chunk code.
STOP_NONE, STOP_RANK, STOP_TAU, STOP_REFRESH, STOP_FLOOR = 0, 1, 2, 3, 4

STOP_NAMES = {
    STOP_NONE: "STOP_NONE",        # ran to max_k (or slot capacity)
    STOP_RANK: "STOP_RANK",        # numerical-rank exhaustion (rank guard)
    STOP_TAU: "STOP_TAU",          # converged below tau
    STOP_REFRESH: "STOP_REFRESH",  # internal chunk code, never final
    STOP_FLOOR: "STOP_FLOOR",      # estimated achievable floor reached
}

# Safety factor of the achievable-floor gate (see floor_estimate).
FLOOR_SAFETY = 10.0


def floor_estimate(eps: float, scale: float, k: int) -> float:
    """Estimated achievable residual floor of a k-basis build.

    Each of the k orthogonalization/projection stages contributes O(eps)
    rounding relative to the data scale ``scale`` (= max column norm);
    the contributions accumulate stochastically, giving
    ~eps * |s| * sqrt(k).  ``FLOOR_SAFETY`` absorbs the constants.
    """
    return FLOOR_SAFETY * eps * scale * max(k, 1) ** 0.5


def _drop_last(state: GreedyState, k: int) -> GreedyState:
    """Remove the most recently added basis (tau-stop / rank-guard drop),
    in place."""
    state.Q[:, k] = 0
    state.R[k, :] = 0
    state.pivots[k] = -1
    return state._replace(k=torch.full_like(state.k, k))


def _clone_state(state: GreedyState) -> GreedyState:
    return GreedyState(*(x.clone() for x in state))


# ------------------------------------------- resident checkpoint/resume ----
# The chunked driver persists its GreedyState at chunk boundaries through
# repro_torch.checkpoint.io, in the same tree (keys, dtypes, version) as the
# reference's, plus the host loop variables and a done/stop pair saved
# AFTER the host's stop handling.

_RESIDENT_STATE_VERSION = 1


def resident_state_tree(state: GreedyState, ref_sq: float, scale: float,
                        done: bool, stop: int,
                        extra: dict | None = None) -> dict:
    """Flat numpy tree of a resident GreedyState + host loop variables.

    Only the first ``k`` rows of R are saved;
    :func:`resident_state_from_tree` zero-pads them back.
    """
    k = int(state.k)

    def host(t):
        return t.detach().cpu().numpy()

    tree = {
        "version": np.asarray(_RESIDENT_STATE_VERSION, np.int64),
        "Q": host(state.Q),
        "R": host(state.R[:k]),
        "norms_sq": host(state.norms_sq),
        "acc": host(state.acc),
        "pivots": host(state.pivots),
        "errs": host(state.errs),
        "n_passes": host(state.n_passes),
        "rnorms": host(state.rnorms),
        "k": np.asarray(k, np.int64),
        "ref_sq": np.asarray(ref_sq, np.float64),
        "scale": np.asarray(scale, np.float64),
        "done": np.asarray(int(done), np.int64),
        "stop": np.asarray(int(stop), np.int64),
    }
    for key, val in (extra or {}).items():
        tree[key] = np.asarray(val)
    return tree


def resident_state_from_tree(tree: dict, device=None):
    """Inverse of :func:`resident_state_tree`.

    Returns ``(state, ref_sq, scale, done, stop)`` with the state's tensors
    on ``device`` (an entry point's device: ``cuda`` unless asked).
    """
    dev = resolve_device(device)
    version = int(tree["version"])
    if version != _RESIDENT_STATE_VERSION:
        raise ValueError(
            f"resident checkpoint version {version} != supported "
            f"{_RESIDENT_STATE_VERSION}")
    max_k = tree["Q"].shape[1]
    M = tree["norms_sq"].shape[0]
    R = np.zeros((max_k, M), tree["R"].dtype)
    R[:tree["R"].shape[0]] = tree["R"]

    from repro_torch.data.providers import to_device

    def dev_t(a):
        return to_device(a, dev)

    state = GreedyState(
        Q=dev_t(tree["Q"]), R=dev_t(R), norms_sq=dev_t(tree["norms_sq"]),
        acc=dev_t(tree["acc"]), pivots=dev_t(tree["pivots"]),
        errs=dev_t(tree["errs"]), n_passes=dev_t(tree["n_passes"]),
        rnorms=dev_t(tree["rnorms"]),
        k=torch.tensor(int(tree["k"]), dtype=torch.int64, device=dev),
    )
    return (state, float(tree["ref_sq"]), float(tree["scale"]),
            bool(int(tree["done"])), int(tree["stop"]))


def save_resident_checkpoint(directory: str, seq: int, state, ref_sq, scale,
                             done: bool, stop: int,
                             extra: dict | None = None, keep: int = 2) -> int:
    """Persist one resident-driver step; returns the new sequence number."""
    from repro_torch.checkpoint.io import prune_steps, save_checkpoint

    seq += 1
    save_checkpoint(
        resident_state_tree(state, ref_sq, scale, done, stop, extra),
        directory, seq,
    )
    prune_steps(directory, keep)
    return seq


def load_resident_checkpoint(directory: str):
    """Latest intact resident checkpoint tree, or None if none exists."""
    from repro_torch.checkpoint.io import latest_step, load_checkpoint_raw

    if latest_step(directory) is None:
        return None
    return load_checkpoint_raw(directory)


def _validate_resident_tree(tree, N, M, max_k, dtype, what="checkpoint"):
    if tree["Q"].shape != (N, max_k) or tree["norms_sq"].shape != (M,):
        raise ValueError(
            f"{what} shape mismatch: Q {tree['Q'].shape} / M "
            f"{tree['norms_sq'].shape[0]} vs requested ({N}, {max_k}) / {M}")
    if tree["Q"].dtype != numpy_dtype(dtype):
        raise ValueError(
            f"{what} dtype mismatch: saved {tree['Q'].dtype}, "
            f"requested {numpy_dtype(dtype)}")


def _greedy_chunk(S, state, n_steps, tau, scale, ref_sq, refresh_safety,
                  kappa, max_passes, backend, check_refresh):
    """Run ``n_steps`` masked iterations with a latched device stop code.

    The stop code of each step is checked in the reference's order (rank
    guard, tau, refresh trigger), compared on the device in the residual
    dtype.  Once a code latches, the remaining steps write nothing, and
    their kernels read neither Q nor S.
    Returns ``(state, stop)`` with ``stop`` a 0-d int32 device tensor.
    """
    eps = torch.finfo(state.norms_sq.dtype).eps
    stop = torch.full((), STOP_NONE, dtype=torch.int32, device=S.device)
    none = torch.full_like(stop, STOP_NONE)
    for _ in range(n_steps):
        active = stop == STOP_NONE
        state, err, rnorm = _step(S, state, active, kappa, max_passes,
                                  backend)
        refresh_hit = (err * err < refresh_safety * eps * ref_sq) \
            if check_refresh else torch.zeros_like(active)
        code = torch.where(
            rnorm < 50.0 * eps * scale, STOP_RANK,
            torch.where(err < tau, STOP_TAU,
                        torch.where(refresh_hit, STOP_REFRESH, none)))
        stop = torch.where(active, code.to(stop.dtype), stop)
    return state, stop


def _setup(S, max_k, device):
    from repro_torch.data.providers import materialize_source

    S = materialize_source(S, device)
    N, M = S.shape
    if max_k is None:
        max_k = min(N, M)
    return S, N, M, min(max_k, N, M)


def rb_greedy(
    S,
    tau: float,
    max_k: int | None = None,
    kappa: float = 2.0,
    max_passes: int = 3,
    callback=None,
    refresh: str = "auto",
    refresh_safety: float = 100.0,
    chunk: int = 16,
    backend: str | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    device=None,
) -> GreedyResult:
    """Algorithm 3 driver: iterate until ``err < tau`` or ``k == max_k``.

    Chunked device-resident loop: up to ``chunk`` iterations run with a
    stop code latched on the device and the host syncs ``(k, stop)`` once
    per chunk — identical pivots/bases to :func:`rb_greedy_stepwise`.
    ``callback(state)`` fires once per chunk with a copy of the state.

    Stop thresholds are compared on the device in the residual dtype, as
    the reference does.

    refresh: "auto" triggers :func:`greedy_refresh` when the tracked
    residual nears the Eq.-(6.3) cancellation floor
    (err^2 < safety * eps * ref^2); "never" is the paper-faithful mode.  If
    the post-refresh exact residual is still above tau but at or below
    :func:`floor_estimate`, the build stops with ``STOP_FLOOR``.

    ``checkpoint_dir``/``resume``: with a directory set the driver persists
    its full state (plus a done/stop marker) after every chunk's stop
    handling; ``resume=True`` picks up from the newest intact step, so
    killing the process at any point and re-running yields a bit-identical
    build.

    ``S`` may be anything
    :func:`repro_torch.data.providers.materialize_source` accepts; it is
    placed on ``device`` (``cuda`` unless ``device="cpu"``).
    """
    S, N, M, max_k = _setup(S, max_k, device)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    backend = _backend.resolve_backend(backend)
    state = greedy_init(S, max_k)
    rdt = state.norms_sq.dtype
    eps = torch.finfo(rdt).eps
    ref_sq = float(state.norms_sq.max())
    scale = ref_sq ** 0.5  # fixed global column scale for the rank guard
    done = False
    final_stop = STOP_NONE
    seq = 0
    if checkpoint_dir is not None:
        from repro_torch.checkpoint.io import latest_step

        tree = load_resident_checkpoint(checkpoint_dir) if resume else None
        if tree is not None:
            _validate_resident_tree(tree, N, M, max_k, S.dtype,
                                    "resume checkpoint")
            state, ref_sq, scale, done, final_stop = \
                resident_state_from_tree(tree, S.device)
        # Fresh build into a dir with older steps: continue the sequence so
        # prune/latest never interleave with stale numbering.
        seq = latest_step(checkpoint_dir) or 0

    def dev_scalar(x):
        return torch.tensor(x, dtype=rdt, device=S.device)

    tau_d, scale_d = dev_scalar(tau), dev_scalar(scale)
    safety_d, ref_sq_d = dev_scalar(refresh_safety), dev_scalar(ref_sq)
    k = int(state.k)
    while not done and k < max_k:
        state, stop = _greedy_chunk(
            S, state, min(chunk, max_k - k), tau_d, scale_d, ref_sq_d,
            safety_d, kappa, max_passes, backend, refresh == "auto")
        k, stop = torch.stack([state.k, stop.to(torch.int64)]).tolist()
        if callback is not None:
            callback(_clone_state(state))
        if stop == STOP_RANK:
            # Numerical-rank exhaustion: the pivot's orthogonalization
            # residual is rounding noise; drop it and stop.
            k -= 1
            state = _drop_last(state, k)
            done, final_stop = True, STOP_RANK
        elif stop == STOP_TAU:
            # The last basis was selected at an error already below tau:
            # drop it (Algorithm 3's while-condition semantics).
            k -= 1
            state = _drop_last(state, k)
            done, final_stop = True, STOP_TAU
        elif stop == STOP_REFRESH:
            # Near the Eq.-(6.3) cancellation floor while above tau:
            # recompute exact residuals and rescale the reference.
            state = greedy_refresh(S, state)
            ref_sq = max(float(state.norms_sq.max()), 1e-300)
            ref_sq_d = dev_scalar(ref_sq)
            if ref_sq ** 0.5 < tau:
                done, final_stop = True, STOP_TAU
            elif ref_sq ** 0.5 <= floor_estimate(eps, scale, k):
                done, final_stop = True, STOP_FLOOR
        if not done and k >= max_k:
            done = True  # ran to capacity; final_stop stays STOP_NONE
        if checkpoint_dir is not None:
            # Save AFTER stop handling, so a finished build resumes as
            # finished instead of growing extra bases.
            seq = save_resident_checkpoint(
                checkpoint_dir, seq, state, ref_sq, scale, done, final_stop)
    return GreedyResult(
        Q=state.Q, R=state.R, pivots=state.pivots, errs=state.errs,
        k=int(state.k), n_ortho_passes=state.n_passes, rnorms=state.rnorms,
        stop=final_stop,
    )


def rb_greedy_stepwise(
    S,
    tau: float,
    max_k: int | None = None,
    kappa: float = 2.0,
    max_passes: int = 3,
    callback=None,
    refresh: str = "auto",
    refresh_safety: float = 100.0,
    backend: str | None = None,
    device=None,
) -> GreedyResult:
    """The per-step driver: one step + host sync per iteration.

    Reads ``errs[k-1]``/``rnorms[k-1]`` back to the host after every step
    and compares there in float64; kept as the parity oracle for
    :func:`rb_greedy`.  ``callback(state)`` fires every iteration.
    """
    S, N, M, max_k = _setup(S, max_k, device)
    backend = _backend.resolve_backend(backend)
    state = greedy_init(S, max_k)
    eps = torch.finfo(state.norms_sq.dtype).eps
    ref_sq = float(state.norms_sq.max())
    scale = ref_sq ** 0.5
    final_stop = STOP_NONE
    k = 0
    while k < max_k:
        state = greedy_step(S, state, kappa=kappa, max_passes=max_passes,
                            backend=backend)
        k = int(state.k)
        if callback is not None:
            callback(_clone_state(state))
        err = float(state.errs[k - 1])
        rnorm = float(state.rnorms[k - 1])
        if rnorm < 50.0 * eps * scale:
            k -= 1
            state = _drop_last(state, k)
            final_stop = STOP_RANK
            break
        if err < tau:
            k -= 1
            state = _drop_last(state, k)
            final_stop = STOP_TAU
            break
        if refresh == "auto" and err * err < refresh_safety * eps * ref_sq:
            state = greedy_refresh(S, state)
            ref_sq = max(float(state.norms_sq.max()), 1e-300)
            if ref_sq ** 0.5 < tau:
                final_stop = STOP_TAU
                break
            if ref_sq ** 0.5 <= floor_estimate(eps, scale, k):
                final_stop = STOP_FLOOR
                break
    return GreedyResult(
        Q=state.Q, R=state.R, pivots=state.pivots, errs=state.errs,
        k=int(state.k), n_ortho_passes=state.n_passes, rnorms=state.rnorms,
        stop=final_stop,
    )


def rb_greedy_scan(
    S,
    tau: float,
    max_k: int,
    kappa: float = 2.0,
    max_passes: int = 3,
    backend: str | None = None,
    device=None,
) -> GreedyResult:
    """Fixed-length variant: exactly ``max_k`` masked iterations, no host
    sync.

    Port of the reference's ``lax.scan`` driver.  An iteration whose
    pre-add error is already below ``tau``, or whose pivot's
    orthogonalization residual is rounding noise (the rank guard), is
    masked: it writes a zero basis vector, a zero row of R and pivot -1 to
    slot ``k`` (its error, pass count and residual norm too) and leaves
    ``k``; its sweep gets a false ``active`` flag, so on the card it does
    not read S.  No tau drop and no refresh: the result has
    :func:`rb_greedy`'s pivots wherever neither of those acts.  ``k`` is a
    0-d device tensor (reading it is the caller's sync).
    """
    from repro_torch.data.providers import materialize_source

    S = materialize_source(S, device)
    backend = _backend.resolve_backend(backend)
    state = greedy_init(S, max_k)
    rdt = state.norms_sq.dtype
    guard = 50.0 * torch.finfo(rdt).eps * torch.sqrt(state.norms_sq.max())
    tau_d = torch.tensor(tau, dtype=rdt, device=S.device)
    for _ in range(max_k):
        err_sq, j = torch.clamp(state.norms_sq - state.acc, min=0.0).max(
            dim=0)
        err = torch.sqrt(err_sq)
        v = S.index_select(1, j.view(1)).squeeze(1)
        q, _, rnorm, n_pass = imgs_orthogonalize(v, state.Q, kappa,
                                                 max_passes, backend=backend)
        active = (err >= tau_d) & (rnorm >= guard)
        q = torch.where(active, q, torch.zeros_like(q))
        c, acc, _, _ = _backend.pivot_update(q, S, state.acc, state.norms_sq,
                                             backend=backend, active=active)
        kk = state.k.view(1)
        state.Q.index_copy_(1, kk, q.unsqueeze(1))
        state.R.index_copy_(0, kk, c.unsqueeze(0))
        state.acc.copy_(acc)
        state.pivots.index_copy_(0, kk, torch.where(
            active, j.to(torch.int32), -1).view(1))
        state.errs.index_copy_(0, kk, err.view(1))
        state.n_passes.index_copy_(0, kk, n_pass.view(1))
        state.rnorms.index_copy_(0, kk, rnorm.to(rdt).view(1))
        state = state._replace(k=state.k + active.to(state.k.dtype))
    return GreedyResult(
        Q=state.Q, R=state.R, pivots=state.pivots, errs=state.errs,
        k=state.k, n_ortho_passes=state.n_passes, rnorms=state.rnorms,
    )
