"""Block RB-greedy: p pivots per sweep of S.

PyTorch port of :mod:`repro.core.block_greedy`.  The paper's algorithm
reads all of S once per basis vector; block pivoting selects the top-p
residual columns in one sweep, orthogonalizes them jointly (iterated GS
with an in-block rank guard that rejects a candidate whose residual
collapses once the earlier picks of its block are in), and updates every
column's residual with ONE (p, N) x (N, M) panel sweep
(:func:`repro_torch.core.backend.block_sweep`): one read of S per p bases.
The price is pivot staleness: picks 2..p of a block ignore picks 1..i-1.

``state.k`` counts SLOTS, holes included: a rejected candidate leaves a
zero column in Q, a ``-1`` pivot and a zero row in R; the driver compacts
them away at the end (:func:`_compact_result`), capped at ``max_k``.

PyTorch has no ``lax.while_loop`` or ``lax.cond``, so, as in
:mod:`repro_torch.core.greedy`, a chunk runs a fixed number of masked
blocks with a stop code latched on the device (checked in the reference's
order: rank, then tau, then the refresh trigger); a block after the latch,
or one whose leading residual is already below tau, writes nothing.  The
host syncs once per chunk.

Two drivers:

- :func:`_rb_greedy_block_impl` — the chunked device-resident driver (the
  front door's ``strategy="block_greedy"``);
- :func:`rb_greedy_block_stepwise` — one block and host syncs per block;
  the parity oracle, identical pivot for pivot.
"""

from __future__ import annotations

import warnings

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
    _clone_state,
    _put,
    _setup,
    _validate_resident_tree,
    floor_estimate,
    greedy_init,
    greedy_refresh,
    imgs_orthogonalize,
    load_resident_checkpoint,
    panel_imgs_orthogonalize,
    resident_state_from_tree,
    save_resident_checkpoint,
)


def top_p(res_sq: torch.Tensor, p: int):
    """The ``p`` largest residuals and their indices, largest first; equal
    values in increasing index order, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order for ties).  A stable descending
    sort gives that order on every device."""
    vals, idx = torch.sort(res_sq, descending=True, stable=True)
    return vals[:p], idx[:p]


def _ortho_block(V, Q, idx, active, p, kappa, max_passes, thresh, backend,
                 panel):
    """Orthogonalize one block of p candidates (the columns of the (N, p)
    panel ``V``) against ``Q`` and against each other, with the in-block
    rank guard; the block is written into ``Q``'s slots ``idx`` where
    ``active`` (rejected candidates leave zero "hole" columns).

    ``panel=True`` (p > 1) runs :func:`panel_imgs_orthogonalize`;
    ``panel=False`` keeps p sequential :func:`imgs_orthogonalize` calls
    with fixed-slot writes.  Both span the same space and differ only in
    float summation order.  Where ``active`` is false the GS passes do not
    read ``Q`` (their results are discarded with the block).

    Returns ``(Qnew, oks, rnorms, n_passes)``.
    """
    if panel and p > 1:
        Qnew, oks, rnorms, npasses = panel_imgs_orthogonalize(
            V, Q, kappa, max_passes, thresh=thresh, backend=backend,
            active=active)
        _put(Q, 1, idx, Qnew, active)
        return Qnew, oks, rnorms, npasses
    qs, oks, rnorms, npasses = [], [], [], []
    for i in range(p):
        v = V[:, i].contiguous()
        q, _, rnorm, n_pass = imgs_orthogonalize(v, Q, kappa, max_passes,
                                                 backend=backend,
                                                 active=active)
        ok = rnorm > thresh
        q = torch.where(ok, q, torch.zeros_like(q))
        # the later candidates of the block see this one in Q
        _put(Q, 1, idx[i:i + 1], q.unsqueeze(1), active)
        qs.append(q)
        oks.append(ok)
        rnorms.append(rnorm)
        npasses.append(n_pass)
    return (torch.stack(qs, dim=1), torch.stack(oks), torch.stack(rnorms),
            torch.stack(npasses))


def _add_block(S, st: GreedyState, top_vals, top_idx, active, p, kappa,
               max_passes, thresh, backend, panel, V=None):
    """Orthogonalize the block, sweep S once, and write slots
    ``st.k .. st.k + p - 1`` of Q, R, pivots and errs where ``active``,
    in place.  ``V`` is the block's (N, p) panel of candidate columns
    (default: ``S``'s columns ``top_idx``; the distributed driver passes
    the panel it fetched from the owners).  Returns ``(idx, oks, rnorms,
    n_passes)``; ``k`` is the caller's to advance."""
    idx = st.k + torch.arange(p, device=S.device)
    if V is None:
        V = S.index_select(1, top_idx)                     # (N, p)
    Qnew, oks, rnorms, npasses = _ortho_block(
        V, st.Q, idx, active, p, kappa, max_passes, thresh, backend, panel)
    # ONE pass over S for the whole block
    C, acc = _backend.block_sweep(Qnew, S, st.acc, backend=backend)
    _put(st.R, 0, idx, C, active)
    st.acc.copy_(torch.where(active, acc, st.acc))
    _put(st.pivots, 0, idx,
         torch.where(oks, top_idx, -1).to(st.pivots.dtype), active)
    _put(st.errs, 0, idx, torch.sqrt(torch.clamp(top_vals, min=0.0)),
         active)
    return idx, oks, rnorms, npasses


def _thresh(state: GreedyState, scale):
    return 50.0 * torch.finfo(state.norms_sq.dtype).eps * scale


def block_greedy_step(S: torch.Tensor, state: GreedyState, p: int,
                      kappa: float = 2.0, max_passes: int = 3,
                      backend: str | None = None, scale=None,
                      panel: bool = True) -> GreedyState:
    """Add up to p bases with a single sweep over S (the stepwise
    oracle's step), in place.

    The block goes into slots ``state.k .. state.k + p - 1``; the returned
    state's ``k`` is ``state.k`` plus the number of ACCEPTED candidates,
    and, as in the reference's step, ``rnorms``/``n_passes`` are not
    written.  ``scale`` is the rank guard's column scale (fixed at init by
    the drivers); ``None`` takes ``sqrt(max norms_sq)``.
    """
    res_sq = torch.clamp(state.norms_sq - state.acc, min=0.0)
    top_vals, top_idx = top_p(res_sq, p)
    if scale is None:
        scale = torch.sqrt(state.norms_sq.max())
    active = torch.ones((), dtype=torch.bool, device=S.device)
    _, oks, _, _ = _add_block(S, state, top_vals, top_idx, active, p,
                              kappa, max_passes, _thresh(state, scale),
                              backend, panel)
    return state._replace(k=state.k + oks.sum().to(state.k.dtype))


def rb_greedy_block(S, tau: float, p: int = 4, max_k: int | None = None,
                    kappa: float = 2.0, max_passes: int = 3,
                    refresh: str = "auto", refresh_safety: float = 100.0,
                    backend: str | None = None,
                    device=None) -> GreedyResult:
    """Deprecated entry point: use ``repro_torch.api.build_basis(source=S,
    strategy="block_greedy", tau=tau, block_p=p)``, which runs the same
    chunked driver."""
    warnings.warn(
        "rb_greedy_block is deprecated: call repro_torch.api.build_basis("
        "source=S, strategy='block_greedy', tau=tau, block_p=p) instead "
        "(identical result, unified ReducedBasis artifact)",
        DeprecationWarning, stacklevel=2)
    return _rb_greedy_block_impl(
        S, tau, p=p, max_k=max_k, kappa=kappa, max_passes=max_passes,
        refresh=refresh, refresh_safety=refresh_safety, backend=backend,
        device=device)


# ------------------------------------------------ chunked blocked driver ----


def _block_chunk(S, state: GreedyState, n_blocks, tau, scale, ref_sq,
                 refresh_safety, p, kappa, max_passes, backend,
                 check_refresh, panel):
    """Run ``n_blocks`` masked blocks with a latched device stop code.

    Each block: top-p selection; if the leading residual is below tau the
    block is not added (``STOP_TAU``); else joint orthogonalization with
    the rank guard, one fused sweep, and the stop code of the block:

      STOP_RANK     every candidate of the block was rank-rejected,
      STOP_TAU      the post-block residual fell below tau,
      STOP_REFRESH  the post-block residual neared the Eq.-(6.3)
                    cancellation floor,

    in that precedence.  Once a code latches, later blocks write nothing.
    The host chooses ``n_blocks`` so that every block fits in the slots.
    Returns ``(state, stop)`` with ``stop`` a 0-d int32 device tensor.
    """
    eps = torch.finfo(state.norms_sq.dtype).eps
    thresh = _thresh(state, scale)
    stop = torch.full((), STOP_NONE, dtype=torch.int32, device=S.device)
    none = torch.full_like(stop, STOP_NONE)
    for _ in range(n_blocks):
        active = stop == STOP_NONE
        res_sq = torch.clamp(state.norms_sq - state.acc, min=0.0)
        top_vals, top_idx = top_p(res_sq, p)
        go = torch.sqrt(top_vals[0]) >= tau
        idx, oks, rnorms, npasses = _add_block(
            S, state, top_vals, top_idx, active & go, p, kappa, max_passes,
            thresh, backend, panel)
        _put(state.rnorms, 0, idx, rnorms.to(state.rnorms.dtype),
             active & go)
        _put(state.n_passes, 0, idx, npasses.to(state.n_passes.dtype),
             active & go)
        state = state._replace(k=state.k + p * (active & go).to(
            state.k.dtype))
        res_after = torch.clamp(torch.max(state.norms_sq - state.acc),
                                min=0.0)
        refresh_hit = (res_after < refresh_safety * eps * ref_sq) \
            if check_refresh else torch.zeros_like(active)
        code = torch.where(
            oks.sum() == 0, STOP_RANK,
            torch.where(res_after < tau * tau, STOP_TAU,
                        torch.where(refresh_hit, STOP_REFRESH, none)))
        code = torch.where(go, code.to(stop.dtype), STOP_TAU)
        stop = torch.where(active, code.to(stop.dtype), stop)
    return state, stop


def _compact_result(state, max_k: int, stop: int = STOP_NONE
                    ) -> GreedyResult:
    """Drop the hole columns (rejected in-block candidates) from the slot
    buffers: keep the unit columns of Q with their rows of R, pivots, errs
    and diagnostics, capped at ``max_k`` accepted bases (the basis is
    nested, so the cut is exact).  One host sync (the data-dependent
    gather)."""
    keep = torch.nonzero(torch.linalg.vector_norm(state.Q, dim=0) > 0.5
                         ).squeeze(1)[:max_k]
    k = int(keep.numel())

    def packed(x, dim):
        out = torch.zeros_like(x)
        out.narrow(dim, 0, k).copy_(x.index_select(dim, keep))
        return out

    return GreedyResult(
        Q=packed(state.Q, 1), R=packed(state.R, 0),
        pivots=packed(state.pivots, 0), errs=packed(state.errs, 0), k=k,
        n_ortho_passes=packed(state.n_passes, 0),
        rnorms=packed(state.rnorms, 0), stop=stop,
    )


def _rb_greedy_block_impl(
    S,
    tau: float,
    p: int = 4,
    max_k: int | None = None,
    kappa: float = 2.0,
    max_passes: int = 3,
    refresh: str = "auto",
    refresh_safety: float = 100.0,
    backend: str | None = None,
    chunk: int = 4,
    callback=None,
    panel: bool = True,
    adaptive: bool = False,
    diagnostics: dict | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    device=None,
) -> GreedyResult:
    """Chunked device-resident blocked driver (the front door's
    ``strategy="block_greedy"``).

    ``chunk`` BLOCKS (up to ``chunk * p`` bases) run per host sync;
    selects the same pivots as :func:`rb_greedy_block_stepwise`.

    ``panel`` (default True) orthogonalizes each block through the BLAS-3
    panel path; ``panel=False`` keeps the p-sequential form.

    ``adaptive`` treats ``p`` as a ceiling: the live width halves after a
    chunk whose rank guard rejected more than 25% of its slots and doubles
    back (capped at ``p``) after a clean one.  With a ``diagnostics`` dict
    the width trajectory lands in ``diagnostics["p_trajectory"]`` (one
    ``{slots, p, rejected}`` entry per chunk).

    ``callback(state)`` fires once per chunk with a copy of the slot
    state.  ``checkpoint_dir``/``resume`` mirror
    :func:`repro_torch.core.greedy.rb_greedy`; the live width rides along
    as ``p_live``.

    The returned ``k`` counts accepted bases, holes compacted away, and
    never exceeds ``max_k``.  ``S`` is placed on ``device`` (``cuda``
    unless ``device="cpu"``).
    """
    S, N, M, max_k = _setup(S, max_k, device)
    if p < 1:
        raise ValueError(f"block_p must be >= 1, got {p}")
    p = min(p, min(N, M))
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    max_slots = min(max_k + p, min(N, M) + p)  # + hole headroom (max p)
    backend = _backend.resolve_backend(backend)
    state = greedy_init(S, max_slots)
    rdt = state.norms_sq.dtype
    eps = torch.finfo(rdt).eps
    ref_sq = float(state.norms_sq.max())
    scale = ref_sq ** 0.5  # fixed global column scale for the rank guard
    done = False
    final_stop = STOP_NONE
    p_live = p
    seq = 0
    if checkpoint_dir is not None:
        from repro_torch.checkpoint.io import latest_step

        tree = load_resident_checkpoint(checkpoint_dir) if resume else None
        if tree is not None:
            _validate_resident_tree(tree, N, M, max_slots, S.dtype,
                                    "resume checkpoint")
            state, ref_sq, scale, done, final_stop = \
                resident_state_from_tree(tree, S.device)
            p_live = int(tree.get("p_live", p))
        seq = latest_step(checkpoint_dir) or 0

    def dev_scalar(x):
        return torch.tensor(x, dtype=rdt, device=S.device)

    tau_d, scale_d = dev_scalar(tau), dev_scalar(scale)
    safety_d, ref_sq_d = dev_scalar(refresh_safety), dev_scalar(ref_sq)
    trajectory = [] if diagnostics is not None else None
    k = int(state.k)
    while not done and k + p_live <= max_slots:
        slots_before = k
        state, stop = _block_chunk(
            S, state, min(chunk, (max_slots - k) // p_live), tau_d, scale_d,
            ref_sq_d, safety_d, p_live, kappa, max_passes, backend,
            refresh == "auto", panel)
        # slots past k were never written, so their pivots are still 0:
        # every -1 from slots_before on is a rejection of this chunk
        rejected = (state.pivots[slots_before:] < 0).sum()
        k, stop, rejected = torch.stack(
            [state.k, stop.to(torch.int64), rejected]).tolist()
        if callback is not None:
            callback(_clone_state(state))
        slots_added = k - slots_before
        if trajectory is not None:
            trajectory.append({"slots": slots_before, "p": p_live,
                               "rejected": rejected})
        if adaptive and slots_added:
            if rejected / slots_added > 0.25 and p_live > 1:
                # staleness bites: most in-block picks collapse once the
                # earlier ones land — narrow the panel
                p_live = max(1, p_live // 2)
            elif rejected == 0 and p_live < p:
                p_live = min(p, p_live * 2)
        if stop == STOP_TAU or stop == STOP_RANK:
            done, final_stop = True, stop
        elif stop == STOP_REFRESH:
            state = greedy_refresh(S, state)
            ref_sq = max(float(state.norms_sq.max()), 1e-300)
            ref_sq_d = dev_scalar(ref_sq)
            if ref_sq ** 0.5 < tau:
                done, final_stop = True, STOP_TAU
            elif ref_sq ** 0.5 <= floor_estimate(eps, scale, k):
                done, final_stop = True, STOP_FLOOR
        if not done and k + p_live > max_slots:
            done = True  # out of slots; final_stop stays STOP_NONE
        if checkpoint_dir is not None:
            seq = save_resident_checkpoint(
                checkpoint_dir, seq, state, ref_sq, scale, done, final_stop,
                extra={"p_live": p_live})
    if diagnostics is not None:
        diagnostics["p_trajectory"] = trajectory
    return _compact_result(state, max_k, final_stop)


# --------------------------------------------------- stepwise block oracle --


def rb_greedy_block_stepwise(
    S,
    tau: float,
    p: int = 4,
    max_k: int | None = None,
    kappa: float = 2.0,
    max_passes: int = 3,
    refresh: str = "auto",
    refresh_safety: float = 100.0,
    backend: str | None = None,
    panel: bool = True,
    device=None,
) -> GreedyResult:
    """The per-block driver: one block step and host syncs per block; the
    parity oracle of :func:`_rb_greedy_block_impl`.  Like the reference's
    oracle it records no ``rnorms``/``n_ortho_passes`` (they stay zero).
    """
    S, N, M, max_k_req = _setup(S, max_k, device)
    max_slots = min(max_k_req + p, min(N, M) + p)
    backend = _backend.resolve_backend(backend)
    state = greedy_init(S, max_slots)
    eps = torch.finfo(state.norms_sq.dtype).eps
    ref_sq = float(state.norms_sq.max())
    scale = ref_sq ** 0.5
    scale_d = torch.tensor(scale, dtype=state.norms_sq.dtype,
                           device=S.device)
    final_stop = STOP_NONE
    slots = 0  # occupied slots, holes included
    while slots + p <= max_slots:
        prev_k = int(state.k)
        state = state._replace(k=torch.full_like(state.k, slots))
        state = block_greedy_step(S, state, p, kappa, max_passes,
                                  backend=backend, scale=scale_d,
                                  panel=panel)
        n_acc = int(state.k) - slots
        slots += p
        err = float(state.errs[slots - p])  # max residual before the block
        state = state._replace(k=torch.full_like(state.k, prev_k + n_acc))
        if err < tau:
            final_stop = STOP_TAU
            break
        err_now = float(torch.sqrt(torch.clamp(
            (state.norms_sq - state.acc).max(), min=0.0)))
        if refresh == "auto" and err_now ** 2 < refresh_safety * eps * ref_sq:
            state = greedy_refresh(S, state)
            ref_sq = max(float(state.norms_sq.max()), 1e-300)
            if ref_sq ** 0.5 < tau:
                final_stop = STOP_TAU
                break
            if ref_sq ** 0.5 <= floor_estimate(eps, scale, int(state.k)):
                final_stop = STOP_FLOOR
                break
        if err_now < tau or n_acc == 0:
            final_stop = STOP_TAU if err_now < tau else STOP_RANK
            break
    return _compact_result(state, max_k_req, final_stop)
