"""Column-distributed RB-greedy (the paper's Sec. 6 system) on
``torch.distributed``.

PyTorch port of :mod:`repro.core.distributed`.  The data decomposition is
greedycpp's: the snapshot matrix S is split by COLUMNS over every rank of a
mesh (rank r holds the (N, M/P) shard of columns ``[r M/P, (r+1) M/P)``
and its residual bookkeeping), while the basis Q (N x max_k) is
replicated.  Each rank is a process; one iteration:

  paper (MPI)                          |  here (collectives)
  -------------------------------------------------------------------------
  bcast q_k to P_pivot workers         |  Q replicated (no transfer)
  local residual update + local argmax |  same: the greedy_update kernel
                                       |  over the shard
  MPI_Allreduce (max, loc)             |  one all_reduce(SUM) of a (P, 2)
                                       |  float64 buffer, each rank filling
                                       |  its own row, then the first-index
                                       |  argmax over the rows
  owner MPI_Sends pivot column;        |  one all_reduce(SUM) of the
  master MPI_Bcasts new basis          |  owner-masked column (N-vector)
  master core orthogonalizes (serial   |  every rank runs IMGS redundantly
  bottleneck, Eq. 6.6)                 |  on the replicated Q

The reference all-gathers the (value, index) pairs; a sum of rows that are
zero but one carries the same bits (float32 and float64 values, and
indices below 2^53, survive float64), and the first-index argmax over the
rows is the reference's tie order.  The blocked sweep exchanges a (P p, 2)
buffer the same way, takes the global top-p of it, fetches the p columns
with one (N, p) all_reduce and tests its post-block residual with an
all_reduce(MAX).  Only ``all_reduce`` and ``broadcast`` are used: gloo
takes both on CUDA tensors, so one code path runs under gloo on the CPU,
under gloo with ranks sharing a card, and under NCCL.  gloo stages a CUDA
tensor through the host, so each of its collectives syncs the card; NCCL's
do not.

Every rank must issue the same collectives in the same order, or the group
hangs.  So every stop decision comes from replicated values (the exchanged
error, the stop code), and a chunk runs a fixed number of steps, later
steps masked by the latched stop (as :mod:`repro_torch.core.greedy`'s
chunk does), so each rank issues the same collectives per chunk.

The stop rules are the reference's distributed ones, not the serial
driver's: the chunk tests tau BEFORE the rank guard, and tests the rank
guard on the pivot's error (``err < 50 eps scale``).  At ``STOP_TAU`` the
host zeroes ``Q[:, k]`` and ``pivots[k]``; at ``STOP_RANK`` it only drops
``k``.

The state is a per-rank :class:`DistGreedyState` (column-split leaves hold
the rank's shard).  A checkpoint holds the reference's tree, gathered in
full by rank 0, and each rank re-slices it for the CURRENT mesh on resume,
so a run saved on 4 ranks resumes on 2 (elastic).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

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
    _put,
    _validate_resident_tree,
    floor_estimate,
    greedy_refresh,
    imgs_orthogonalize,
    load_resident_checkpoint,
)
from repro_torch.device import resolve_device


class DistGreedyState(NamedTuple):
    """One rank's greedy state (layout per leaf, :func:`state_specs`)."""

    Q: torch.Tensor         # (N, max_k) replicated
    R: torch.Tensor         # (max_k, M/P) the rank's columns
    norms_sq: torch.Tensor  # (M/P,) the rank's columns: reference residual^2
    acc: torch.Tensor       # (M/P,) the rank's columns
    pivots: torch.Tensor    # (max_k,) int32 replicated (global indices)
    errs: torch.Tensor      # (max_k,) replicated
    k: torch.Tensor         # () int64 replicated


def state_specs() -> DistGreedyState:
    """The dimension of each leaf that is split by column over the mesh's
    ranks; ``None`` for a replicated leaf (the reference's
    ``PartitionSpec`` per leaf)."""
    return DistGreedyState(Q=None, R=1, norms_sq=0, acc=0, pivots=None,
                           errs=None, k=None)


class _Layout(NamedTuple):
    """Where this rank sits in the mesh: ``P`` ranks, this one's flat
    index, the global rank of each flat index, and the shard width."""

    P: int
    index: int
    ranks: tuple
    m_loc: int

    @property
    def cols(self) -> tuple[int, int]:
        return self.index * self.m_loc, (self.index + 1) * self.m_loc


def _axis_index(mesh) -> int:
    """This rank's index flattened row-major over the mesh's dimensions."""
    idx = 0
    for c, s in zip(mesh.get_coordinate(), mesh.mesh.shape):
        idx = idx * int(s) + int(c)
    return idx


def _axis_count(mesh) -> int:
    return int(mesh.mesh.numel())


def _layout(mesh, M: int) -> _Layout:
    if not dist.is_initialized():
        raise RuntimeError("the distributed greedy needs an initialised "
                           "process group (repro_torch.launch.mesh."
                           "init_ranks)")
    P = _axis_count(mesh)
    if P != dist.get_world_size():
        raise ValueError(
            f"the mesh holds {P} ranks but the process group "
            f"{dist.get_world_size()}: the columns are split over every "
            f"rank of the group")
    if M % P:
        raise ValueError(
            f"M={M} columns do not divide over the mesh's {P} ranks")
    return _Layout(P, _axis_index(mesh),
                   tuple(int(r) for r in mesh.mesh.flatten().tolist()),
                   M // P)


def dist_greedy_init(S_loc: torch.Tensor, max_k: int) -> DistGreedyState:
    """Initial state of one rank from its column shard ``S_loc``; the
    column norms go through the ``column_norms`` kernel on the card."""
    N, m_loc = S_loc.shape
    rdt, dev = S_loc.dtype.to_real(), S_loc.device
    return DistGreedyState(
        Q=torch.zeros((N, max_k), dtype=S_loc.dtype, device=dev),
        R=torch.zeros((max_k, m_loc), dtype=S_loc.dtype, device=dev),
        norms_sq=_column_norms_sq(S_loc),
        acc=torch.zeros((m_loc,), dtype=rdt, device=dev),
        pivots=torch.zeros((max_k,), dtype=torch.int32, device=dev),
        errs=torch.zeros((max_k,), dtype=rdt, device=dev),
        k=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _clone(state: DistGreedyState) -> DistGreedyState:
    return DistGreedyState(*(x.clone() for x in state))


# -------------------------------------------------------- collectives ----


def _barrier(device) -> None:
    """All ranks here; an ``all_reduce`` (the one collective every backend
    takes on every device)."""
    dist.all_reduce(torch.zeros(1, device=device))


def _global_max(x: torch.Tensor) -> torch.Tensor:
    """The max over every rank of a local tensor's max (0-d, in place)."""
    m = x.max().reshape(1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return m[0]


def _gather_cols(x: torch.Tensor, dim: int, lay: _Layout) -> torch.Tensor:
    """Every rank's shard of a column-split tensor, concatenated along
    ``dim`` in rank order on every rank: one broadcast per rank, so the
    bits are the owner's."""
    parts = []
    for r in range(lay.P):
        buf = x.contiguous() if r == lay.index else torch.empty_like(
            x, memory_format=torch.contiguous_format)
        dist.broadcast(buf, src=lay.ranks[r])
        parts.append(buf)
    return torch.cat(parts, dim)


def _exchange_top(vals: torch.Tensor, idx: torch.Tensor, lay: _Layout):
    """The paper's ``MPI_Allreduce(MAXLOC)`` for p winners: the local
    top-p ``(vals, idx)`` (idx local) of every rank in one
    ``all_reduce(SUM)`` of a (P p, 2) float64 buffer, rank r filling rows
    ``[r p, (r+1) p)``.  Returns the global ``(vals, idx)`` buffer columns
    in rank order (values in float64, global indices as float64)."""
    p = vals.shape[0]
    buf = torch.zeros((lay.P * p, 2), dtype=torch.float64,
                      device=vals.device)
    buf[lay.index * p:(lay.index + 1) * p] = torch.stack(
        [vals.to(torch.float64),
         (idx + lay.index * lay.m_loc).to(torch.float64)], dim=1)
    dist.all_reduce(buf)
    return buf[:, 0], buf[:, 1]


def _exchange_pivot(res_sq: torch.Tensor, lay: _Layout):
    """Global pivot of one step: the local argmax, exchanged.

    Returns ``(err_sq, j, j_loc, owner)``: the global max residual^2 (in
    ``res_sq``'s dtype), its global column (int64), this rank's local
    argmax and whether this rank owns the winner (0-d device tensors;
    nothing syncs but the collective itself).  Ties go to the first index,
    as the serial driver's ``max(dim=0)``: rank r's columns precede rank
    r+1's, and the argmax over the rows takes the first maximal row."""
    val, j_loc = res_sq.max(dim=0)
    vals, idxs = _exchange_top(val.view(1), j_loc.view(1), lay)
    best, win = vals.max(dim=0)
    j = idxs.index_select(0, win.view(1)).squeeze(0).to(torch.int64)
    return best.to(res_sq.dtype), j, j_loc, win == lay.index


def _fetch_columns(S_loc: torch.Tensor, idx_loc: torch.Tensor,
                   owned: torch.Tensor) -> torch.Tensor:
    """The pivot columns on every rank: one ``all_reduce(SUM)`` of the
    owner-masked (N, p) panel (the owner's bits; a -0.0 becomes +0.0, as
    in the reference's psum)."""
    cols = S_loc.index_select(1, idx_loc)
    V = torch.where(owned.unsqueeze(0), cols, torch.zeros_like(cols))
    dist.all_reduce(V)
    return V


# ----------------------------------------------------------- stepwise ----


def _local_step(S_loc, state: DistGreedyState, active, lay, kappa,
                max_passes, backend):
    """One masked SPMD iteration on this rank; returns ``(state, err)``.
    Where ``active`` is false nothing is written and the kernels read
    neither Q nor S, but the collectives run all the same."""
    res_sq = torch.clamp(state.norms_sq - state.acc, min=0.0)
    err_sq, j, j_loc, owner = _exchange_pivot(res_sq, lay)
    err = torch.sqrt(err_sq)
    v = _fetch_columns(S_loc, j_loc.view(1), owner.view(1)).squeeze(1)
    q, _, _, _ = imgs_orthogonalize(v, state.Q, kappa, max_passes,
                                    backend=backend, active=active)
    c, acc, _, _ = _backend.pivot_update(q, S_loc, state.acc, state.norms_sq,
                                         backend=backend, active=active)
    kk = state.k.view(1)
    _put(state.Q, 1, kk, q.unsqueeze(1), active)
    _put(state.R, 0, kk, c.unsqueeze(0), active)
    state.acc.copy_(torch.where(active, acc, state.acc))
    _put(state.pivots, 0, kk, j.to(torch.int32).view(1), active)
    _put(state.errs, 0, kk, err.view(1), active)
    return state._replace(k=state.k + active.to(state.k.dtype)), err


def make_dist_greedy_step(mesh, M: int, kappa: float = 2.0,
                          max_passes: int = 3, backend: str | None = None):
    """The SPMD greedy step for a mesh over M columns: ``step(S_loc,
    state)`` adds one basis vector in place and returns the state with
    ``k + 1``."""
    lay = _layout(mesh, M)
    backend = _backend.resolve_backend(backend)

    def step(S_loc, state):
        active = torch.ones((), dtype=torch.bool, device=S_loc.device)
        return _local_step(S_loc, state, active, lay, kappa, max_passes,
                           backend)[0]

    return step


def _dist_chunk(S_loc, state, n_steps, tau, scale, ref_sq, refresh_safety,
                lay, kappa, max_passes, backend, check_refresh):
    eps = torch.finfo(state.norms_sq.dtype).eps
    stop = torch.full((), STOP_NONE, dtype=torch.int32, device=S_loc.device)
    none = torch.full_like(stop, STOP_NONE)
    n_done = torch.zeros((), dtype=torch.int32, device=S_loc.device)
    for _ in range(n_steps):
        active = stop == STOP_NONE
        state, err = _local_step(S_loc, state, active, lay, kappa,
                                 max_passes, backend)
        n_done = n_done + active.to(n_done.dtype)
        refresh_hit = (err * err < refresh_safety * eps * ref_sq) \
            if check_refresh else torch.zeros_like(active)
        code = torch.where(
            err < tau, STOP_TAU,
            torch.where(err < 50.0 * eps * scale, STOP_RANK,
                        torch.where(refresh_hit, STOP_REFRESH, none)))
        stop = torch.where(active, code.to(stop.dtype), stop)
    return state, n_done, stop


def make_dist_greedy_chunk(mesh, M: int, chunk: int, kappa: float = 2.0,
                           max_passes: int = 3, backend: str | None = None,
                           check_refresh: bool = True):
    """The device-resident chunk for a mesh over M columns.

    ``chunk_fn(S_loc, state, tau, scale, ref_sq, refresh_safety,
    n_steps=chunk)`` runs ``n_steps`` masked SPMD iterations with the stop
    code latched on the device, checked in the reference's distributed
    order (tau, then the rank guard on the error, then the refresh
    trigger), and returns ``(state, n_done, stop)`` as 0-d device tensors:
    the host syncs two scalars per chunk.
    """
    lay = _layout(mesh, M)
    backend = _backend.resolve_backend(backend)

    def chunk_fn(S_loc, state, tau, scale, ref_sq, refresh_safety,
                 n_steps=chunk):
        return _dist_chunk(S_loc, state, n_steps, tau, scale, ref_sq,
                           refresh_safety, lay, kappa, max_passes, backend,
                           check_refresh)

    return chunk_fn


# ------------------------------------------------- blocked (BLAS-3) sweep --


def _dist_block_chunk(S_loc, state, n_blocks, tau, scale, ref_sq,
                      refresh_safety, lay, p, kappa, max_passes, backend,
                      check_refresh, panel):
    """Up to ``n_blocks`` masked BLOCKED SPMD iterations.

    One iteration: the local top-p, the exchange and the global top-p of
    the P p candidates (the serial driver's stable order: ties by column),
    the p columns fetched with one (N, p) all_reduce, the joint
    orthogonalization replicated on every rank, ONE fused panel sweep of
    the local shard, and the post-block residual's all_reduce(MAX).  The
    stop codes and their precedence are the serial blocked chunk's: a
    block whose leading residual is below tau is not added (STOP_TAU);
    else every candidate rejected (STOP_RANK), the post-block residual
    below tau (STOP_TAU), the refresh trigger (STOP_REFRESH).
    """
    from repro_torch.core.block_greedy import _add_block, _thresh, top_p

    eps = torch.finfo(state.norms_sq.dtype).eps
    rdt = state.norms_sq.dtype
    thresh = _thresh(state, scale)
    stop = torch.full((), STOP_NONE, dtype=torch.int32, device=S_loc.device)
    none = torch.full_like(stop, STOP_NONE)
    n_done = torch.zeros((), dtype=torch.int32, device=S_loc.device)
    for _ in range(n_blocks):
        active = stop == STOP_NONE
        res_sq = torch.clamp(state.norms_sq - state.acc, min=0.0)
        l_vals, l_idx = top_p(res_sq, p)
        vals, idxs = _exchange_top(l_vals, l_idx, lay)
        top_vals, top_pos = top_p(vals, p)
        top_vals = top_vals.to(rdt)
        top_idx = idxs.index_select(0, top_pos).to(torch.int64)
        go = torch.sqrt(top_vals[0]) >= tau
        owned = (top_idx // lay.m_loc == lay.index) & go
        V = _fetch_columns(S_loc, top_idx % lay.m_loc, owned)
        live = active & go
        _, oks, _, _ = _add_block(S_loc, state, top_vals, top_idx, live, p,
                                  kappa, max_passes, thresh, backend, panel,
                                  V=V)
        state = state._replace(k=state.k + p * live.to(state.k.dtype))
        n_done = n_done + active.to(n_done.dtype)
        res_after = torch.clamp(_global_max(state.norms_sq - state.acc),
                                min=0.0)
        refresh_hit = (res_after < refresh_safety * eps * ref_sq) \
            if check_refresh else torch.zeros_like(active)
        code = torch.where(
            oks.sum() == 0, STOP_RANK,
            torch.where(res_after < tau * tau, STOP_TAU,
                        torch.where(refresh_hit, STOP_REFRESH, none)))
        code = torch.where(go, code.to(stop.dtype), STOP_TAU)
        stop = torch.where(active, code.to(stop.dtype), stop)
    return state, n_done, stop


def make_dist_block_greedy_chunk(mesh, M: int, chunk: int, p: int,
                                 kappa: float = 2.0, max_passes: int = 3,
                                 backend: str | None = None,
                                 check_refresh: bool = True,
                                 panel: bool = True):
    """The device-resident BLOCKED chunk for a mesh over M columns:
    ``chunk_fn(S_loc, state, tau, scale, ref_sq, refresh_safety,
    n_blocks=chunk)`` runs up to ``n_blocks`` blocked SPMD iterations (p
    bases per read of the shard) and returns ``(state, n_done, stop)``."""
    lay = _layout(mesh, M)
    backend = _backend.resolve_backend(backend)

    def chunk_fn(S_loc, state, tau, scale, ref_sq, refresh_safety,
                 n_blocks=chunk):
        return _dist_block_chunk(S_loc, state, n_blocks, tau, scale, ref_sq,
                                 refresh_safety, lay, p, kappa, max_passes,
                                 backend, check_refresh, panel)

    return chunk_fn


# --------------------------------------------- checkpoint/resume support ---
# The reference's distributed tree (keys, dtypes, version): rank 0 writes
# it with the column-split leaves gathered in full, and every rank slices
# its own columns of it for the CURRENT mesh on resume (elastic).

_DIST_STATE_VERSION = 1


def _gather_cols_to_writer(x: torch.Tensor, dim: int, lay: _Layout,
                           writer: bool):
    """Every rank's shard of a column-split tensor, concatenated along
    ``dim`` in rank order, on the writer's host (None on the other ranks):
    one broadcast per rank, every rank receiving into one scratch shard;
    the writer copies each shard to the host as it arrives, the others
    keep nothing."""
    x = x.contiguous()
    scratch = torch.empty_like(x)
    parts = []
    for r in range(lay.P):
        buf = x if r == lay.index else scratch
        dist.broadcast(buf, src=lay.ranks[r])
        if writer:
            parts.append(buf.to("cpu", copy=True).numpy())
    return np.concatenate(parts, axis=dim) if writer else None


def _dist_state_tree(state: DistGreedyState, ref_sq: float, scale: float,
                     done: bool, stop: int, lay: _Layout, writer: bool):
    """The full tree on the writer, None on the other ranks (a
    collective: every rank calls it)."""
    k = int(state.k)
    R = _gather_cols_to_writer(state.R[:k], 1, lay, writer)
    norms_sq = _gather_cols_to_writer(state.norms_sq, 0, lay, writer)
    acc = _gather_cols_to_writer(state.acc, 0, lay, writer)
    if not writer:
        return None

    def host(t):
        return t.detach().cpu().numpy()

    return {
        "version": np.asarray(_DIST_STATE_VERSION, np.int64),
        "Q": host(state.Q),
        "R": R,
        "norms_sq": norms_sq,
        "acc": acc,
        "pivots": host(state.pivots),
        "errs": host(state.errs),
        "k": np.asarray(k, np.int64),
        "ref_sq": np.asarray(ref_sq, np.float64),
        "scale": np.asarray(scale, np.float64),
        "done": np.asarray(int(done), np.int64),
        "stop": np.asarray(int(stop), np.int64),
    }


def _dist_state_from_tree(tree: dict, lay: _Layout, device):
    """This rank's state from a full tree, sliced for the current mesh;
    returns ``(state, ref_sq, scale, done, stop)``."""
    from repro_torch.data.providers import to_device

    version = int(tree["version"])
    if version != _DIST_STATE_VERSION:
        raise ValueError(
            f"distributed checkpoint version {version} != supported "
            f"{_DIST_STATE_VERSION}")
    lo, hi = lay.cols
    max_k = tree["Q"].shape[1]
    R = np.zeros((max_k, hi - lo), tree["R"].dtype)
    R[:tree["R"].shape[0]] = tree["R"][:, lo:hi]

    def dev_t(a):
        return to_device(a, device)

    state = DistGreedyState(
        Q=dev_t(tree["Q"]), R=dev_t(R),
        norms_sq=dev_t(tree["norms_sq"][lo:hi]),
        acc=dev_t(tree["acc"][lo:hi]), pivots=dev_t(tree["pivots"]),
        errs=dev_t(tree["errs"]),
        k=torch.tensor(int(tree["k"]), dtype=torch.int64, device=device),
    )
    return (state, float(tree["ref_sq"]), float(tree["scale"]),
            bool(int(tree["done"])), int(tree["stop"]))


def _save_dist_checkpoint(directory: str, seq: int, state, ref_sq, scale,
                          done: bool, stop: int, lay: _Layout,
                          keep: int = 2) -> int:
    """Gather the tree to the mesh's rank 0 (every rank takes part in the
    broadcasts), write it there, and wait for the write; returns the new
    sequence number."""
    from repro_torch.checkpoint.io import prune_steps, save_checkpoint

    writer = lay.index == 0
    tree = _dist_state_tree(state, ref_sq, scale, done, stop, lay, writer)
    seq += 1
    if writer:
        save_checkpoint(tree, directory, seq)
        prune_steps(directory, keep)
    _barrier(state.Q.device)
    return seq


def _resume(checkpoint_dir, resume, lay, N, M, slots, dtype, device):
    """``(restored, seq)``: the restored ``(state, ref_sq, scale, done,
    stop)`` or None, and the step sequence to continue.  Every rank reads
    the directory before its first collective, so before rank 0 can
    write to it."""
    from repro_torch.checkpoint.io import latest_step

    restored = None
    tree = load_resident_checkpoint(checkpoint_dir) if resume else None
    if tree is not None:
        _validate_resident_tree(tree, N, M, slots, dtype,
                                "resume checkpoint")
        restored = _dist_state_from_tree(tree, lay, device)
    return restored, latest_step(checkpoint_dir) or 0


def _setup(S, mesh, device):
    """This rank's columns of the source, materialized on ``device`` alone
    (a tensor already there that is the whole shard is not copied), with
    the source's shape, the rank's layout and the device."""
    from repro_torch.data.providers import as_provider

    dev = resolve_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh's ranks keep {mesh.device_type} "
                         f"tensors, the build runs on {dev}")
    prov = as_provider(S, dev)
    if prov.device != dev:
        raise ValueError(f"provider places tiles on {prov.device}, "
                         f"requested {dev}")
    N, M = prov.shape
    lay = _layout(mesh, M)
    return prov.tile(*lay.cols), N, M, lay, dev


def distributed_greedy(
    S,
    tau: float,
    max_k: int,
    mesh,
    callback=None,
    refresh: str = "auto",
    refresh_safety: float = 100.0,
    kappa: float = 2.0,
    max_passes: int = 3,
    chunk: int = 16,
    backend: str | None = None,
    block_p: int = 1,
    panel_ortho: bool = True,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    device=None,
) -> GreedyResult:
    """Driver mirroring :func:`repro_torch.core.greedy.rb_greedy` on a
    mesh; every rank of the mesh calls it, with the same arguments.

    ``mesh`` is a :class:`torch.distributed.device_mesh.DeviceMesh` over
    every rank of the process group
    (:func:`repro_torch.compat.make_auto_mesh`); the columns are split
    over all its dimensions, row-major, and M must divide by its rank
    count.  ``S`` may be anything
    :func:`repro_torch.data.providers.as_provider` accepts: rank r
    materializes only its own columns ``[r M/P, (r+1) M/P)`` on ``device``
    (``cuda`` unless asked; the mesh's device type), never the whole
    source.

    Chunked: ``chunk`` masked SPMD iterations per host sync, the stop rules
    the reference's distributed ones (module docstring).
    ``callback(state)`` fires once per chunk with a copy of this rank's
    :class:`DistGreedyState`.

    ``block_p > 1`` runs the BLOCKED sweep: the global top-p pivots of a
    block, one fused panel sweep of each shard per p bases
    (:mod:`repro_torch.core.block_greedy`'s trade-off; rank-rejected
    candidates are compacted away, so ``k`` counts accepted bases).
    ``panel_ortho`` orthogonalizes each block through the BLAS-3 panel
    path.

    ``checkpoint_dir``/``resume`` mirror :func:`rb_greedy`: rank 0 writes
    the reference's tree after each chunk's stop handling; on resume each
    rank slices it for this mesh, so a run restores onto another rank
    count.

    Returns the same :class:`GreedyResult` on every rank: Q replicated, R
    gathered in full (M columns), and, as in the reference, zero
    ``n_ortho_passes``/``rnorms`` (the state keeps no diagnostics).
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if block_p < 1:
        raise ValueError(f"block_p must be >= 1, got {block_p}")
    S_loc, N, M, lay, dev = _setup(S, mesh, device)
    if block_p > 1:
        return _distributed_block_greedy(
            S_loc, N, M, lay, tau, max_k, mesh, block_p, callback=callback,
            refresh=refresh, refresh_safety=refresh_safety, kappa=kappa,
            max_passes=max_passes, chunk=chunk, backend=backend,
            panel=panel_ortho, checkpoint_dir=checkpoint_dir, resume=resume)

    max_k = min(max_k, N, M)
    chunk_fn = make_dist_greedy_chunk(mesh, M, chunk, kappa, max_passes,
                                      backend, check_refresh=(
                                          refresh == "auto"))
    restored, seq = (None, 0) if checkpoint_dir is None else _resume(
        checkpoint_dir, resume, lay, N, M, max_k, S_loc.dtype, dev)
    state = dist_greedy_init(S_loc, max_k)
    rdt = state.norms_sq.dtype
    eps = torch.finfo(rdt).eps
    ref_sq = float(_global_max(state.norms_sq))
    scale = ref_sq ** 0.5
    done = False
    final_stop = STOP_NONE
    if restored is not None:
        state, ref_sq, scale, done, final_stop = restored

    def dev_scalar(x):
        return torch.tensor(x, dtype=rdt, device=dev)

    tau_d, scale_d = dev_scalar(tau), dev_scalar(scale)
    safety_d, ref_sq_d = dev_scalar(refresh_safety), dev_scalar(ref_sq)
    k = int(state.k)
    while not done and k < max_k:
        state, _, stop = chunk_fn(S_loc, state, tau_d, scale_d, ref_sq_d,
                                  safety_d, n_steps=min(chunk, max_k - k))
        k, stop = torch.stack([state.k, stop.to(torch.int64)]).tolist()
        if callback is not None:
            callback(_clone(state))
        if stop == STOP_TAU:
            # selected at an error already below tau: drop it
            k -= 1
            state.Q[:, k] = 0
            state.pivots[k] = -1
            state = state._replace(k=torch.full_like(state.k, k))
            done, final_stop = True, STOP_TAU
        elif stop == STOP_RANK:
            k -= 1
            state = state._replace(k=torch.full_like(state.k, k))
            done, final_stop = True, STOP_RANK
        elif stop == STOP_REFRESH:
            # the refresh is column-local: each rank recomputes its shard's
            state = greedy_refresh(S_loc, state)
            ref_sq = max(float(_global_max(state.norms_sq)), 1e-300)
            ref_sq_d = dev_scalar(ref_sq)
            if ref_sq ** 0.5 < tau:
                done, final_stop = True, STOP_TAU
            elif ref_sq ** 0.5 <= floor_estimate(eps, scale, k):
                done, final_stop = True, STOP_FLOOR
        if not done and k >= max_k:
            done = True  # ran to capacity; final_stop stays STOP_NONE
        if checkpoint_dir is not None:
            seq = _save_dist_checkpoint(checkpoint_dir, seq, state, ref_sq,
                                        scale, done, final_stop, lay)
    return GreedyResult(
        Q=state.Q, R=_gather_cols(state.R, 1, lay), pivots=state.pivots,
        errs=state.errs, k=int(state.k),
        n_ortho_passes=torch.zeros_like(state.pivots),
        rnorms=torch.zeros_like(state.errs), stop=final_stop,
    )


def _distributed_block_greedy(
    S_loc,
    N: int,
    M: int,
    lay: _Layout,
    tau: float,
    max_k: int,
    mesh,
    p: int,
    callback=None,
    refresh: str = "auto",
    refresh_safety: float = 100.0,
    kappa: float = 2.0,
    max_passes: int = 3,
    chunk: int = 4,
    backend: str | None = None,
    panel: bool = True,
    checkpoint_dir: str | None = None,
    resume: bool = False,
) -> GreedyResult:
    """Blocked distributed driver body (:func:`distributed_greedy`,
    ``block_p > 1``); ``chunk`` counts BLOCKS per host sync."""
    from repro_torch.core.block_greedy import _compact_result

    p = min(p, min(N, M))
    if p > lay.m_loc:
        raise ValueError(
            f"block_p={p} exceeds the per-rank column count {lay.m_loc} "
            f"(M={M} over {lay.P} ranks): the local top-p selection needs "
            f"p candidates per shard")
    max_k = min(max_k, N, M)  # the accepted-basis cap
    max_slots = min(max_k + p, min(N, M) + p)  # + hole headroom
    dev = S_loc.device
    chunk_fn = make_dist_block_greedy_chunk(
        mesh, M, chunk, p, kappa, max_passes, backend,
        check_refresh=(refresh == "auto"), panel=panel)
    restored, seq = (None, 0) if checkpoint_dir is None else _resume(
        checkpoint_dir, resume, lay, N, M, max_slots, S_loc.dtype, dev)
    state = dist_greedy_init(S_loc, max_slots)
    rdt = state.norms_sq.dtype
    eps = torch.finfo(rdt).eps
    ref_sq = float(_global_max(state.norms_sq))
    scale = ref_sq ** 0.5  # fixed global column scale for the rank guard
    done = False
    final_stop = STOP_NONE
    if restored is not None:
        state, ref_sq, scale, done, final_stop = restored

    def dev_scalar(x):
        return torch.tensor(x, dtype=rdt, device=dev)

    tau_d, scale_d = dev_scalar(tau), dev_scalar(scale)
    safety_d, ref_sq_d = dev_scalar(refresh_safety), dev_scalar(ref_sq)
    k = int(state.k)
    while not done and k + p <= max_slots:
        state, _, stop = chunk_fn(S_loc, state, tau_d, scale_d, ref_sq_d,
                                  safety_d,
                                  n_blocks=min(chunk, (max_slots - k) // p))
        k, stop = torch.stack([state.k, stop.to(torch.int64)]).tolist()
        if callback is not None:
            callback(_clone(state))
        if stop == STOP_TAU or stop == STOP_RANK:
            done, final_stop = True, stop
        elif stop == STOP_REFRESH:
            # the refresh is column-local: each rank recomputes its shard's
            state = greedy_refresh(S_loc, state)
            ref_sq = max(float(_global_max(state.norms_sq)), 1e-300)
            ref_sq_d = dev_scalar(ref_sq)
            if ref_sq ** 0.5 < tau:
                done, final_stop = True, STOP_TAU
            elif ref_sq ** 0.5 <= floor_estimate(eps, scale, k):
                done, final_stop = True, STOP_FLOOR
        if not done and k + p > max_slots:
            done = True  # out of slots; final_stop stays STOP_NONE
        if checkpoint_dir is not None:
            seq = _save_dist_checkpoint(checkpoint_dir, seq, state, ref_sq,
                                        scale, done, final_stop, lay)
    # compact the holes, capped at max_k: the resident blocked driver's;
    # the distributed state keeps no per-basis diagnostics (zero, as the
    # greedy driver's result)
    full = GreedyState(
        Q=state.Q, R=_gather_cols(state.R, 1, lay), norms_sq=state.norms_sq,
        acc=state.acc, pivots=state.pivots, errs=state.errs,
        n_passes=torch.zeros_like(state.pivots),
        rnorms=torch.zeros_like(state.errs), k=state.k)
    return _compact_result(full, max_k, final_stop)


def is_writer(mesh) -> bool:
    """Whether this rank writes what the mesh's build writes once (rank
    0 of the mesh)."""
    return _axis_index(mesh) == 0


def barrier(mesh) -> None:
    """Wait until every rank of the mesh is here."""
    _barrier(torch.device(mesh.device_type, torch.cuda.current_device())
             if mesh.device_type == "cuda" else torch.device("cpu"))
