"""Out-of-core tile-streamed RB-greedy over snapshot providers.

PyTorch port of :mod:`repro.core.streaming`.  :func:`rb_greedy_streamed`
is an exact refactor of the resident drivers for snapshot matrices that do
not fit on the card (the paper's dense complex 10,000 x 3,276,800 matrix,
262 GB at complex64).  Each iteration sweeps column tiles of S through the
same hot primitives as the resident drivers:

  per tile      the Eq.-(6.3) sweep (:func:`repro_torch.core.backend.
                pivot_update`): ``c_t = q^H S_t``, ``acc_t + |c_t|^2`` and
                the tile's residual (max, first argmax), in one pass,
  across tiles  a running (value, column) max-loc fold, on the device —
                the single-machine analogue of the paper's
                ``MPI_Allreduce(MAXLOC)`` (Sec. 6.1.3),
  per pivot     :func:`repro_torch.core.greedy.imgs_orthogonalize` against
                the device-resident basis Q.

``block_p > 1`` is the blocked mode (the streamed sibling of
:mod:`repro_torch.core.block_greedy`): a panel of p pending vectors goes
through :func:`repro_torch.core.backend.block_sweep` per tile and a top-p
candidate list is folded across tiles, so every tile serves p bases, at
the resident blocked driver's price of pivot staleness.

What stays where.  On the device: Q (N x max_k), the pending panel, the
residual caches ``norms_sq`` and ``acc`` (M reals each), the candidate
folds, and the tiles in flight (the current one and the prefetched next
one).  On the host: the R factor (pinned, filled by non-blocking copies of
each tile's rows) and the per-basis scalars.  The host reads the fold once
per pivot block and the GS diagnostics once per block: no host sync per
tile.  Peak device memory is O(N * (max_k + block_p + 2 * tile_m) + M).

Bits.  A column's norm, sweep coefficient and refresh residual do not
depend on the tile that holds it: the column norms are summed in a fixed
order (:func:`repro_torch.sums.column_norms_sq`), the sweep kernels
give each column its own fixed-order sum, and the refresh forms its
products in the resident refresh's 8192-column chunks (for ``tile_m`` a
multiple of 8192).  The stop tests are the resident chunked drivers',
evaluated in the residual dtype.  So at ``block_p = 1`` the build has the
pivots, Q and errs of :func:`repro_torch.core.greedy.rb_greedy` on the
materialized S, and at ``block_p > 1`` those of the resident blocked
driver (the tests hold both bitwise on the CPU; ``chip_smoke.py`` on the
card).

Mid-build checkpoints persist the whole streaming state — tile cursor,
pending panel, residual caches — in the reference's v2 tree, through
:mod:`repro_torch.checkpoint.io`: a killed build resumes from the last
completed tile, bitwise.  A checkpoint that the JAX package wrote resumes
here too, under its backend's counterpart (``xla`` and ``pallas`` ->
``auto``, ``xla_ref`` -> ``ref``).
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import backend as _backend
from repro_torch.core.block_greedy import top_p
from repro_torch.core.errors import COL_CHUNK, project_chunk
from repro_torch.core.greedy import (
    STOP_FLOOR,
    STOP_NONE,
    STOP_RANK,
    STOP_TAU,
    _column_norms_sq,
    floor_estimate,
    imgs_orthogonalize,
    panel_imgs_orthogonalize,
)
from repro_torch.data.providers import SnapshotProvider, as_provider
from repro_torch.device import numpy_dtype, resolve_device

# v2: blocked streaming — the scalar pending/max-loc fields of v1 became
# width-block_p arrays and block_p joined the tiling invariants.  v1
# (stepwise) checkpoints are lifted on load (_StreamState._lift_v1).
_STATE_VERSION = 2

# The port's counterpart of each backend the JAX package writes into its
# checkpoints (repro_torch.core.backend: ``ref`` is the literal plain ops,
# as the reference's ``xla_ref``).
_BACKEND_COUNTERPART = {"xla": "auto", "pallas": "auto", "xla_ref": "ref"}


class StreamedGreedyResult(NamedTuple):
    """Result of the streamed greedy build (field names match
    :class:`repro_torch.core.greedy.GreedyResult`).

    Attributes:
      Q:      (N, max_k) orthonormal basis on the provider's device;
              columns >= k zero.
      R:      (max_k, M) host tensor ``R[j] = q_j^H S`` in original column
              order (pinned when the build ran on the card), or ``None``
              with ``keep_R=False``: R is the one result piece that scales
              with M.
      pivots: (max_k,) int32 host tensor; entries >= k are -1.
      errs:   (max_k,) greedy error before adding basis j (real dtype).
      k:      number of accepted bases.
      n_ortho_passes, rnorms: per-basis iterated-GS diagnostics.
      tile_m: tile width of the build; n_tiles: ceil(M / tile_m).
      block_p: pivots per sweep (1 = stepwise streaming).
      stop:   why the build terminated (a STOP_* code).
    """

    Q: torch.Tensor
    R: Optional[torch.Tensor]
    pivots: torch.Tensor
    errs: torch.Tensor
    k: int
    n_ortho_passes: torch.Tensor
    rnorms: torch.Tensor
    tile_m: int
    n_tiles: int
    block_p: int = 1
    stop: int = 0


# ------------------------------------------------------------ tile helpers --
def _top(vals: torch.Tensor, kt: int):
    """The ``kt`` largest values and their first indices, largest first,
    equal values in increasing index order (``block_greedy.top_p``; never
    ``torch.topk``, whose order of ties is not promised)."""
    if kt == 1:
        v, i = vals.max(dim=0)
        return v.view(1), i.view(1)
    return top_p(vals, kt)


def _tile_init(T: torch.Tensor, kt: int = 1):
    """Column norms^2 of one tile and the tile's top-kt (values, cols): the
    init pass's share of the first block's candidate fold."""
    n = _column_norms_sq(T)
    tv, ti = _top(n, kt)
    return n, tv, ti


def _tile_sweep(q, T, acc_t, norms_t, backend: str):
    """One tile's Eq.-(6.3) sweep through the fused primitive (the
    ``block_p = 1`` hot path)."""
    return _backend.pivot_update(q, T, acc_t, norms_t, backend=backend)


def _tile_block_sweep(P, T, acc_t, norms_t, kt: int, backend: str):
    """One tile's blocked panel sweep and the tile's top-kt residual
    candidates."""
    C, acc_out = _backend.block_sweep(P, T, acc_t, backend=backend)
    tv, ti = _top(norms_t - acc_out, kt)
    return C, acc_out, tv, ti


def _tile_project(Q: torch.Tensor, T: torch.Tensor):
    """``C = Q^H T`` and the exact residual norms^2 of ``T - Q C``, in the
    resident refresh's column chunks (:func:`repro_torch.core.errors.
    project_chunk`), so a column's products are those of the resident
    refresh when the tile starts on a chunk boundary."""
    Cs, res = [], []
    for lo in range(0, T.shape[1], COL_CHUNK):
        C, r = project_chunk(T[:, lo:lo + COL_CHUNK], Q)
        Cs.append(C)
        res.append(r)
    return torch.cat(Cs, dim=1), torch.cat(res)


def _tile_refresh(Q: torch.Tensor, T: torch.Tensor, kt: int = 1):
    """Exact residual^2 of one tile against Q (zero columns are no-ops):
    the tile-local form of ``greedy_refresh``, plus the tile's top-kt."""
    _, res = _tile_project(Q, T)
    tv, ti = _top(res, kt)
    return res, tv, ti


def _commit_panel(Q: torch.Tensor, P: torch.Tensor, slots: int) -> None:
    """Write the pending panel's columns into the basis at ``slots``, in
    place."""
    Q[:, slots:slots + P.shape[1]] = P


def _merge_topk(vals, cols, new_vals, new_cols, p: int):
    """Fold a tile's top-k candidates into the running top-p, on the
    device.

    Exact value ties keep the EARLIEST column: the running list holds
    earlier columns than the tile's and comes first, and each list is
    ordered by (-value, column), so a stable descending sort keeps that
    order (at p = 1, a strict ``>`` — the scalar MAXLOC).
    """
    if p == 1:
        take = new_vals > vals
        return torch.where(take, new_vals, vals), torch.where(
            take, new_cols, cols)
    v = torch.cat([vals, new_vals])
    c = torch.cat([cols, new_cols])
    _, order = top_p(v, p)
    return v[order], c[order]


def _host_fold(vals: torch.Tensor, cols: torch.Tensor):
    """The fold on the host, one read: its values and their errors
    ``sqrt(max(value, 0))`` in the residual dtype (the square root taken on
    the device, as the resident drivers take it: the CPU's ``torch.sqrt``
    and numpy's round some values to different neighbours), and its
    columns."""
    errs = torch.sqrt(torch.clamp(vals, min=0.0))
    both = torch.cat([vals.to(torch.float64), errs.to(torch.float64),
                      cols.to(torch.float64)]).cpu().numpy()
    p, rdt = vals.numel(), numpy_dtype(vals.dtype)
    return (both[:p].astype(rdt), both[p:2 * p].astype(rdt),
            both[2 * p:].astype(np.int64))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _host_rows(shape, dtype: torch.dtype, device: torch.device
               ) -> torch.Tensor:
    """Zeroed host rows for R: pinned when the build runs on the card, so
    each tile's rows are copied without blocking."""
    return torch.zeros(shape, dtype=dtype,
                       pin_memory=device.type == "cuda")


def _put_rows(R: Optional[torch.Tensor], row: int, lo: int, hi: int,
              C: torch.Tensor) -> None:
    """``R[row:row + p, lo:hi] = C`` row by row (each a contiguous copy,
    non-blocking into pinned memory)."""
    if R is None:
        return
    for i in range(C.shape[0]):
        R[row + i, lo:hi].copy_(C[i], non_blocking=True)


class _Tiles:
    """The provider's tiles in order, each next one requested as soon as
    the current one is handed out, so a host provider's copy of tile i + 1
    overlaps the device's work on tile i (two tiles in flight)."""

    def __init__(self, prov: SnapshotProvider, tiles, start: int = 0):
        self.prov, self.tiles, self.i = prov, tiles, start
        self.nxt = prov.tile(*tiles[start]) if start < len(tiles) else None

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= len(self.tiles):
            raise StopIteration
        i, T, self.nxt = self.i, self.nxt, None
        self.i += 1
        return i, self.tiles[i], T

    def prefetch(self) -> None:
        """Request the next tile: call after queueing the current tile's
        work."""
        if self.i < len(self.tiles):
            self.nxt = self.prov.tile(*self.tiles[self.i])


# ------------------------------------------------------------------ state --
class _StreamState:
    """Streaming state: everything needed to resume mid-build.

    ``pending == 1`` means a block of pivots has been selected and
    orthogonalized but its Eq.-(6.3) sweep has covered only tiles
    [0, cursor); resume continues the sweep (acc and R of the swept tiles
    are already updated, and the sweep is deterministic given acc, so the
    remaining tiles reproduce the uninterrupted build exactly).

    ``k`` counts occupied SLOTS (blocked builds can leave rank-rejected
    zero "hole" columns in a block); ``n_acc`` counts accepted bases.  At
    ``block_p == 1`` the two agree.  Device tensors: Q, norms_sq, acc,
    pending_Q and the folds (best_*, sweep_*, in the residual dtype / int64).
    Host: R and the per-slot numpy arrays.
    """

    __slots__ = (
        "Q", "R", "norms_sq", "acc", "pivots", "errs", "rnorms", "n_passes",
        "k", "n_acc", "ref_sq", "scale", "best_vals", "best_cols",
        "pending", "cursor", "pending_Q", "pending_cols", "pending_errs",
        "pending_rnorms", "pending_npass", "pending_ok", "sweep_vals",
        "sweep_cols", "seq", "tile_m", "block_p", "backend", "done", "stop",
    )

    def to_tree(self) -> dict:
        """Flat numpy tree in the reference's v2 layout (keys, dtypes)."""
        _sync(self.Q.device)

        def host(t):
            return t.detach().cpu().numpy()

        tree = {
            "version": np.asarray(_STATE_VERSION, np.int64),
            # cursor/pending are in tile units and the pending panel in
            # block_p units, so a resume MUST use the same tiling and block
            # width; the backend too (an in-flight acc update carries one
            # backend's summation order).
            "tile_m": np.asarray(self.tile_m, np.int64),
            "block_p": np.asarray(self.block_p, np.int64),
            "backend": np.asarray(self.backend),
            "Q": host(self.Q),
            "norms_sq": host(self.norms_sq),
            "acc": host(self.acc),
            "pivots": self.pivots,
            "errs": self.errs,
            "rnorms": self.rnorms,
            "n_passes": self.n_passes,
            "k": np.asarray(self.k, np.int64),
            "n_acc": np.asarray(self.n_acc, np.int64),
            "ref_sq": np.asarray(self.ref_sq, np.float64),
            "scale": np.asarray(self.scale, np.float64),
            "best_vals": host(self.best_vals.to(torch.float64)),
            "best_cols": host(self.best_cols),
            "pending": np.asarray(self.pending, np.int64),
            "cursor": np.asarray(self.cursor, np.int64),
            "pending_Q": host(self.pending_Q),
            "pending_cols": np.asarray(self.pending_cols, np.int64),
            "pending_errs": np.asarray(self.pending_errs, np.float64),
            "pending_rnorms": np.asarray(self.pending_rnorms, np.float64),
            "pending_npass": np.asarray(self.pending_npass, np.int64),
            "pending_ok": np.asarray(self.pending_ok, np.int64),
            "sweep_vals": host(self.sweep_vals.to(torch.float64)),
            "sweep_cols": host(self.sweep_cols),
            "seq": np.asarray(self.seq, np.int64),
            # the terminal verdict: the floor stop is not a function of the
            # fields above (its residual sits above tau), so a resume of a
            # floor-stopped build would otherwise keep adding bases
            "done": np.asarray(self.done, np.int64),
            "stop": np.asarray(self.stop, np.int64),
        }
        if self.R is not None:
            # only the rows written so far: checkpoint traffic scales with
            # k * M, not max_k * M
            tree["R"] = self.R[:self.k + self.pending * self.block_p].numpy()
        return tree

    @staticmethod
    def _lift_v1(tree: dict) -> dict:
        """Lift a v1 (stepwise-only) checkpoint to the v2 layout: the
        scalar pending/max-loc fields map 1:1 onto width-1 arrays."""
        out = dict(tree)
        out["version"] = np.asarray(_STATE_VERSION, np.int64)
        out["block_p"] = np.asarray(1, np.int64)
        out["n_acc"] = tree["k"]  # p = 1 never leaves holes
        out["best_vals"] = np.asarray([tree["best_val"]], np.float64)
        out["best_cols"] = np.asarray([tree["best_col"]], np.int64)
        out["pending_Q"] = np.asarray(tree["pending_q"])[:, None]
        out["pending_cols"] = np.asarray([tree["pending_col"]], np.int64)
        out["pending_errs"] = np.asarray([tree["pending_err"]], np.float64)
        out["pending_rnorms"] = np.asarray([tree["pending_rnorm"]],
                                           np.float64)
        out["pending_npass"] = np.asarray([tree["pending_npass"]], np.int64)
        # v1 only set `pending` after the rank guard passed
        out["pending_ok"] = np.asarray([tree["pending"]], np.int64)
        out["sweep_vals"] = np.asarray([tree["sweep_val"]], np.float64)
        out["sweep_cols"] = np.asarray([tree["sweep_col"]], np.int64)
        for old in ("best_val", "best_col", "pending_q", "pending_col",
                    "pending_err", "pending_rnorm", "sweep_val",
                    "sweep_col"):
            out.pop(old, None)
        return out

    @classmethod
    def from_tree(cls, tree: dict, device: torch.device) -> "_StreamState":
        version = int(tree["version"])
        if version == 1:
            tree = cls._lift_v1(tree)
            version = _STATE_VERSION
        if version != _STATE_VERSION:
            raise ValueError(
                f"streaming checkpoint version {version} != supported "
                f"{_STATE_VERSION}")
        from repro_torch.data.providers import to_device

        def dev(a, dtype=None):
            t = to_device(np.asarray(a), device)
            return t if dtype is None else t.to(dtype)

        st = cls()
        st.tile_m = int(tree["tile_m"])
        st.block_p = int(tree["block_p"])
        name = str(tree["backend"])
        st.backend = _BACKEND_COUNTERPART.get(name, name)
        st.Q = dev(tree["Q"])
        rdt = st.Q.dtype.to_real()
        max_k = st.Q.shape[1]
        M = tree["norms_sq"].shape[0]
        R_rows = tree.get("R")
        if R_rows is not None:
            st.R = _host_rows((max_k, M), st.Q.dtype, device)
            st.R[:R_rows.shape[0]] = torch.from_numpy(np.asarray(R_rows))
        else:
            st.R = None
        st.norms_sq = dev(tree["norms_sq"])
        st.acc = dev(tree["acc"])
        st.pivots = np.asarray(tree["pivots"])
        st.errs = np.asarray(tree["errs"])
        st.rnorms = np.asarray(tree["rnorms"])
        st.n_passes = np.asarray(tree["n_passes"])
        st.k = int(tree["k"])
        st.n_acc = int(tree["n_acc"])
        st.ref_sq = float(tree["ref_sq"])
        st.scale = float(tree["scale"])
        st.best_vals = dev(np.asarray(tree["best_vals"], np.float64), rdt)
        st.best_cols = dev(np.asarray(tree["best_cols"], np.int64))
        st.pending = int(tree["pending"])
        st.cursor = int(tree["cursor"])
        st.pending_Q = dev(tree["pending_Q"])
        st.pending_cols = np.asarray(tree["pending_cols"], np.int64)
        st.pending_errs = np.asarray(tree["pending_errs"], np.float64)
        st.pending_rnorms = np.asarray(tree["pending_rnorms"], np.float64)
        st.pending_npass = np.asarray(tree["pending_npass"], np.int64)
        st.pending_ok = np.asarray(tree["pending_ok"], np.int64)
        st.sweep_vals = dev(np.asarray(tree["sweep_vals"], np.float64), rdt)
        st.sweep_cols = dev(np.asarray(tree["sweep_cols"], np.int64))
        st.seq = int(tree["seq"])
        # checkpoints without done/stop were only written mid-build
        st.done = int(tree.get("done", 0))
        st.stop = int(tree.get("stop", STOP_NONE))
        return st


def _new_state(prov: SnapshotProvider, max_slots: int, tile_m: int, p: int,
               backend: str) -> _StreamState:
    """The fields that a fresh and a warm-started build share."""
    N, _ = prov.shape
    dev, dtype = prov.device, prov.dtype
    rdt = numpy_dtype(dtype.to_real())
    st = _StreamState()
    st.tile_m, st.block_p, st.backend = tile_m, p, backend
    st.pivots = np.full((max_slots,), -1, np.int32)
    st.errs = np.zeros((max_slots,), rdt)
    st.rnorms = np.zeros((max_slots,), rdt)
    st.n_passes = np.zeros((max_slots,), np.int32)
    st.pending, st.cursor = 0, 0
    st.pending_Q = torch.zeros((N, p), dtype=dtype, device=dev)
    _clear_pending(st, p)
    st.seq, st.done, st.stop = 0, 0, STOP_NONE
    return st


def _clear_pending(st: _StreamState, p: int) -> None:
    dev, rdt = st.pending_Q.device, st.pending_Q.dtype.to_real()
    st.pending_cols = np.full((p,), -1, np.int64)
    st.pending_errs = np.zeros((p,), np.float64)
    st.pending_rnorms = np.zeros((p,), np.float64)
    st.pending_npass = np.zeros((p,), np.int64)
    st.pending_ok = np.zeros((p,), np.int64)
    st.sweep_vals, st.sweep_cols = _empty_fold(p, rdt, dev)


def _empty_fold(p: int, rdt: torch.dtype, dev: torch.device):
    return (torch.full((p,), -math.inf, dtype=rdt, device=dev),
            torch.full((p,), -1, dtype=torch.int64, device=dev))


def _fresh_state(prov: SnapshotProvider, max_slots: int, tiles, tile_m: int,
                 p: int, keep_R: bool, backend: str) -> _StreamState:
    """Init pass: stream every tile once for the column norms^2 and the
    first top-p."""
    N, M = prov.shape
    dev, dtype = prov.device, prov.dtype
    rdt = dtype.to_real()
    st = _new_state(prov, max_slots, tile_m, p, backend)
    st.norms_sq = torch.empty((M,), dtype=rdt, device=dev)
    best_v, best_c = _empty_fold(p, rdt, dev)
    stream = _Tiles(prov, tiles)
    for _, (lo, hi), T in stream:
        n, tv, ti = _tile_init(T, min(p, hi - lo))
        stream.prefetch()
        st.norms_sq[lo:hi] = n
        best_v, best_c = _merge_topk(best_v, best_c, tv, ti + lo, p)
    st.acc = torch.zeros((M,), dtype=rdt, device=dev)
    st.Q = torch.zeros((N, max_slots), dtype=dtype, device=dev)
    st.R = _host_rows((max_slots, M), dtype, dev) if keep_R else None
    st.k = st.n_acc = 0
    # the reference scale the resident drivers fix at init: ref_sq is the
    # refresh trigger's reference, scale the rank guard's
    vals, _, cols = _host_fold(best_v, best_c)
    top = float(vals[0]) if cols[0] >= 0 else 0.0
    st.ref_sq = top
    st.scale = max(top, 0.0) ** 0.5
    st.best_vals, st.best_cols = best_v, best_c
    return st


def _warm_state(prov: SnapshotProvider, warm: dict, max_slots: int, tiles,
                tile_m: int, p: int, keep_R: bool,
                backend: str) -> _StreamState:
    """Enrichment init: seed the stream with an existing basis.

    ``warm`` carries the finished artifact's trimmed arrays (``Q`` (N, k0),
    ``pivots``/``errs`` and optionally ``rnorms``/``n_passes`` (k0,)).  One
    init sweep computes per tile the raw norms (the rank guard's scale),
    the R rows of the new source against Q0 and the EXACT residuals, which
    become the Eq.-(6.3) reference (``acc`` restarts at zero), as if a
    refresh had just run: the greedy loop then extends the basis with only
    the new source's unexplained directions.
    """
    from repro_torch.data.providers import to_device

    N, M = prov.shape
    dev, dtype = prov.device, prov.dtype
    rdt = dtype.to_real()
    Q0 = to_device(warm["Q"], dev)
    if Q0.dtype != dtype:
        raise ValueError(f"warm-start dtype mismatch: basis {Q0.dtype}, "
                         f"provider {dtype}")
    k0 = Q0.shape[1]
    if k0 > max_slots:
        raise ValueError(
            f"warm-start basis k0={k0} exceeds max_k={max_slots}")
    st = _new_state(prov, max_slots, tile_m, p, backend)
    st.norms_sq = torch.empty((M,), dtype=rdt, device=dev)
    st.R = _host_rows((max_slots, M), dtype, dev) if keep_R else None
    best_v, best_c = _empty_fold(p, rdt, dev)
    raw_max = torch.zeros((), dtype=rdt, device=dev)
    stream = _Tiles(prov, tiles)
    for _, (lo, hi), T in stream:
        n_raw = _column_norms_sq(T)
        C, res = _tile_project(Q0, T)
        tv, ti = _top(res, min(p, hi - lo))
        stream.prefetch()
        raw_max = torch.maximum(raw_max, n_raw.max())
        st.norms_sq[lo:hi] = res
        _put_rows(st.R, 0, lo, hi, C)
        best_v, best_c = _merge_topk(best_v, best_c, tv, ti + lo, p)
    st.acc = torch.zeros((M,), dtype=rdt, device=dev)
    st.Q = torch.zeros((N, max_slots), dtype=dtype, device=dev)
    st.Q[:, :k0] = Q0
    st.pivots[:k0] = np.asarray(warm["pivots"], np.int32)[:k0]
    st.errs[:k0] = np.asarray(warm["errs"], st.errs.dtype)[:k0]
    if "rnorms" in warm:
        st.rnorms[:k0] = np.asarray(warm["rnorms"], st.rnorms.dtype)[:k0]
    if "n_passes" in warm:
        st.n_passes[:k0] = np.asarray(warm["n_passes"], np.int32)[:k0]
    st.k = st.n_acc = k0
    # the exact residuals ARE the reference (post-refresh semantics); the
    # rank guard measures against the new source's raw data scale
    vals, _, cols = _host_fold(best_v, best_c)
    top = float(vals[0]) if cols[0] >= 0 else 0.0
    st.ref_sq = max(top, 1e-300)
    st.scale = max(float(raw_max), 0.0) ** 0.5
    st.best_vals, st.best_cols = best_v, best_c
    return st


def _save_state(st: _StreamState, directory: str, keep: int = 2) -> None:
    """Persist the state as a new step and prune all but the newest
    ``keep`` (each holds a full copy, R included)."""
    from repro_torch.checkpoint.io import prune_steps, save_checkpoint

    st.seq += 1
    save_checkpoint(st.to_tree(), directory, st.seq)
    prune_steps(directory, keep)


def _load_state(directory: str, device: torch.device
                ) -> Optional[_StreamState]:
    from repro_torch.checkpoint.io import latest_step, load_checkpoint_raw

    if latest_step(directory) is None:
        return None
    return _StreamState.from_tree(load_checkpoint_raw(directory), device)


def _check_resumed(st: _StreamState, tile_m, p, N, M, max_slots, dtype,
                   backend, keep_R) -> None:
    if st.tile_m != tile_m:
        # the cursor and the pending sweep are in tile units: another
        # tiling would re-apply part of the in-flight sweep
        raise ValueError(f"checkpoint tile_m mismatch: saved {st.tile_m}, "
                         f"requested {tile_m}")
    if st.block_p != p:
        # the pending panel and the folds are width-block_p (checked before
        # the shape: the blocked slot headroom depends on p)
        raise ValueError(f"checkpoint block_p mismatch: saved {st.block_p}, "
                         f"requested {p}")
    if tuple(st.Q.shape) != (N, max_slots) or st.norms_sq.shape[0] != M:
        raise ValueError(
            f"checkpoint shape mismatch: Q {tuple(st.Q.shape)} / M "
            f"{st.norms_sq.shape[0]} vs requested ({N}, {max_slots}) / {M}")
    if st.Q.dtype != dtype:
        raise ValueError(f"checkpoint dtype mismatch: saved {st.Q.dtype}, "
                         f"provider {dtype}")
    if st.pending and st.backend != backend:
        # a completed sweep is backend-portable, an in-flight one is not
        raise ValueError(
            f"checkpoint has an in-flight sweep under backend "
            f"{st.backend!r}; resume with that backend (requested "
            f"{backend!r}) or restart from a basis boundary")
    if (st.R is not None) != keep_R:
        raise ValueError("checkpoint keep_R setting differs from call")


def rb_greedy_streamed(
    source,
    tau: float,
    max_k: int | None = None,
    *,
    tile_m: int = 8192,
    block_p: int = 1,
    kappa: float = 2.0,
    max_passes: int = 3,
    refresh: str = "auto",
    refresh_safety: float = 100.0,
    backend: str | None = None,
    panel_ortho: bool = True,
    keep_R: bool = True,
    checkpoint_dir: str | os.PathLike | None = None,
    checkpoint_every_tiles: int = 0,
    resume: bool = False,
    callback: Callable[[dict[str, Any]], None] | None = None,
    warm_start: dict | None = None,
    device=None,
    diagnostics: dict | None = None,
) -> StreamedGreedyResult:
    """Algorithm 3 over a :class:`~repro_torch.data.providers.
    SnapshotProvider`.

    ``source`` may be a provider, a resident array or tensor, or a path to
    a ``.npy`` file (:func:`repro_torch.data.providers.as_provider`, with
    tiles on ``device``: ``cuda`` unless asked; a provider keeps its own
    device).  At ``block_p = 1`` it selects the pivots and builds the basis
    of :func:`repro_torch.core.greedy.rb_greedy` on the materialized
    matrix, holding only Q and two N x ``tile_m`` tiles on the device.

    Args beyond the resident drivers':
      tile_m: columns per streamed tile (a multiple of 8192 keeps the
        refresh's products in the resident driver's chunks).
      block_p: pivots per sweep; ``> 1`` folds a top-p candidate list
        across tiles and sweeps each tile once per block.
      panel_ortho: orthogonalize each pending block through the BLAS-3
        panel path (``block_p > 1``), else p sequential GS calls.
      keep_R: accumulate the (max_k, M) R factor on the host.
      checkpoint_dir: persist the streaming state after every block (and
        refresh); ``checkpoint_every_tiles`` also every that many tiles of
        a sweep (0: per block only).
      resume: continue from the newest checkpoint in ``checkpoint_dir``
        (a fresh build when there is none); the tiling, ``block_p``, shape
        and dtype must match it.
      callback: called once per accepted basis with ``{k, pivot, err,
        rnorm, n_passes}``.
      warm_start: seed the build with an existing basis (``Q`` (N, k0),
        ``pivots``/``errs``, optionally ``rnorms``/``n_passes``), the
        enrichment path of :meth:`repro_torch.api.ReducedBasis.enrich`;
        ignored when ``resume`` finds a checkpoint.
      diagnostics: a dict that receives ``passes`` (tile passes over S:
        the init, the ``sweeps`` — one per block, a resumed one counted
        once — and the ``refreshes``), those three, and ``columns`` (single
        columns fetched for pivots).
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
    if tile_m < 1:
        raise ValueError(f"tile_m must be >= 1, got {tile_m}")
    if block_p < 1:
        raise ValueError(f"block_p must be >= 1, got {block_p}")
    p = min(block_p, min(N, M))
    if checkpoint_every_tiles < 0:
        raise ValueError("checkpoint_every_tiles must be >= 0")
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True requires checkpoint_dir")
    backend = _backend.resolve_backend(backend)
    ckpt_dir = os.fspath(checkpoint_dir) if checkpoint_dir is not None \
        else None
    # blocked builds get +p slots of headroom for rank-rejected holes
    # (compacted away at the end), as the resident blocked driver
    max_slots = max_k if p == 1 else min(max_k + p, min(N, M) + p)

    tiles = list(prov.tiles(tile_m))
    dtype = prov.dtype
    rdt = dtype.to_real()
    rdt_np = numpy_dtype(rdt)
    eps = torch.finfo(rdt).eps
    diag = {"passes": 0, "sweeps": 0, "refreshes": 0, "columns": 0}

    st = _load_state(ckpt_dir, dev) if (resume and ckpt_dir) else None
    if st is not None:
        _check_resumed(st, tile_m, p, N, M, max_slots, dtype, backend,
                       keep_R)
        st.backend = backend
    else:
        if warm_start is not None:
            st = _warm_state(prov, warm_start, max_slots, tiles, tile_m, p,
                             keep_R, backend)
        else:
            st = _fresh_state(prov, max_slots, tiles, tile_m, p, keep_R,
                              backend)
        diag["passes"] += 1
        if ckpt_dir:
            # a fresh build into a directory holding an older run's steps
            # continues their numbering, so its saves sort newest (and the
            # pruner retires the stale ones) instead of being shadowed
            from repro_torch.checkpoint.io import latest_step

            st.seq = latest_step(ckpt_dir) or 0

    # The stop tests of the resident chunked drivers, in the residual
    # dtype: the rank guard's threshold 50 eps scale, tau, and the refresh
    # trigger's safety * eps * ref_sq.
    def r(x):
        return rdt_np.type(x)

    tau_r = r(tau)
    thresh = r(r(50.0 * eps) * r(st.scale))
    thresh_d = torch.tensor(thresh, dtype=rdt, device=dev)
    zero = r(0.0)

    def column(j: int) -> torch.Tensor:
        diag["columns"] += 1
        return prov.column(j)

    def save() -> None:
        if ckpt_dir:
            _save_state(st, ckpt_dir)

    # a resumed checkpoint that already carries the done verdict needs no
    # re-recording; a live run records it at its terminal save
    done_saved = bool(st.done)
    while not st.done:
        if not st.pending:
            if st.k + p > max_slots:
                st.done, st.stop = 1, STOP_NONE  # slot capacity
                break
            # the pivot block from the running top-p fold (folded across
            # tiles by the previous sweep, the init or the refresh pass)
            _, errs_r, cols = _host_fold(st.best_vals, st.best_cols)
            if cols[0] < 0 or errs_r[0] < tau_r:
                st.done, st.stop = 1, STOP_TAU
                break
            # --- joint IMGS of the block (in-block rank guard) ----------
            errs_blk = np.where(cols >= 0, errs_r, zero).astype(np.float64)
            if p > 1 and panel_ortho:
                # the resident blocked driver's panel path: all p
                # candidates against Q (and each other) at once
                V = torch.stack([
                    column(int(j)) if j >= 0 else
                    torch.zeros((N,), dtype=dtype, device=dev)
                    for j in cols], dim=1)
                P_blk, oks_d, rnorms_d, npass_d = panel_imgs_orthogonalize(
                    V, st.Q, kappa, max_passes, thresh=thresh_d,
                    backend=backend)
            else:
                Qwork = st.Q if p == 1 else st.Q.clone()
                qs, oks_l, rn_l, np_l = [], [], [], []
                for i in range(p):
                    j = int(cols[i])
                    if j < 0:  # fewer than p candidates exist (tiny M)
                        qs.append(torch.zeros((N,), dtype=dtype, device=dev))
                        oks_l.append(torch.zeros((), dtype=torch.bool,
                                                 device=dev))
                        rn_l.append(torch.zeros((), dtype=rdt, device=dev))
                        np_l.append(torch.zeros((), dtype=torch.int32,
                                                device=dev))
                        continue
                    q, _, rnorm, npass = imgs_orthogonalize(
                        column(j), Qwork, kappa, max_passes,
                        backend=backend)
                    # p = 1 keeps the stepwise drivers' guard (reject
                    # strictly below), p > 1 the blocked driver's (accept
                    # strictly above)
                    ok = ~(rnorm < thresh_d) if p == 1 else rnorm > thresh_d
                    if p > 1:
                        q = torch.where(ok, q, torch.zeros_like(q))
                        Qwork[:, st.k + i] = q
                    qs.append(q)
                    oks_l.append(ok)
                    rn_l.append(rnorm)
                    np_l.append(npass.to(torch.int32))
                P_blk = torch.stack(qs, dim=1)
                oks_d, rnorms_d = torch.stack(oks_l), torch.stack(rn_l)
                npass_d = torch.stack(np_l)
            diag_h = torch.cat([oks_d.to(torch.float64),
                                rnorms_d.to(torch.float64),
                                npass_d.to(torch.float64)]).cpu().numpy()
            oks = (diag_h[:p] > 0) & (cols >= 0)
            if not oks.any():
                # the whole block rank-rejected: numerical-rank exhaustion,
                # stop WITHOUT committing (at p = 1 the stepwise drivers'
                # rank-guard break)
                st.done, st.stop = 1, STOP_RANK
                break
            st.pending, st.cursor = 1, 0
            st.pending_Q = P_blk.contiguous()
            st.pending_cols = cols.astype(np.int64)
            st.pending_errs = errs_blk
            st.pending_rnorms = diag_h[p:2 * p].copy()
            st.pending_npass = diag_h[2 * p:].astype(np.int64)
            st.pending_ok = oks.astype(np.int64)
            st.sweep_vals, st.sweep_cols = _empty_fold(p, rdt, dev)

        # --- Eq.-(6.3) sweep over the tiles (resumable per tile) --------
        P_blk = st.pending_Q
        q1 = P_blk[:, 0].contiguous() if p == 1 else None
        stream = _Tiles(prov, tiles, st.cursor)
        for i, (lo, hi), T in stream:
            acc_t, norms_t = st.acc[lo:hi], st.norms_sq[lo:hi]
            if p == 1:
                c, acc_out, mx, am = _tile_sweep(q1, T, acc_t, norms_t,
                                                 backend)
                C, tv, ti = c[None, :], mx.view(1), am.view(1)
            else:
                C, acc_out, tv, ti = _tile_block_sweep(
                    P_blk, T, acc_t, norms_t, min(p, hi - lo), backend)
            stream.prefetch()
            st.acc[lo:hi] = acc_out
            _put_rows(st.R, st.k, lo, hi, C)
            st.sweep_vals, st.sweep_cols = _merge_topk(
                st.sweep_vals, st.sweep_cols, tv, ti + lo, p)
            st.cursor = i + 1
            if (ckpt_dir and checkpoint_every_tiles
                    and st.cursor < len(tiles)
                    and st.cursor % checkpoint_every_tiles == 0):
                save()
        diag["passes"] += 1
        diag["sweeps"] += 1

        # --- commit the block -------------------------------------------
        slots = st.k
        _commit_panel(st.Q, st.pending_Q, slots)
        for i in range(p):
            if st.pending_cols[i] < 0:
                continue
            ok = bool(st.pending_ok[i])
            st.pivots[slots + i] = st.pending_cols[i] if ok else -1
            st.errs[slots + i] = st.pending_errs[i]
            st.rnorms[slots + i] = st.pending_rnorms[i]
            st.n_passes[slots + i] = st.pending_npass[i]
            if ok:
                st.n_acc += 1
                if callback is not None:
                    callback({"k": st.n_acc,
                              "pivot": int(st.pending_cols[i]),
                              "err": float(st.errs[slots + i]),
                              "rnorm": float(st.rnorms[slots + i]),
                              "n_passes": int(st.n_passes[slots + i])})
        st.k = slots + p
        st.best_vals, st.best_cols = st.sweep_vals, st.sweep_cols
        err = r(st.pending_errs[0])
        st.pending, st.cursor = 0, 0
        st.pending_Q = torch.zeros_like(st.pending_Q)
        _clear_pending(st, p)

        # --- stop tests of the resident chunk, then the refresh ----------
        # p = 1: the stepwise trigger on the committed pivot's pre-add err;
        # p > 1: the blocked chunk's post-block residual (the fold's top),
        # tau first (a residual below tau is converged: no refresh).
        if p == 1:
            floor_sq = r(err * err)
            converged = False
        else:
            top, _, _ = _host_fold(st.best_vals[:1], st.best_cols[:1])
            floor_sq = max(top[0], zero)
            converged = floor_sq < r(tau_r * tau_r)
        if converged:
            st.done, st.stop = 1, STOP_TAU
        elif (refresh == "auto"
              and floor_sq < r(r(r(refresh_safety) * r(eps))
                               * r(st.ref_sq))):
            st.norms_sq = torch.empty_like(st.norms_sq)
            best_v, best_c = _empty_fold(p, rdt, dev)
            stream = _Tiles(prov, tiles)
            for _, (lo, hi), T in stream:
                res, tv, ti = _tile_refresh(st.Q, T, min(p, hi - lo))
                stream.prefetch()
                st.norms_sq[lo:hi] = res
                best_v, best_c = _merge_topk(best_v, best_c, tv, ti + lo, p)
            diag["passes"] += 1
            diag["refreshes"] += 1
            st.acc.zero_()
            st.best_vals, st.best_cols = best_v, best_c
            vals, _, _ = _host_fold(best_v, best_c)
            st.ref_sq = max(float(vals[0]), 1e-300)
            if st.ref_sq ** 0.5 < tau:
                st.done, st.stop = 1, STOP_TAU
            elif st.ref_sq ** 0.5 <= floor_estimate(eps, st.scale,
                                                    st.n_acc):
                # post-refresh exact residual at the achievable floor: tau
                # is out of reach in this precision
                st.done, st.stop = 1, STOP_FLOOR
        if ckpt_dir:
            save()
            done_saved = bool(st.done)

    # Final save: the pre-sweep exits only set the done/stop verdict, but
    # it must be persisted (a floor-stopped build's residual sits above
    # tau: a resume without it would keep adding bases).
    if ckpt_dir and not done_saved:
        save()
    if diagnostics is not None:
        diagnostics.update(diag)
    _sync(dev)
    if p == 1:
        keep = np.arange(st.k)
    else:
        # drop the hole columns (rank-rejected candidates) and cap at
        # max_k: the basis is nested, so the cut is exact
        keep = np.where(st.pivots[:st.k] >= 0)[0][:max_k]
    return _result(st, keep, tiles, p)


def _result(st: _StreamState, keep: np.ndarray, tiles,
            p: int) -> StreamedGreedyResult:
    """The result: at ``p = 1`` the slot buffers as they are; at ``p > 1``
    the slots ``keep`` packed to the front of buffers of the same width."""
    k = len(keep)
    Q, R = st.Q, st.R
    arrays = [st.pivots, st.errs, st.n_passes, st.rnorms]
    if p > 1:
        width, dev = Q.shape[1], Q.device
        Q = torch.zeros_like(st.Q)
        Q[:, :k] = st.Q.index_select(1, torch.as_tensor(keep, device=dev))
        if R is not None:
            R = torch.zeros_like(st.R, pin_memory=st.R.is_pinned())
            R[:k] = st.R[torch.as_tensor(keep)]
        packed = []
        for a, fill in zip(arrays, (-1, 0, 0, 0)):
            out = np.full((width,), fill, a.dtype)
            out[:k] = a[keep]
            packed.append(out)
        arrays = packed
    pivots, errs, n_passes, rnorms = (torch.from_numpy(np.array(a))
                                      for a in arrays)
    return StreamedGreedyResult(
        Q=Q, R=R, pivots=pivots, errs=errs, k=k, n_ortho_passes=n_passes,
        rnorms=rnorms, tile_m=st.tile_m, n_tiles=len(tiles), block_p=p,
        stop=int(st.stop))
