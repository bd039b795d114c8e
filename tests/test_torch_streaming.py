"""The port's out-of-core streamed RB-greedy (``repro_torch.core.streaming``)
against the JAX reference and against itself, on the CPU.

Against the reference (the same numpy inputs, tau above the Eq.-(6.3)
refresh trigger unless a case says otherwise): k, the stop code and the
pivots exactly; Q, R and the errors within ``dtype_tol``.  Below that
floor the pivot order hangs on summation order: the reference's own
``tests/test_streaming.py::test_deep_tolerance_refresh_parity`` parts its
streamed and stepwise drivers there (pivot 47 against 46 at step 13 on
this CPU), so the refresh cases raise ``refresh_safety`` to fire it above
the floor instead.

Within the port, bitwise.  The CPU BLAS gives a column other bits in a
matrix of another width in float32, complex64 and complex128 (a GEMV's
vector body and tail), so a CPU build over tiles equals the resident build
bit for bit where the BLAS keeps the columns' bits: the stepwise cases are
float64, the blocked ones float32 and float64.  The card's kernels keep
them in every dtype (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol, make_smooth_matrix
from repro.checkpoint import io as jio
from repro.core import streaming as js
from repro.data import providers as jp
from repro_torch.api import ReducedBasis, ReductionSpec, build_basis
from repro_torch.checkpoint import io as tio
from repro_torch.core import streaming as ts
from repro_torch.core.block_greedy import _rb_greedy_block_impl
from repro_torch.core.errors import per_column_errors
from repro_torch.core.greedy import (
    STOP_NAMES, STOP_NONE, STOP_RANK, STOP_TAU, rb_greedy,
    rb_greedy_stepwise,
)
from repro_torch.data import (
    ArrayProvider, FaultPlan, FaultyProvider, MemmapProvider,
    WaveformProvider, as_provider, create_snapshot_npy, write_snapshot_npy,
)
from repro_torch.gw import chirp_grid, frequency_grid
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
M_COLS = 120  # make_smooth_matrix's M
# one tile, an M-divisible width, a ragged last tile, 1-column tiles
TILES = [M_COLS, 40, 33, 1]
# tau above the refresh trigger (err^2 < 100 eps max|s|^2) of each dtype on
# the smooth family, whose largest column norm is 7.83
TAU = {np.float32: 5e-2, np.complex64: 5e-2, np.float64: 1e-5,
       np.complex128: 1e-5}
DTYPES = list(TAU)


def _S(dtype):
    return make_smooth_matrix(dtype=dtype)


def _prov(S):
    return ArrayProvider(torch.as_tensor(np.asarray(S)), device=CPU)


def _stream(S, **kw):
    return ts.rb_greedy_streamed(_prov(S), **kw)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_matches_jax(ref, got, dtype, n, S=None):
    """k, stop and pivots exact; the rest within dtype_tol plus the
    rounding that the algorithm amplifies, in either package:

    - err = sqrt(|s|^2 - sum |c|^2) is off by ~eps |s|^2 / err (Eq. 6.3);
    - basis vector j is a column orthogonalized down to its residual norm
      rnorm_j, off by ~eps |s| / rnorm_j, and row j of R by |s| times that
      (the largest |s| is errs[0]).

    Blocked builds (``S`` given) orthogonalize a stale pick against the
    earlier picks of its block too, where the residual norms do not bound
    the amplification; their Q is held to its contract instead, as the
    reference's blocked parity test does: orthonormal, and approximating S
    as well as the reference's Q (within a factor 2)."""
    k = int(ref.k)
    assert got.k == k
    assert got.stop == int(ref.stop)
    assert tuple(got.Q.shape) == tuple(ref.Q.shape)
    np.testing.assert_array_equal(_np(got.pivots), np.asarray(ref.pivots))
    tol = dtype_tol(dtype, n)
    eps = float(np.finfo(np.dtype(dtype)).eps)
    scale = _assert_errs(got.errs[:k], np.asarray(ref.errs)[:k], dtype, n)
    rn = np.asarray(ref.rnorms)[:k].astype(np.float64)
    np.testing.assert_allclose(_np(got.rnorms)[:k], rn, rtol=tol,
                               atol=tol * scale)
    if S is not None:
        from repro_torch.core.errors import proj_error_max

        Q = got.Q[:, :k]
        eye = torch.eye(k, dtype=Q.dtype)
        assert float(torch.linalg.matrix_norm(Q.mH @ Q - eye, ord=2)) \
            < 100 * eps * k ** 0.5
        St = torch.as_tensor(S)
        want_err = float(proj_error_max(St, torch.as_tensor(
            np.array(ref.Q)[:, :k])))
        assert float(proj_error_max(St, Q)) <= 2 * want_err + tol * scale
        return
    q_bound = tol + 10 * eps * scale / np.maximum(rn, 1e-300)
    dq = np.abs(_np(got.Q) - np.asarray(ref.Q))
    assert np.all(dq[:, :k] <= q_bound) and np.all(dq[:, k:] == 0)
    assert (got.R is None) == (ref.R is None)
    if got.R is not None:
        dr = np.abs(_np(got.R)[:k] - np.asarray(ref.R)[:k])
        assert np.all(dr <= scale * q_bound[:, None])


def _assert_errs(got, want, dtype, n):
    """Greedy errors within dtype_tol plus Eq. (6.3)'s rounding, ~eps
    |s|^2 / err (the largest |s| is the first error); returns that |s|."""
    want = np.asarray(want).astype(np.float64)
    scale = float(np.max(np.abs(want))) + 1e-30
    eps = float(np.finfo(np.dtype(dtype)).eps)
    bound = dtype_tol(dtype, n) * scale + 10 * eps * scale**2 / np.maximum(
        want, 1e-300)
    assert np.all(np.abs(_np(got) - want) <= bound)
    return scale


def _assert_same(a, b):
    """Two port builds, bit for bit."""
    assert a.k == b.k and a.stop == b.stop
    k = a.k
    assert torch.equal(a.pivots[:k], b.pivots[:k].cpu())
    assert torch.equal(a.errs[:k], b.errs[:k].cpu())
    assert torch.equal(a.Q, b.Q)
    if a.R is not None and b.R is not None:
        assert torch.equal(a.R, b.R.cpu())


# ------------------------------------------------------- against the JAX --
@pytest.mark.parametrize("tile_m", TILES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_stepwise_matches_jax(dtype, tile_m):
    S = _S(dtype)
    ref = js.rb_greedy_streamed(jp.ArrayProvider(S), tau=TAU[dtype],
                                tile_m=tile_m)
    got = _stream(S, tau=TAU[dtype], tile_m=tile_m)
    assert got.n_tiles == ref.n_tiles and got.block_p == 1
    _assert_matches_jax(ref, got, dtype, S.shape[0])


@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_blocked_matches_jax(dtype, p):
    S = _S(dtype)
    ref = js.rb_greedy_streamed(jp.ArrayProvider(S), tau=TAU[dtype],
                                tile_m=33, block_p=p)
    got = _stream(S, tau=TAU[dtype], tile_m=33, block_p=p)
    assert got.block_p == p
    _assert_matches_jax(ref, got, dtype, S.shape[0], S)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_refresh_matches_jax(dtype):
    """refresh_safety 1e6 fires the Eq.-(6.3) refresh at err ~1e-4, well
    above the cancellation floor; both packages refresh and agree."""
    S = _S(dtype)
    kw = dict(tau=1e-5, tile_m=33, refresh_safety=1e6)
    ref = js.rb_greedy_streamed(jp.ArrayProvider(S), **kw)
    got = _stream(S, **kw)
    _assert_matches_jax(ref, got, dtype, S.shape[0])
    diag = {}
    _stream(S, diagnostics=diag, **kw)
    assert diag["refreshes"] >= 1


@pytest.mark.parametrize("p", [1, 3])
def test_max_k_matches_jax(p):
    S = _S(np.float64)
    kw = dict(tau=1e-12, max_k=5, tile_m=40, block_p=p)
    ref = js.rb_greedy_streamed(jp.ArrayProvider(S), **kw)
    got = _stream(S, **kw)
    assert got.k == int(ref.k) <= 5
    np.testing.assert_array_equal(_np(got.pivots), np.asarray(ref.pivots))
    assert np.all(_np(got.pivots)[got.k:] == -1)


def test_keep_r_false_and_callback_match_jax():
    S = _S(np.float64)
    seen, seen_ref = [], []
    ref = js.rb_greedy_streamed(jp.ArrayProvider(S), tau=1e-5, tile_m=33,
                                keep_R=False, callback=seen_ref.append)
    got = _stream(S, tau=1e-5, tile_m=33, keep_R=False,
                  callback=seen.append)
    assert got.R is None
    _assert_matches_jax(ref, got, np.float64, S.shape[0])
    assert [i["k"] for i in seen] == list(range(1, got.k + 1))
    assert [i["pivot"] for i in seen] == [i["pivot"] for i in seen_ref]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_waveform_provider_matches_jax(dtype, normalize):
    """Tiles within dtype_tol of the reference's (the phase is float64 in
    both); a tile's columns are those of any other tile, bit for bit."""
    f = frequency_grid(20.0, 256.0, 200)
    m1, m2 = chirp_grid(n_mc=11, n_eta=7)  # M = 77
    tprov = WaveformProvider(f, m1, m2, dtype=dtype, normalize=normalize,
                             device=CPU)
    jprov = jp.WaveformProvider(f, m1, m2, dtype=dtype, normalize=normalize)
    assert tprov.shape == jprov.shape == (200, 77)
    full = tprov.materialize()
    want = np.asarray(jprov.materialize())
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_np(full), want, rtol=0,
                               atol=dtype_tol(dtype, 200) * scale)
    for lo, hi in ((0, 20), (20, 40), (60, 77), (5, 6)):
        assert torch.equal(tprov.tile(lo, hi), full[:, lo:hi])
    assert torch.equal(tprov.column(33), full[:, 33])


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_waveform_stream_equals_resident(dtype):
    """The streamed build over a WaveformProvider is the resident build over
    build_snapshot_matrix's S of the same grid, bit for bit (one tile: the
    CPU BLAS keeps the bits at equal widths; ragged tiles on the card).

    Unnormalized TaylorF2 columns all have the norm of the amplitude, so
    the first pivot is an argmax over norms equal to an ulp: across
    packages it is a coin flip, within the port the fixed-order norms
    decide it the same way in both builds."""
    from repro_torch.gw import build_snapshot_matrix

    f = frequency_grid(20.0, 256.0, 200)
    m1, m2 = chirp_grid(n_mc=11, n_eta=7)
    prov = WaveformProvider(f, m1, m2, dtype=dtype, normalize=False,
                            device=CPU)
    S = build_snapshot_matrix(f, m1, m2, dtype=dtype, device=CPU,
                              normalize=False, chunk=20)
    assert torch.equal(S, prov.materialize())
    tau = 1e-3 * float(torch.linalg.vector_norm(S, dim=0).max())
    got = ts.rb_greedy_streamed(prov, tau=tau, tile_m=77)
    _assert_same(got, rb_greedy(S, tau=tau, device=CPU))
    assert got.k > 10


def test_enrich_matches_jax(tmp_path):
    """A basis of the first half of the columns (nu 0.5-1.25), enriched
    with the second (nu 1.25-2): the existing bases kept bit for bit, the
    new pivots the reference's."""
    from repro.api import build_basis as jbuild

    S = _S(np.complex128)
    A, B = S[:, :60], S[:, 60:]
    base = build_basis(source=A, tau=1e-5, device=CPU)
    jbase = jbuild(source=jnp.asarray(A), tau=1e-5)
    assert base.k == jbase.k
    base.save(str(tmp_path / "art"))
    grown = ReducedBasis.load(str(tmp_path / "art"), CPU).enrich(
        B, tile_m=20)
    jgrown = jbase.enrich(B, tile_m=20, save=False)
    assert grown.k == jgrown.k > base.k
    assert torch.equal(grown.Q[:, :base.k], base.Q)
    np.testing.assert_array_equal(grown.pivots, np.asarray(jgrown.pivots))
    _assert_errs(grown.errs, jgrown.errs, np.complex128, S.shape[0])
    assert grown.provenance["enriched_from_k"] == base.k
    # saved as a new artifact step, the old one a step back
    assert ReducedBasis.load(str(tmp_path / "art"), CPU).k == grown.k


# ------------------------------------------------ within the port, bitwise --
@pytest.mark.parametrize("tile_m", TILES)
def test_tile_size_invariant_and_equals_resident(tile_m):
    """float64 (the CPU BLAS keeps a column's bits across widths): every
    tiling gives the resident stepwise and chunked builds' pivots, Q, R and
    errs bit for bit."""
    S = torch.as_tensor(_S(np.float64))
    got = _stream(S, tau=1e-5, tile_m=tile_m)
    for ref in (rb_greedy_stepwise(S, tau=1e-5, device=CPU),
                rb_greedy(S, tau=1e-5, device=CPU)):
        _assert_same(got, ref)


@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_stream_equals_resident_blocked(dtype, p):
    S = torch.as_tensor(_S(dtype))
    tau = TAU[dtype]
    ref = _rb_greedy_block_impl(S, tau, p=p, device=CPU)
    for tile_m in TILES:
        got = _stream(S, tau=tau, tile_m=tile_m, block_p=p)
        _assert_same(got, ref)


def test_blocked_stream_falls_short_on_a_dense_grid_as_the_reference():
    """The blocked stream's weak basis on a dense GW grid is the
    algorithm's, not the port's.  In complex64 the p = 8 picks of one stale
    residual are near neighbours on a fine chirp-mass grid: the rank guard
    rejects most of them, their holes use up the max_k + p slots, and the
    build stops at slot capacity (STOP_NONE) with a basis that represents
    the family poorly.  The reference's blocked streamed driver does the
    same on the same S (its pivots part from the port's at the first
    near-tie of the column norms, so only the outcome is compared), and
    the stepwise build of the same S reaches tau."""
    from repro_torch.gw import build_snapshot_matrix

    f = frequency_grid(40.0, 1024.0, 1000)
    m1, m2 = chirp_grid(n_mc=8192, n_eta=4)
    S = build_snapshot_matrix(f, m1, m2, dtype=torch.complex64, device=CPU)
    kw = dict(tau=1e-4, max_k=100, tile_m=8192)
    ref = js.rb_greedy_streamed(S.numpy(), block_p=8, **kw)
    got = _stream(S, block_p=8, **kw)
    step = _stream(S, block_p=1, **kw)
    for k, Q, stop in ((ref.k, np.array(ref.Q), ref.stop),
                       (got.k, _np(got.Q), got.stop)):
        assert stop == STOP_NONE and k < 70
        err = per_column_errors(S, torch.as_tensor(Q[:, :k])).max()
        assert err > 0.5
    assert step.stop == STOP_TAU
    assert per_column_errors(S, step.Q[:, :step.k]).max() < 1e-3


@pytest.mark.parametrize("p", [1, 3])
def test_ties_keep_the_earliest_column(p):
    """Every column twice, 120 columns apart: each residual ties with its
    twin's bit for bit, in other tiles, so every pick is a tie; the folds
    keep the earlier column (a strict ``>`` at p = 1, the stable sort at p
    > 1), as the resident drivers' first-index argmax and top_p do."""
    S = torch.as_tensor(_S(np.float64))
    S2 = torch.cat([S, S], dim=1)
    ref = rb_greedy(S2, tau=1e-5, device=CPU) if p == 1 else \
        _rb_greedy_block_impl(S2, 1e-5, p=p, device=CPU)
    assert ref.k > 5 and bool((ref.pivots[:ref.k] < M_COLS).all())
    for tile_m in (240, 33, 1):
        _assert_same(_stream(S2, tau=1e-5, tile_m=tile_m, block_p=p), ref)


class _CrashingProvider(ArrayProvider):
    """Raises after serving ``budget`` tiles (a column is a tile)."""

    def __init__(self, S, budget):
        super().__init__(torch.as_tensor(np.asarray(S)), device=CPU)
        self.budget = budget

    def tile(self, lo, hi):
        if self.budget <= 0:
            raise IOError("injected crash")
        self.budget -= 1
        return super().tile(lo, hi)


# the init pass reads 4 tiles and each basis 1 column + 4 tiles: 7 dies on
# sweep tile 3 of basis 0, 13 on sweep tile 4 of basis 1
@pytest.mark.parametrize("crash", [7, 13])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_crash_resume_identical(tmp_path, dtype, crash):
    S = _S(dtype)
    kw = dict(tau=TAU[dtype], tile_m=33)
    ref = _stream(S, **kw)
    ck = tmp_path / "ck"
    with pytest.raises(IOError, match="injected crash"):
        ts.rb_greedy_streamed(_CrashingProvider(S, crash), checkpoint_dir=ck,
                              checkpoint_every_tiles=1, **kw)
    assert tio.latest_step(str(ck)) is not None
    got = _stream(S, checkpoint_dir=ck, resume=True, **kw)
    _assert_same(got, ref)


@pytest.mark.parametrize("budget,p", [(9, 3), (10, 4)])
def test_blocked_crash_resume_mid_panel(tmp_path, budget, p):
    """A checkpoint taken mid-panel (the block orthogonalized, its sweep
    partly applied) resumes to the same bits."""
    S = _S(np.complex64)
    kw = dict(tau=5e-2, tile_m=33, block_p=p)
    ref = _stream(S, **kw)
    ck = tmp_path / "ck"
    with pytest.raises(IOError, match="injected crash"):
        ts.rb_greedy_streamed(_CrashingProvider(S, budget), checkpoint_dir=ck,
                              checkpoint_every_tiles=1, **kw)
    tree = tio.load_checkpoint_raw(str(ck))
    assert int(tree["pending"]) == 1 and int(tree["cursor"]) > 0
    assert np.any(tree["pending_Q"] != 0)
    _assert_same(_stream(S, checkpoint_dir=ck, resume=True, **kw), ref)


def test_v1_checkpoint_lifts_and_resumes(tmp_path):
    S = _S(np.complex64)
    ck = tmp_path / "ck"
    with pytest.raises(IOError, match="injected crash"):
        ts.rb_greedy_streamed(_CrashingProvider(S, 7), tau=5e-2, tile_m=33,
                              checkpoint_dir=ck, checkpoint_every_tiles=1)
    v1 = dict(tio.load_checkpoint_raw(str(ck)))
    v1["version"] = np.asarray(1, np.int64)
    v1["best_val"] = v1.pop("best_vals")[0]
    v1["best_col"] = v1.pop("best_cols")[0]
    v1["pending_q"] = v1.pop("pending_Q")[:, 0]
    v1["pending_col"] = v1.pop("pending_cols")[0]
    v1["pending_err"] = v1.pop("pending_errs")[0]
    v1["pending_rnorm"] = v1.pop("pending_rnorms")[0]
    v1["pending_npass"] = v1["pending_npass"][0]
    v1["sweep_val"] = v1.pop("sweep_vals")[0]
    v1["sweep_col"] = v1.pop("sweep_cols")[0]
    for v2_only in ("block_p", "n_acc", "pending_ok"):
        v1.pop(v2_only)
    tio.save_checkpoint(v1, str(ck), tio.latest_step(str(ck)) + 1)
    got = _stream(S, tau=5e-2, tile_m=33, checkpoint_dir=ck, resume=True)
    _assert_same(got, _stream(S, tau=5e-2, tile_m=33))


def _saved(tmp_path, **kw):
    S = _S(np.float64)
    ck = tmp_path / "ck"
    _stream(S, tau=1e-4, tile_m=40, checkpoint_dir=ck, **kw)
    return S, ck


@pytest.mark.parametrize("case", ["shape", "tile_m", "dtype", "block_p",
                                  "keep_R"])
def test_resume_mismatch_rejected(tmp_path, case):
    S, ck = _saved(tmp_path, block_p=2)
    kw = dict(tau=1e-4, tile_m=40, block_p=2, checkpoint_dir=ck,
              resume=True)
    src, match = S, "mismatch"
    if case == "shape":
        src = S[:, :60]
    elif case == "tile_m":
        kw["tile_m"], match = 20, "tile_m mismatch"
    elif case == "dtype":
        src, match = S.astype(np.float32), "dtype mismatch"
    elif case == "block_p":
        kw["block_p"], match = 3, "block_p mismatch"
    else:
        kw["keep_R"], match = False, "keep_R"
    with pytest.raises(ValueError, match=match):
        _stream(src, **kw)


def test_resume_midsweep_backend_mismatch_rejected(tmp_path):
    """An in-flight sweep's partial acc carries one backend's summation
    order: resuming it under the other backend is refused."""
    S = _S(np.complex64)
    ck = tmp_path / "ck"
    with pytest.raises(IOError, match="injected crash"):
        ts.rb_greedy_streamed(_CrashingProvider(S, 7), tau=5e-2, tile_m=33,
                              backend="auto", checkpoint_dir=ck,
                              checkpoint_every_tiles=1)
    with pytest.raises(ValueError, match="in-flight sweep"):
        _stream(S, tau=5e-2, tile_m=33, backend="ref", checkpoint_dir=ck,
                resume=True)
    got = _stream(S, tau=5e-2, tile_m=33, backend="auto", checkpoint_dir=ck,
                  resume=True)
    _assert_same(got, _stream(S, tau=5e-2, tile_m=33))


@pytest.mark.parametrize("kw,match", [
    (dict(tile_m=0), "tile_m"), (dict(block_p=0), "block_p"),
    (dict(resume=True), "checkpoint_dir"),
    (dict(checkpoint_every_tiles=-1), "checkpoint_every_tiles"),
    (dict(backend="xla"), "backend")])
def test_invalid_args_rejected(kw, match):
    with pytest.raises(ValueError, match=match):
        _stream(_S(np.float64), tau=1e-4, **kw)


def test_resume_with_empty_dir_is_fresh_build(tmp_path):
    S = _S(np.float64)
    got = _stream(S, tau=1e-4, tile_m=40, checkpoint_dir=tmp_path / "e",
                  resume=True)
    _assert_same(got, _stream(S, tau=1e-4, tile_m=40))


def test_fresh_build_over_stale_checkpoints(tmp_path):
    """A fresh build into a directory of an older run continues its step
    numbering, so a resume restores the NEW build."""
    S, ck = _saved(tmp_path)
    new = _stream(S, tau=1e-2, tile_m=40, checkpoint_dir=ck)
    resumed = _stream(S, tau=1e-2, tile_m=40, checkpoint_dir=ck,
                      resume=True)
    assert new.k < _stream(S, tau=1e-4, tile_m=40).k
    _assert_same(resumed, new)


def test_checkpoints_are_pruned(tmp_path):
    S = _S(np.float64)
    ck = tmp_path / "ck"
    _stream(S, tau=1e-4, tile_m=20, checkpoint_dir=ck,
            checkpoint_every_tiles=1)
    assert len(tio.list_steps(str(ck))) <= 2


# ------------------------------------------------------- faults, providers --
def test_faulty_provider_transient_completes(monkeypatch):
    monkeypatch.setenv("REPRO_IO_RETRY_BASE_S", "0")
    S = _S(np.float64)
    prov = FaultyProvider(_prov(S), FaultPlan(transient_every=3))
    got = ts.rb_greedy_streamed(prov, tau=1e-4, tile_m=40)
    assert prov.reads > 10
    _assert_same(got, _stream(S, tau=1e-4, tile_m=40))


def test_faulty_provider_hard_fault_kills_the_build(tmp_path):
    S = _S(np.float64)
    prov = FaultyProvider(_prov(S), FaultPlan(raise_at_tile=9))
    ck = tmp_path / "ck"
    with pytest.raises(IOError, match="injected hard I/O fault at tile "
                       "read 9"):
        ts.rb_greedy_streamed(prov, tau=1e-4, tile_m=40, checkpoint_dir=ck,
                              checkpoint_every_tiles=1)
    got = _stream(S, tau=1e-4, tile_m=40, checkpoint_dir=ck, resume=True)
    _assert_same(got, _stream(S, tau=1e-4, tile_m=40))


def test_env_auto_wrap(monkeypatch, tmp_path):
    """REPRO_FAULT_* arm a FaultyProvider around whatever as_provider
    builds (never twice); the front door's streamed build dies on it."""
    S = _S(np.float64)
    monkeypatch.setenv("REPRO_FAULT_RAISE_AT_TILE", "5")
    prov = as_provider(S, CPU)
    assert isinstance(prov, FaultyProvider)
    assert prov.plan == FaultPlan(raise_at_tile=5)
    assert as_provider(prov) is prov
    with pytest.raises(IOError, match="injected hard"):
        build_basis(source=S, strategy="streamed", tau=1e-4, tile_m=40,
                    device=CPU)
    monkeypatch.delenv("REPRO_FAULT_RAISE_AT_TILE")
    assert not isinstance(as_provider(S, CPU), FaultyProvider)


@pytest.mark.parametrize("fault", ["REPRO_FAULT_CORRUPT_LEAF",
                                   "REPRO_FAULT_TRUNCATE_MANIFEST"])
def test_post_save_corruption_hooks(monkeypatch, tmp_path, fault):
    """A committed step corrupted after its rename (one-shot under
    REPRO_FAULT_ONCE): the newest-step load skips it and falls back to the
    older intact step; naming the step raises."""
    d = str(tmp_path / "ck")
    tio.save_checkpoint({"a": np.arange(4.0)}, d, 1)
    monkeypatch.setenv(fault, "any" if fault.endswith("LEAF") else "1")
    monkeypatch.setenv("REPRO_FAULT_ONCE", str(tmp_path / "once"))
    tio.save_checkpoint({"a": np.arange(5.0)}, d, 2)
    tio.save_checkpoint({"a": np.arange(6.0)}, d, 3)  # the fault is spent
    assert tio.load_checkpoint_raw(d, step=3)["a"].shape == (6,)
    with pytest.raises(IOError):
        tio.load_checkpoint_raw(d, step=2)
    (tmp_path / "ck" / "step_00000003").rename(tmp_path / "moved")
    assert tio.load_checkpoint_raw(d)["a"].shape == (4,)


def test_memmap_and_host_providers(tmp_path):
    """Row- and column-major .npy files, a file built tile by tile, and a
    host array: the same tiles, the same build."""
    S = _S(np.complex64)
    ref = _stream(S, tau=5e-2, tile_m=33)
    for order in (True, False):
        path = write_snapshot_npy(tmp_path / f"S{order}", S,
                                  fortran_order=order)
        assert path.endswith(".npy")
        prov = MemmapProvider(path, device=CPU)
        assert prov.shape == S.shape and prov.dtype == torch.complex64
        _assert_same(ts.rb_greedy_streamed(prov, tau=5e-2, tile_m=33), ref)
    mm = create_snapshot_npy(tmp_path / "big.npy", S.shape, torch.complex64)
    for lo in range(0, S.shape[1], 33):
        mm[:, lo:lo + 33] = S[:, lo:lo + 33]
    mm.flush()
    del mm
    prov = as_provider(str(tmp_path / "big.npy"), CPU)
    np.testing.assert_array_equal(_np(prov.materialize()), S)
    assert list(prov.tiles(50)) == [(0, 50), (50, 100), (100, 120)]
    assert torch.equal(prov.column(7), torch.as_tensor(S[:, 7]))
    _assert_same(ts.rb_greedy_streamed(S, tau=5e-2, tile_m=33, device=CPU),
                 ref)


# ------------------------------------------------------------ front door --
def test_front_door_streamed(tmp_path):
    """strategy="streamed" runs the streamed driver over the source's
    provider (never materialized), with the workdir lifecycle."""
    S = _S(np.float64)
    direct = _stream(S, tau=1e-5, tile_m=40)
    b = build_basis(source=S, strategy="streamed", tau=1e-5, tile_m=40,
                    device=CPU)
    assert b.k == direct.k and b.provenance["strategy"] == "streamed"
    assert b.provenance["stop"] == STOP_NAMES[direct.stop]
    assert torch.equal(b.Q, direct.Q[:, :b.k])
    np.testing.assert_array_equal(b.R, _np(direct.R)[:b.k])
    assert b.provenance["spec"]["tile_m"] == 40
    wd = str(tmp_path / "wd")
    b1 = build_basis(source=S, strategy="streamed", tau=1e-5, tile_m=40,
                     keep_R=False, workdir=wd, device=CPU)
    assert b1.R is None and not os.path.exists(os.path.join(wd, "build"))
    b2 = build_basis(source=S, strategy="streamed", tau=1e-5, tile_m=40,
                     keep_R=False, workdir=wd, resume=True, device=CPU)
    assert torch.equal(b2.Q, b1.Q)


def test_waveform_spec_through_the_front_door():
    f = frequency_grid(20.0, 256.0, 200)
    m1, m2 = chirp_grid(n_mc=11, n_eta=7)
    spec = ReductionSpec.waveform(f, m1, m2, dtype=torch.complex128,
                                  normalize=False, strategy="streamed",
                                  tau=1e-2, tile_m=20, device=CPU)
    assert isinstance(spec.source, WaveformProvider)
    assert spec.source.device == torch.device(CPU)
    b = build_basis(spec)
    ref = ts.rb_greedy_streamed(spec.source, tau=1e-2, tile_m=20)
    assert b.k == ref.k > 3
    np.testing.assert_array_equal(b.pivots, _np(ref.pivots)[:b.k])
    assert b.provenance["stop"] in ("STOP_TAU", "STOP_RANK")
    assert b.provenance["spec"]["source"]["kind"] == "WaveformProvider"


# ---------------------------------------------------- state carried across --
class _JaxCrashing(jp.ArrayProvider):
    def __init__(self, S, budget):
        super().__init__(S)
        self.budget = budget

    def tile(self, lo, hi):
        if self.budget <= 0:
            raise IOError("injected crash")
        self.budget -= 1
        return super().tile(lo, hi)


@pytest.mark.parametrize("dtype,p,budget", [
    (np.float64, 1, 13), (np.complex128, 1, 7), (np.float64, 3, 9)])
def test_jax_midsweep_checkpoint_resumes_in_port(tmp_path, dtype, p,
                                                 budget):
    """A mid-sweep streaming checkpoint written by the JAX package resumes
    in the port (its backend ``xla`` under the port's ``auto``) and
    finishes with the reference's pivots and stop code."""
    S = _S(dtype)
    kw = dict(tau=TAU[dtype], tile_m=33, block_p=p)
    ref = js.rb_greedy_streamed(jp.ArrayProvider(S), backend="xla", **kw)
    ck = tmp_path / "ck"
    with pytest.raises(IOError, match="injected crash"):
        js.rb_greedy_streamed(_JaxCrashing(S, budget), backend="xla",
                              checkpoint_dir=ck, checkpoint_every_tiles=1,
                              **kw)
    tree = jio.load_checkpoint_raw(str(ck))
    assert int(tree["pending"]) == 1 and str(tree["backend"]) == "xla"
    got = _stream(S, checkpoint_dir=ck, resume=True, **kw)
    _assert_matches_jax(ref, got, dtype, S.shape[0], S if p > 1 else None)
    assert got.stop in (STOP_TAU, STOP_RANK)
