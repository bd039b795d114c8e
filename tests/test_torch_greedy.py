"""The port's greedy driver vs the JAX reference, and its own contracts:
chunked == stepwise, the refresh and floor stop, kill-and-resume bit
identity, and the resident checkpoint tree shared with the reference.

Inputs are made with numpy and handed to both packages; the port runs on
the CPU (``device="cpu"``), where its wrappers take the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import dtype_tol, make_smooth_matrix

from repro.core import greedy as jg
from repro.core.errors import orthogonality_defect as jax_defect
from repro.core.errors import per_column_errors as jax_pce
from repro_torch.core import greedy as tg
from repro_torch.core.errors import (
    orthogonality_defect, per_column_errors, proj_error_fro, proj_error_max,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = [np.float32, np.complex64, np.float64, np.complex128]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _parity_tau(S):
    """Above the Eq.-(6.3) cancellation floor, where the pivot order does
    not hang on float summation order (the reference's own cross-backend
    parity tests keep the same margin): 1e-2 of the column scale in
    single precision, 1e-6 in double."""
    if S.dtype in (np.float32, np.complex64):
        return 1e-2 * float(np.linalg.norm(S, axis=0).max())
    return 1e-6


def _assert_parity(port, ref, dtype, N):
    """pivots, k, stop and pass counts exact; Q/R/errs/rnorms within
    dtype_tol.  Basis vector j is a residual of size errs[j] scaled up to
    unit norm, so its rounding grows by scale / errs[j]: the tolerance of
    Q's column j and R's row j carries that factor (R also scales with the
    column norms).  errs come from Eq. (6.3), err^2 = |s|^2 - sum|c|^2,
    whose absolute error is ~eps * scale^2: err itself is then off by
    that over err."""
    k = int(ref.k)
    assert port.k == k and k >= 5
    assert int(port.stop) == int(ref.stop)
    np.testing.assert_array_equal(_np(port.pivots), _np(ref.pivots))
    np.testing.assert_array_equal(_np(port.n_ortho_passes),
                                  _np(ref.n_ortho_passes))
    tol = dtype_tol(dtype, N)
    scale = float(np.abs(_np(ref.R)).max())
    grow = np.ones(_np(ref.errs).shape)
    grow[:k] = scale / _np(ref.errs)[:k]
    for name, atol in (("Q", tol * grow[None, :]),
                       ("R", tol * scale * grow[:, None])):
        diff = np.abs(_np(getattr(port, name)) - _np(getattr(ref, name)))
        assert np.all(diff <= atol), (name, float((diff / atol).max()))
    err_ref = _np(ref.errs)[:k]
    grow_sq = scale / np.maximum(err_ref, tol * scale)
    diff = np.abs(_np(port.errs)[:k] - err_ref)
    assert np.all(diff <= tol * scale * (1 + grow_sq)), "errs"
    # rnorm j is measured against the earlier basis vectors, so it
    # carries their amplified rounding: the largest grow factor before j
    prior = np.maximum.accumulate(np.concatenate([[1.0], grow[:k - 1]]))
    diff = np.abs(_np(port.rnorms)[:k] - _np(ref.rnorms)[:k])
    assert np.all(diff <= tol * scale * prior), "rnorms"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("driver", ["rb_greedy", "rb_greedy_stepwise"])
def test_driver_matches_jax(dtype, driver):
    S = make_smooth_matrix(n=150, m=90, dtype=dtype)
    tau = _parity_tau(S)
    ref = jg.rb_greedy(jnp.asarray(S), tau=tau, backend="xla")
    port = getattr(tg, driver)(S, tau, device="cpu")
    _assert_parity(port, ref, dtype, S.shape[0])


def _assert_identical(a, b):
    assert a.k == b.k and a.stop == b.stop
    for name in ("Q", "R", "pivots", "errs", "n_ortho_passes", "rnorms"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("dtype,tau", [
    (np.float64, 1e-10),    # refresh path, then tau
    (np.float64, 1e-12),    # refresh path, then rank guard
    (np.float32, 1e-3),     # below the f32 floor: rank guard
    (np.complex64, 1e-2),   # tau stop mid-chunk
])
def test_chunk_sizes_and_stepwise_agree(dtype, tau):
    """The latched device stop code makes every chunk size, and the
    stepwise oracle, the same build bit for bit."""
    S = make_smooth_matrix(dtype=dtype)
    one = tg.rb_greedy(S, tau, chunk=1, device="cpu")
    _assert_identical(one, tg.rb_greedy(S, tau, chunk=16, device="cpu"))
    _assert_identical(one, tg.rb_greedy(S, tau, chunk=7, device="cpu"))
    _assert_identical(one, tg.rb_greedy_stepwise(S, tau, device="cpu"))


@pytest.mark.parametrize("tau,stop", [(1e-10, tg.STOP_TAU),
                                      (1e-12, tg.STOP_RANK)])
def test_refresh_then_stop_matches_jax(tau, stop):
    """The f64 scenarios above refresh and then stop where the reference
    does, at the same rank."""
    S = make_smooth_matrix(dtype=np.float64)
    seen = []
    res = tg.rb_greedy(S, tau, chunk=1, device="cpu",
                       callback=lambda st: seen.append(
                           float(st.norms_sq.max())))
    assert seen[-1] < 1e-6 * seen[0]  # a refresh reset the reference norms
    ref = jg.rb_greedy(jnp.asarray(S), tau, backend="xla")
    assert res.stop == int(ref.stop) == stop
    assert res.k == int(ref.k)


def floor_regime_matrix(seed=7, N=200, M=160, r=50, sigma=1.45e-7):
    """f32 family whose exact residual plateaus above a tiny tau (the
    reference's fault-matrix floor scenario, same construction)."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((N, r)))
    V, _ = np.linalg.qr(rng.standard_normal((M, r)))
    sv = np.logspace(0, -4, r)
    return ((U * sv) @ V.T + sigma * rng.standard_normal((N, M))).astype(
        np.float32)


def test_floor_stop_matches_jax():
    """Refresh, then STOP_FLOOR above tau, as the reference ends."""
    S = floor_regime_matrix()
    tau, safety = 1e-7, 2e6
    ref = jg.rb_greedy(jnp.asarray(S), tau, refresh_safety=safety,
                       backend="xla")
    port = tg.rb_greedy(S, tau, refresh_safety=safety, device="cpu")
    assert int(ref.stop) == port.stop == tg.STOP_FLOOR
    assert float(port.errs[port.k - 1]) > tau
    # the pivots agree until the residual sinks into the noise floor
    lead = 40
    assert port.k >= lead and int(ref.k) >= lead
    np.testing.assert_array_equal(_np(port.pivots)[:lead],
                                  _np(ref.pivots)[:lead])


class _Crash(RuntimeError):
    pass


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_kill_and_resume_bit_identical(tmp_path, dtype):
    """A build killed after its second chunk and resumed from the newest
    checkpoint equals the uninterrupted build bit for bit."""
    S = make_smooth_matrix(dtype=dtype)
    tau = 1e-12 if dtype == np.complex128 else 1e-3
    full = tg.rb_greedy(S, tau, chunk=3, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    calls = []

    def die(state):
        calls.append(int(state.k))
        if len(calls) == 3:
            raise _Crash

    with pytest.raises(_Crash):
        tg.rb_greedy(S, tau, chunk=3, device="cpu", checkpoint_dir=ckpt,
                     callback=die)
    resumed = tg.rb_greedy(S, tau, chunk=3, device="cpu",
                           checkpoint_dir=ckpt, resume=True)
    _assert_identical(full, resumed)
    # a finished checkpoint short-circuits to the same result
    _assert_identical(full, tg.rb_greedy(S, tau, chunk=3, device="cpu",
                                         checkpoint_dir=ckpt, resume=True))


def test_resident_tree_shared_with_jax(tmp_path):
    """A resident checkpoint the reference wrote resumes in the port: same
    keys, version and dtypes, and the port finishes the build with the
    reference's pivots."""
    S = make_smooth_matrix(n=150, m=90, dtype=np.float64)
    tau = _parity_tau(S)
    ckpt = str(tmp_path / "jax")
    ref = jg.rb_greedy(jnp.asarray(S), tau, chunk=2, backend="xla",
                       checkpoint_dir=ckpt)
    jtree = jg.load_resident_checkpoint(ckpt)
    state, *_ = tg.resident_state_from_tree(jtree, "cpu")
    ptree = tg.resident_state_tree(state, float(jtree["ref_sq"]),
                                   float(jtree["scale"]),
                                   bool(jtree["done"]), int(jtree["stop"]))
    assert ptree.keys() == jtree.keys()
    for key in jtree:
        assert ptree[key].dtype == jtree[key].dtype, key
        np.testing.assert_array_equal(ptree[key], jtree[key])
    # resume a mid-build reference checkpoint (drop the finished steps)
    mid = str(tmp_path / "mid")
    jg.rb_greedy(jnp.asarray(S), tau, max_k=4, chunk=2, backend="xla",
                 checkpoint_dir=mid)
    tree = jg.load_resident_checkpoint(mid)
    assert int(tree["k"]) == 4
    port = tg.rb_greedy(S, tau, max_k=4, chunk=2, device="cpu",
                        checkpoint_dir=mid, resume=True)
    np.testing.assert_array_equal(_np(port.pivots), _np(ref.pivots)[:4])


@pytest.mark.parametrize("dtype", DTYPES)
def test_imgs_orthogonalize_masked_passes(rng, dtype):
    """The masked fixed-count loop equals the reference's while_loop: pass
    counts exact (1 for a well-separated v, > 1 for v nearly in span Q)."""
    N, K = 120, 10
    Q, _ = np.linalg.qr(rng.standard_normal((N, K)))
    Q = np.ascontiguousarray(np.pad(Q, ((0, 0), (0, 4))).astype(dtype))
    tol = dtype_tol(dtype, N)
    for frac in (1.0, 1e-4):
        v = (Q[:, :K] @ rng.standard_normal(K)
             + frac * rng.standard_normal(N)).astype(dtype)
        q, c, rn, n = tg.imgs_orthogonalize(torch.from_numpy(v),
                                            torch.from_numpy(Q))
        qr, cr, rnr, nr = jg.imgs_orthogonalize(jnp.asarray(v),
                                                jnp.asarray(Q))
        assert int(n) == int(nr)
        np.testing.assert_allclose(_np(c), np.asarray(cr), rtol=tol,
                                   atol=tol)
        assert abs(float(rn) - float(rnr)) <= tol * np.linalg.norm(v)
        # q is the normalized residual: its error is relative to rnorm
        np.testing.assert_allclose(_np(q), np.asarray(qr),
                                   atol=tol * np.linalg.norm(v) / float(rnr))


@pytest.mark.parametrize("dtype", DTYPES)
def test_refresh_and_errors_match_jax(dtype):
    """greedy_refresh's chunked exact residuals and the error identities
    agree with the reference within dtype_tol (column norms are ~1-5)."""
    S = make_smooth_matrix(n=150, m=90, dtype=dtype)
    port = tg.rb_greedy(S, _parity_tau(S), device="cpu")
    k = port.k
    Q = port.Q[:, :k].contiguous()
    St = torch.from_numpy(S)
    tol = dtype_tol(dtype, S.shape[0])
    want = np.asarray(jax_pce(jnp.asarray(S), jnp.asarray(_np(Q))))
    got = per_column_errors(St, Q, col_chunk=32)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    assert abs(float(proj_error_max(St, Q)) - want.max()) <= tol
    assert abs(float(proj_error_fro(St, Q))
               - np.linalg.norm(want)) <= tol * np.sqrt(S.shape[1])
    assert abs(float(orthogonality_defect(Q))
               - float(jax_defect(jnp.asarray(_np(Q))))) <= tol
    state = tg.greedy_init(St, port.Q.shape[1])
    state.Q.copy_(port.Q)
    state = tg.greedy_refresh(St, state, col_chunk=32)
    np.testing.assert_allclose(_np(state.norms_sq), want ** 2, rtol=tol,
                               atol=tol * want.max())
    assert float(state.acc.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_stop_latched_mid_chunk_matches_stepwise_and_jax(dtype):
    """A build whose stop latches inside its first chunk of 16 (the later
    steps masked, their kernels told so by the active flag) gives the
    stepwise oracle's build bit for bit, and the reference's pivots, k,
    errs and stop code."""
    S = make_smooth_matrix(n=150, m=90, dtype=dtype)
    tau = _parity_tau(S)
    port = tg.rb_greedy(S, tau, max_k=24, chunk=16, device="cpu")
    assert port.stop == tg.STOP_TAU and port.k + 1 < 16  # latched mid-chunk
    _assert_identical(port, tg.rb_greedy_stepwise(S, tau, max_k=24,
                                                  device="cpu"))
    ref = jg.rb_greedy(jnp.asarray(S), tau=tau, max_k=24, chunk=16,
                       backend="xla")
    _assert_parity(port, ref, dtype, S.shape[0])


def test_masked_steps_hand_false_flags_to_the_kernels(monkeypatch):
    """Every step of a chunk up to the latched stop hands its sweep and its
    first GS pass a true flag; every later step a false one, and a re-run
    pass the re-run test too.  So the sweeps that read S number the steps
    up to the latch."""
    from repro_torch.core import backend as be

    sweeps, first, rerun = [], [], []
    pivot_update, project_pass = be.pivot_update, be.project_pass

    def spy_update(*args, active=None, **kw):
        sweeps.append(bool(active))
        return pivot_update(*args, active=active, **kw)

    def spy_project(v, Q, backend=None, active=None):
        (first if len(first) == len(sweeps) else rerun).append(bool(active))
        return project_pass(v, Q, backend=backend, active=active)

    monkeypatch.setattr(be, "pivot_update", spy_update)
    monkeypatch.setattr(be, "project_pass", spy_project)
    S = make_smooth_matrix(n=150, m=90, dtype=np.complex64)
    res = tg.rb_greedy(S, _parity_tau(S), max_k=24, chunk=16, device="cpu")
    live = res.k + 1  # the latched step's basis was dropped
    assert sweeps == [True] * live + [False] * (16 - live)
    assert first == sweeps
    assert len(rerun) == 2 * 16 and not any(rerun[2 * live:])
    # a re-run pass of an accepted step is live where its pass counted
    assert sum(rerun[:2 * res.k]) == int(
        res.n_ortho_passes[:res.k].sum()) - res.k
