"""The port's blocked RB-greedy (``strategy="block_greedy"``) vs the JAX
reference, and its own contracts: chunked == stepwise, first-index ties,
the adaptive width, kill-and-resume bit identity and the ``max_k`` cap.

Inputs are made with numpy and handed to both packages; the port runs on
the CPU (``device="cpu"``), where its wrappers take the plain versions.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import dtype_tol, make_smooth_matrix

from repro.core import block_greedy as jb
from repro.core import greedy as jg
from repro_torch.core import block_greedy as tb
from repro_torch.core import greedy as tg
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOW = (np.float32, np.complex64)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def blocked_family(dtype, seed=3, N=160, M=120, r=40):
    """Snapshots of rank r with singular values from 1 to 1e-4 and generic
    (random) column mixing.

    The parity family of the blocked drivers.  On the smooth family of
    conftest, neighbouring columns are nearly parallel, so the stale picks
    of a wide block land just above the rank guard (residual ~ 50 eps
    scale): such a basis vector is rounding noise, and everything swept
    with it after differs at the level of the residual itself, between
    the reference's own two backends too.  Here the 8th pick of a block
    still keeps ~1e-3 of the scale, so the parity is about the port, not
    about noise."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((N, r)))[0]
    V = rng.standard_normal((r, M))
    if np.issubdtype(dtype, np.complexfloating):
        U = U * np.exp(1j * rng.uniform(0, 2 * np.pi, (1, r)))
        V = V + 1j * rng.standard_normal((r, M))
    return ((U * np.logspace(0, -4, r)) @ V).astype(dtype)


def _parity_tau(S):
    """Above the Eq.-(6.3) cancellation floor, where no near-tie decides a
    pivot: 1e-2 of the column scale in single precision, 1e-3 in double."""
    rel = 1e-2 if S.dtype in LOW else 1e-3
    return rel * float(np.linalg.norm(S, axis=0).max())


def _assert_block_parity(port, ref, dtype, N):
    """k, stop, pivots and pass counts exact; Q/R/errs/rnorms within
    dtype_tol, grown as in test_torch_greedy._assert_parity: basis vector
    j is a residual scaled up to unit norm, so its rounding grows by
    scale / r_j.  A blocked pick's recorded err is its stale pre-block
    residual, so r_j is read off the true orthogonalization residual, the
    diagonal entry |R[j, pivot_j]|.  Vector j is also measured against the
    earlier vectors and carries their amplified rounding, as rnorm j does
    in _assert_parity: Q's column j and R's row j take the largest growth
    up to j.  (A stale pick can sit just above the rank guard, r_j ~
    50 eps scale: its column is rounding noise in both packages and the
    bound on it is vacuous; its pivot is still compared exactly.)"""
    k = int(ref.k)
    assert port.k == k and k >= 5
    assert int(port.stop) == int(ref.stop)
    np.testing.assert_array_equal(_np(port.pivots), _np(ref.pivots))
    np.testing.assert_array_equal(_np(port.n_ortho_passes),
                                  _np(ref.n_ortho_passes))
    tol = dtype_tol(dtype, N)
    R_ref = _np(ref.R)
    scale = float(np.abs(R_ref).max())
    piv = _np(ref.pivots)[:k]
    grow = np.ones(R_ref.shape[0])
    grow[:k] = scale / np.abs(R_ref[np.arange(k), piv])
    upto = np.maximum.accumulate(grow)
    for name, atol in (("Q", tol * upto[None, :]),
                       ("R", tol * scale * upto[:, None])):
        diff = np.abs(_np(getattr(port, name)) - _np(getattr(ref, name)))
        assert np.all(diff <= atol), (name, float((diff / atol).max()))
    err_ref = _np(ref.errs)[:k]
    grow_sq = scale / np.maximum(err_ref, tol * scale)
    diff = np.abs(_np(port.errs)[:k] - err_ref)
    assert np.all(diff <= tol * scale * (1 + grow_sq)), "errs"
    prior = np.maximum.accumulate(np.concatenate([[1.0], grow[:k - 1]]))
    diff = np.abs(_np(port.rnorms)[:k] - _np(ref.rnorms)[:k])
    assert np.all(diff <= tol * scale * prior), "rnorms"


def _assert_identical(a, b, fields=("Q", "R", "pivots", "errs",
                                    "n_ortho_passes", "rnorms")):
    assert a.k == b.k and a.stop == b.stop
    for name in fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ------------------------------------------------- drivers vs reference ----
@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.complex128])
@pytest.mark.parametrize("panel", [True, False])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_chunked_driver_matches_jax(dtype, panel, p):
    S = blocked_family(dtype)
    tau = _parity_tau(S)
    ref = jb._rb_greedy_block_impl(jnp.asarray(S), tau=tau, p=p,
                                   backend="xla", panel=panel)
    port = tb._rb_greedy_block_impl(S, tau=tau, p=p, panel=panel,
                                    device="cpu")
    _assert_block_parity(port, ref, dtype, S.shape[0])


@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.complex128])
@pytest.mark.parametrize("p", [2, 8])
def test_chunked_driver_matches_jax_literal_backend(dtype, p):
    """The reference's literal ops (``xla_ref``, complex GEMMs included)."""
    S = blocked_family(dtype)
    tau = _parity_tau(S)
    ref = jb._rb_greedy_block_impl(jnp.asarray(S), tau=tau, p=p,
                                   backend="xla_ref")
    port = tb._rb_greedy_block_impl(S, tau=tau, p=p, device="cpu",
                                    backend="ref")
    _assert_block_parity(port, ref, dtype, S.shape[0])


@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.complex128])
@pytest.mark.parametrize("panel", [True, False])
@pytest.mark.parametrize("p", [2, 8])
def test_stepwise_driver_matches_jax(dtype, panel, p):
    S = blocked_family(dtype)
    tau = _parity_tau(S)
    ref = jb.rb_greedy_block_stepwise(jnp.asarray(S), tau=tau, p=p,
                                      backend="xla", panel=panel)
    port = tb.rb_greedy_block_stepwise(S, tau=tau, p=p, panel=panel,
                                       device="cpu")
    _assert_block_parity(port, ref, dtype, S.shape[0])


def test_duplicate_columns_tie_to_first_index():
    """Every column twice: the residuals tie exactly, the first index of
    each pair wins (jax.lax.top_k's order), and its twin in the same
    block is rank-rejected — in the reference and in the port."""
    S = np.repeat(make_smooth_matrix(n=150, m=45, dtype=np.complex128), 2,
                  axis=1)
    ref = jb._rb_greedy_block_impl(jnp.asarray(S), tau=1e-4, p=4,
                                   backend="xla")
    port = tb._rb_greedy_block_impl(S, tau=1e-4, p=4, device="cpu")
    piv = _np(port.pivots)[:port.k]
    assert port.k >= 5 and np.all(piv % 2 == 0)
    np.testing.assert_array_equal(_np(port.pivots), _np(ref.pivots))
    assert port.k == int(ref.k) and port.stop == int(ref.stop)


# -------------------------------------------------- the port's own rules ----
@pytest.mark.parametrize("dtype,tau", [
    (np.float32, 1e-3),      # below the f32 floor: the rank guard stops
    (np.complex64, 1e-2),
    (np.complex128, 1e-8),   # refresh path
    (np.float64, 1e-12),     # refresh, then rank guard / floor
])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_chunked_equals_stepwise(dtype, tau, p):
    """The latched device stop code makes every chunk size and the
    stepwise oracle the same build, bit for bit (the oracle records no
    rnorms / pass counts, as the reference's)."""
    S = make_smooth_matrix(dtype=dtype)
    one = tb._rb_greedy_block_impl(S, tau, p=p, chunk=1, device="cpu")
    _assert_identical(one, tb._rb_greedy_block_impl(S, tau, p=p, chunk=5,
                                                    device="cpu"))
    _assert_identical(one, tb.rb_greedy_block_stepwise(S, tau, p=p,
                                                       device="cpu"),
                      fields=("Q", "R", "pivots", "errs"))


def test_stop_codes_match_jax_below_parity():
    """Deep tau: the refresh fires and both packages stop the same way."""
    S = make_smooth_matrix(dtype=np.float64)
    for tau in (1e-10, 1e-12):
        ref = jb._rb_greedy_block_impl(jnp.asarray(S), tau, p=4,
                                       backend="xla")
        port = tb._rb_greedy_block_impl(S, tau, p=4, device="cpu")
        assert port.stop == int(ref.stop)
        assert abs(port.k - int(ref.k)) <= 4


def test_top_p_first_index_on_ties():
    """Equal residuals come out in increasing index order, as
    jax.lax.top_k orders them."""
    res = np.array([0, 3, 1, 3, 3, 0, 2, 0, 0], np.float32)
    for p in (1, 3, 4, 6, 9):
        vals, idx = tb.top_p(torch.from_numpy(res), p)
        jvals, jidx = jax.lax.top_k(jnp.asarray(res), p)
        np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
        np.testing.assert_array_equal(_np(vals), np.asarray(jvals))


# ------------------------------------------------ panel orthogonalization --
def _panel_case(rng, kind, dtype):
    N, K = 120, 9
    Q = np.linalg.qr(rng.standard_normal((N, K)))[0]
    Q = np.pad(Q, ((0, 0), (0, 3)))  # zero columns are no-ops
    a, b, c = (rng.standard_normal(N) for _ in range(3))
    if kind == "rank_guard":        # column 1 is column 0 halved
        V = np.stack([a, 0.5 * a, b], axis=1)
    elif kind == "reortho":         # column 1 nearly on column 0
        V = np.stack([a, a + 1e-3 * b, c], axis=1)
    else:                           # nearly in span Q: vs-Q re-runs
        V = Q[:, :K] @ rng.standard_normal((K, 3)) \
            + 1e-4 * np.stack([a, b, c], axis=1)
    if np.issubdtype(dtype, np.complexfloating):
        V = V * np.exp(1j * np.linspace(0, 1, N))[:, None]
    return V.astype(dtype), Q.astype(dtype)


@pytest.mark.parametrize("backend", ["xla", "xla_ref"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex64, np.complex128])
@pytest.mark.parametrize("kind", ["rank_guard", "reortho", "near_span"])
def test_panel_imgs_orthogonalize_matches_jax(rng, kind, dtype, backend):
    V, Q = _panel_case(rng, kind, dtype)
    eps = float(np.finfo(dtype).eps)
    thresh = 50.0 * eps * float(np.linalg.norm(V, axis=0).max())
    P, oks, rn, npass = tg.panel_imgs_orthogonalize(
        torch.from_numpy(V), torch.from_numpy(Q), thresh=thresh)
    Pj, oksj, rnj, npassj = jg.panel_imgs_orthogonalize(
        jnp.asarray(V), jnp.asarray(Q), thresh=thresh, backend=backend)
    np.testing.assert_array_equal(_np(oks), np.asarray(oksj))
    # a rejected candidate's residual is rounding noise, and so is its
    # kappa test: pass counts are compared on the accepted columns
    acc = np.asarray(oksj)
    np.testing.assert_array_equal(_np(npass)[acc], np.asarray(npassj)[acc])
    if kind == "rank_guard":
        assert list(_np(oks)) == [True, False, True]
        assert np.all(_np(P)[:, 1] == 0)
    if kind == "reortho":
        assert _np(npass)[1] == int(np.asarray(npassj)[1]) >= 2
    if kind == "near_span":
        assert np.all(_np(npass) >= 2)
    tol = dtype_tol(dtype, V.shape[0])
    vnorm = float(np.linalg.norm(V, axis=0).max())
    np.testing.assert_allclose(_np(rn), np.asarray(rnj), rtol=0,
                               atol=tol * vnorm)
    # each column is a residual scaled to unit norm: its rounding grows
    # by |V| / rnorm
    grow = vnorm / np.maximum(np.asarray(rnj), tol * vnorm)
    assert np.all(np.abs(_np(P) - np.asarray(Pj)) <= tol * grow[None, :])


def test_reortho_branch_runs_where_the_reference_runs_it(rng):
    """The always-computed re-orthogonalization is selected exactly where
    the reference's lax.cond takes it: the pass count carries the cycle,
    and the panel is orthonormal against Q in both cases."""
    for kind, fired in (("reortho", True), ("rank_guard", False)):
        V, Q = _panel_case(rng, kind, np.float64)
        P, oks, rn, npass = tg.panel_imgs_orthogonalize(
            torch.from_numpy(V), torch.from_numpy(Q), thresh=1e-12)
        _, _, _, npassj = jg.panel_imgs_orthogonalize(
            jnp.asarray(V), jnp.asarray(Q), thresh=1e-12, backend="xla")
        n_col_plus_cycle = _np(npass)[0]  # column 0 has no in-panel rerun
        assert n_col_plus_cycle == int(np.asarray(npassj)[0])
        assert (n_col_plus_cycle == 2) == fired
        G = np.concatenate([Q[:, :9], _np(P)[:, _np(oks)]], axis=1)
        assert np.abs(G.T @ G - np.eye(G.shape[1])).max() \
            < dtype_tol(np.float64, V.shape[0])


# ------------------------------------------ adaptive width, resume, cap ----
def _rank_deficient(rng, dtype=np.float64):
    A = rng.standard_normal((60, 6)) @ rng.standard_normal((6, 40))
    return A.astype(dtype)


@pytest.mark.parametrize("dtype,chunk", [(np.complex64, 4),
                                         (np.float32, 2)])
def test_adaptive_trajectory_matches_jax(dtype, chunk):
    """The reference's adaptive scenario (smooth family, tau 1e-3): the
    wide first block is mostly rejected, the width halves."""
    S = make_smooth_matrix(dtype=dtype)
    d_ref, d_port = {}, {}
    ref = jb._rb_greedy_block_impl(jnp.asarray(S), 1e-3, p=8, chunk=chunk,
                                   backend="xla", adaptive=True,
                                   diagnostics=d_ref)
    port = tb._rb_greedy_block_impl(S, 1e-3, p=8, chunk=chunk,
                                    device="cpu", adaptive=True,
                                    diagnostics=d_port)
    assert d_port["p_trajectory"] == d_ref["p_trajectory"]
    assert any(e["p"] < 8 for e in d_port["p_trajectory"])
    assert port.k == int(ref.k) and port.stop == int(ref.stop)
    np.testing.assert_array_equal(_np(port.pivots), _np(ref.pivots))


class _Crash(RuntimeError):
    pass


@pytest.mark.parametrize("dtype,adaptive", [(np.float32, False),
                                            (np.complex128, True)])
def test_kill_and_resume_bit_identical(tmp_path, dtype, adaptive):
    """A build killed after its second chunk and resumed from the newest
    checkpoint equals the uninterrupted build bit for bit; the live width
    rides along."""
    S = make_smooth_matrix(dtype=dtype)
    tau = 1e-3 if dtype == np.float32 else 1e-10
    kw = dict(p=4, chunk=1, device="cpu", adaptive=adaptive)
    full = tb._rb_greedy_block_impl(S, tau, **kw)
    ckpt = str(tmp_path / "ckpt")
    calls = []

    def die(state):
        calls.append(int(state.k))
        if len(calls) == 3:
            raise _Crash

    with pytest.raises(_Crash):
        tb._rb_greedy_block_impl(S, tau, checkpoint_dir=ckpt, callback=die,
                                 **kw)
    tree = tg.load_resident_checkpoint(ckpt)
    assert "p_live" in tree
    resumed = tb._rb_greedy_block_impl(S, tau, checkpoint_dir=ckpt,
                                       resume=True, **kw)
    _assert_identical(full, resumed)
    _assert_identical(full, tb._rb_greedy_block_impl(
        S, tau, checkpoint_dir=ckpt, resume=True, **kw))


@pytest.mark.parametrize("p", [1, 4])
def test_max_k_caps_accepted_bases(p):
    S = make_smooth_matrix(dtype=np.float32)
    for res in (tb._rb_greedy_block_impl(S, 1e-12, p=p, max_k=6,
                                         device="cpu"),
                tb.rb_greedy_block_stepwise(S, 1e-12, p=p, max_k=6,
                                            device="cpu")):
        assert res.k == 6
        assert np.all(_np(res.pivots)[:6] >= 0)
        assert np.all(_np(res.Q)[:, 6:] == 0)


def test_rejected_candidates_leave_no_holes(rng):
    """Rank-rejected in-block candidates are compacted away: the Q columns
    up to k are unit vectors, the rest zero, pivots[:k] >= 0 — and the
    build is the reference's."""
    A = _rank_deficient(rng)
    res = tb._rb_greedy_block_impl(A, tau=1e-12, p=4, device="cpu")
    ref = jb._rb_greedy_block_impl(jnp.asarray(A), tau=1e-12, p=4,
                                   backend="xla")
    k = res.k
    assert k <= 7 and k == int(ref.k) and res.stop == int(ref.stop)
    norms = np.linalg.norm(_np(res.Q), axis=0)
    np.testing.assert_allclose(norms[:k], 1.0, rtol=1e-12)
    assert np.all(norms[k:] == 0.0)
    assert np.all(_np(res.pivots)[:k] >= 0)
    assert np.all(_np(res.pivots)[k:] == 0)
    np.testing.assert_array_equal(_np(res.pivots), _np(ref.pivots))


def test_deprecated_entry_point_warns_and_delegates():
    S = make_smooth_matrix(dtype=np.complex64)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        old = tb.rb_greedy_block(S, 1e-3, p=4, device="cpu")
    assert any(issubclass(w.category, DeprecationWarning) for w in seen)
    _assert_identical(old, tb._rb_greedy_block_impl(S, 1e-3, p=4,
                                                    device="cpu"))
