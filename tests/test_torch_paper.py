"""The paper's oracles in the port against the JAX reference: POD and its
error identities (Thm 3.2), the optimal RRQR (Thm 5.1), pivoted MGS
(Prop. 5.3, front door and deprecated entry), the reconstruction approach
(Alg. 4, Thm 5.11), the fixed-length greedy driver, R22 and the
determinant identity (Cor. 5.7) — then the reference's own test cases of
those modules, on the port alone.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU (``device="cpu"``).  SVD and QR factors are unique
only up to a phase per column, and LAPACK inside XLA and inside PyTorch
may pick different phases, so factors are compared through invariants:
singular values, projectors ``V V^H`` onto the spans, errors, ``|R|`` on
the diagonal.  Ranks and pivots are compared exactly.  Singular values are
held to ``1e-10 sigma_1`` in double precision and ``dtype_tol sigma_1`` in
single; a projector onto k singular vectors to that over the gap
``sigma_k - sigma_{k+1}`` (Wedin's bound, with a factor 10).
"""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from conftest import dtype_tol, make_smooth_matrix

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.core.errors import proj_error_2norm, proj_error_max
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the packages' ``core`` export functions under some modules' names (``pod``,
# ``reconstruction``), so the modules are taken from the import system
(jerr, jgreedy, jmgs, jpod, jrec, jrrqr, terr, tgreedy, tmgs, tpod, trec,
 trrqr) = (importlib.import_module(f"{pkg}.core.{mod}")
           for pkg in ("repro", "repro_torch")
           for mod in ("errors", "greedy", "mgs", "pod", "reconstruction",
                       "rrqr"))

DOUBLE = [np.float64, np.complex128]
ALL = [np.float32, np.complex64, np.float64, np.complex128]
CPU = "cpu"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(dtype, n):
    """Relative agreement of singular values and errors across packages:
    1e-10 in double precision, dtype_tol in single."""
    if np.dtype(dtype) in (np.float64, np.complex128):
        return 1e-10
    return dtype_tol(dtype, n)


def _proj(V):
    V = _np(V)
    return V @ V.conj().T


def _low_rank(n, m, r, dtype, seed):
    """A random rank-r matrix plus 1e-9 noise (the reference's
    ``test_equivalence_random`` family)."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        x = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(shape)
        return x

    return (rand(n, r) @ rand(r, m) + 1e-9 * rand(n, m)).astype(dtype)


def _family(name, dtype):
    if name == "smooth":
        return make_smooth_matrix(n=150, m=90, dtype=dtype)
    return _low_rank(60, 40, 7, dtype, seed=11)


def _span_distance(Q1, Q2):
    """sin of the largest principal angle between the column spans."""
    s = np.linalg.svd(_np(Q1).conj().T @ _np(Q2), compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - np.min(s) ** 2)))


def _greedy_span_close(Qp, Qr, errs, scale, tol):
    """Projectors onto two greedy / MGS bases agree: basis vector j is a
    residual of size errs[j] scaled to unit norm, so its rounding grows by
    scale / errs[j]; the smallest err bounds them all (factor 10)."""
    atol = 10 * tol * scale / float(np.min(_np(errs)))
    np.testing.assert_allclose(_proj(Qp), _proj(Qr), atol=atol, rtol=0)


def _errs_close(port, ref, scale, tol):
    """Greedy / MGS errors: each err comes from |s|^2 - sum |c|^2 or a norm
    of a deflated column, off by ~tol * scale^2 / err in absolute terms."""
    port, ref = _np(port), _np(ref)
    grow = scale / np.maximum(ref, tol * scale)
    assert np.all(np.abs(port - ref) <= tol * scale * (1 + grow)), \
        float(np.max(np.abs(port - ref) / (tol * scale * (1 + grow))))


# ------------------------------------------------------------------ POD --
@pytest.mark.parametrize("family", ["smooth", "low_rank"])
@pytest.mark.parametrize("dtype", ALL)
def test_pod_matches_jax(family, dtype):
    """Algorithm 1: the same k; singular values and the projector onto the
    tolerance-selected basis agree."""
    S = _family(family, dtype)
    sig_np = np.linalg.svd(S.astype(np.complex128), compute_uv=False)
    tau = 1e-3 * sig_np[0]
    ref = jpod.pod(jnp.asarray(S), tau)
    port = tpod.pod(S, tau, device=CPU)
    k = int(ref.k)
    assert port.k == k and 1 <= k < len(sig_np)
    rel = _rel(dtype, S.shape[0])
    s0 = float(ref.sigmas[0])
    np.testing.assert_allclose(_np(port.sigmas), _np(ref.sigmas),
                               atol=rel * s0, rtol=0)
    gap = float(ref.sigmas[k - 1] - ref.sigmas[k])
    np.testing.assert_allclose(_proj(port.basis[:, :k]),
                               _proj(ref.basis[:, :k]),
                               atol=10 * rel * s0 / gap, rtol=0)
    np.testing.assert_allclose(_proj(tpod.pod_basis(S, k, device=CPU)),
                               _proj(jpod.pod_basis(jnp.asarray(S), k)),
                               atol=10 * rel * s0 / gap, rtol=0)


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("k", [1, 5, 10])
def test_pod_errors_match_jax(dtype, k):
    """Thm 3.2's two error functionals agree across the packages."""
    S = make_smooth_matrix(dtype=dtype)
    rel = _rel(dtype, S.shape[0])
    s0 = float(np.linalg.norm(S, 2))
    for jf, tf in ((jpod.pod_error_2norm, tpod.pod_error_2norm),
                   (jpod.pod_error_fro, tpod.pod_error_fro)):
        ref = float(jf(jnp.asarray(S), k))
        port = float(tf(S, k, device=CPU))
        assert abs(port - ref) <= rel * s0, (jf.__name__, port, ref)


# ----------------------------------------------------------------- RRQR --
@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("k", [3, 8])
def test_optimal_rrqr_matches_jax(dtype, k):
    """Theorem 5.1: singular values, the span of Qk (projector), |diag R|
    and the rank-k error agree; Qk is orthonormal."""
    S = make_smooth_matrix(dtype=dtype)
    ref = jrrqr.optimal_rrqr(jnp.asarray(S), k)
    port = trrqr.optimal_rrqr(S, k, device=CPU)
    rel = _rel(dtype, S.shape[0])
    s0 = float(ref.sigmas[0])
    np.testing.assert_allclose(_np(port.sigmas), _np(ref.sigmas),
                               atol=rel * s0, rtol=0)
    gap = float(ref.sigmas[k - 1] - ref.sigmas[k])
    np.testing.assert_allclose(_proj(port.Qk), _proj(ref.Qk),
                               atol=10 * rel * s0 / gap, rtol=0)
    np.testing.assert_allclose(np.abs(np.diag(_np(port.R))),
                               np.abs(np.diag(_np(ref.R))),
                               atol=10 * rel * s0, rtol=0)
    assert tuple(port.R.shape) == tuple(ref.R.shape) == (k, S.shape[1])
    e_ref = float(jrrqr.rrqr_error_2norm(jnp.asarray(S), ref.Qk))
    e_port = float(trrqr.rrqr_error_2norm(torch.as_tensor(S), port.Qk))
    assert abs(e_port - e_ref) <= 10 * rel * s0
    G = _np(port.Qk.mH @ port.Qk)
    np.testing.assert_allclose(G, np.eye(k), atol=dtype_tol(dtype, S.shape[0]))


# ------------------------------------------------------------------ MGS --
@pytest.mark.parametrize("family", ["smooth", "low_rank"])
@pytest.mark.parametrize("dtype", ALL)
def test_mgs_matches_jax(family, dtype):
    """Algorithm 2 through both front doors: k and pivots exact, R(j, j)
    (the artifact's errs) within the error model, the same span; the
    artifact has no backend, as the reference's."""
    S = _family(family, dtype)
    scale = float(np.linalg.norm(S, axis=0).max())
    tau = (1e-2 if np.dtype(dtype) in (np.float32, np.complex64)
           else 1e-6) * scale
    ref = japi.build_basis(source=S, strategy="mgs", tau=tau)
    port = tapi.build_basis(source=S, strategy="mgs", tau=tau, device=CPU)
    assert port.k == ref.k >= 3
    np.testing.assert_array_equal(port.pivots, ref.pivots)
    assert port.pivots.dtype == np.int32
    tol = dtype_tol(dtype, S.shape[0])
    _errs_close(port.errs, ref.errs, scale, tol)
    _greedy_span_close(port.Q, ref.Q, ref.errs, scale, tol)
    assert port.provenance["backend"] is None is ref.provenance["backend"]
    assert port.provenance["strategy"] == "mgs"
    assert port.R.shape == ref.R.shape


@pytest.mark.parametrize("dtype", DOUBLE)
def test_mgs_deprecated_entry_matches_jax(dtype):
    """``mgs_pivoted_qr`` warns in both packages and returns the oracle's
    result: pivots, k, r_diag and |diag of R at the pivots|."""
    S = make_smooth_matrix(dtype=dtype)
    with pytest.warns(DeprecationWarning, match="build_basis"):
        port = tmgs.mgs_pivoted_qr(S, 1e-6, device=CPU)
    with pytest.warns(DeprecationWarning):
        ref = jmgs.mgs_pivoted_qr(jnp.asarray(S), 1e-6)
    assert port.k == ref.k >= 5
    np.testing.assert_array_equal(_np(port.pivots), _np(ref.pivots))
    scale = float(np.linalg.norm(S, axis=0).max())
    tol = dtype_tol(dtype, S.shape[0])
    _errs_close(port.r_diag, ref.r_diag, scale, tol)
    piv = _np(port.pivots)
    _errs_close(np.abs(_np(port.R)[np.arange(port.k), piv]),
                np.abs(_np(ref.R)[np.arange(ref.k), piv]), scale, tol)
    impl = tmgs._mgs_pivoted_qr_impl(S, 1e-6, device=CPU)
    assert torch.equal(impl.Q, port.Q) and torch.equal(impl.R, port.R)


# ------------------------------------------------------- reconstruction --
@pytest.mark.parametrize("dtype", ALL)
def test_reconstruction_matches_jax(dtype):
    """Algorithm 4: j and k exact; the singular values of R and the span of
    X[:, :k] agree."""
    S = make_smooth_matrix(n=150, m=90, dtype=dtype)
    scale = float(np.linalg.norm(S, axis=0).max())
    single = np.dtype(dtype) in (np.float32, np.complex64)
    tau1, tau2 = ((1e-2 * scale, 1e-1 * scale) if single
                  else (1e-6, 1e-5))
    ref = jrec.reconstruction(jnp.asarray(S), tau1, tau2)
    port = trec.reconstruction(S, tau1, tau2, device=CPU)
    assert port.j == ref.j >= 4
    assert 2 <= port.k == int(ref.k) < port.j
    rel = _rel(dtype, S.shape[0])
    s0 = float(ref.sigmas_R[0])
    # R comes out of the greedy, whose rows carry the Eq.-(6.3) rounding
    tol = 100 * dtype_tol(dtype, S.shape[0])
    np.testing.assert_allclose(_np(port.sigmas_R), _np(ref.sigmas_R),
                               atol=tol * s0, rtol=0)
    k = port.k
    gap = float(ref.sigmas_R[k - 1] - ref.sigmas_R[k])
    np.testing.assert_allclose(_proj(port.X[:, :k]), _proj(ref.X[:, :k]),
                               atol=10 * tol * s0 / gap + rel, rtol=0)
    g = tgreedy.rb_greedy(S, tau1, device=CPU)
    _greedy_span_close(port.Qj, ref.Qj, g.errs[:port.j], scale,
                       dtype_tol(dtype, S.shape[0]))


# ----------------------------------------------------- the scan driver --
@pytest.mark.parametrize("family", ["smooth", "low_rank"])
@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("max_k", [6, 24])
def test_rb_greedy_scan_matches_jax(family, dtype, max_k):
    """The fixed-length driver: k and the whole pivot array exact (the -1
    a masked step leaves, and the untouched slots), pass counts exact,
    errs within the Eq.-(6.3) model, the same span."""
    S = _family(family, dtype)
    scale = float(np.linalg.norm(S, axis=0).max())
    tau = (1e-2 if np.dtype(dtype) in (np.float32, np.complex64)
           else 1e-6) * scale
    ref = jgreedy.rb_greedy_scan(jnp.asarray(S), tau, max_k)
    port = tgreedy.rb_greedy_scan(S, tau, max_k, device=CPU)
    k = int(ref.k)
    assert int(port.k) == k >= 3
    np.testing.assert_array_equal(_np(port.pivots), _np(ref.pivots))
    if k < max_k:
        assert int(port.pivots[k]) == -1
    np.testing.assert_array_equal(_np(port.n_ortho_passes)[:k],
                                  _np(ref.n_ortho_passes)[:k])
    tol = dtype_tol(dtype, S.shape[0])
    _errs_close(port.errs[:k], ref.errs[:k], scale, tol)
    _greedy_span_close(port.Q[:, :k], ref.Q[:, :k], ref.errs[:k], scale, tol)
    # masked slots past k hold zero basis vectors
    assert bool((port.Q[:, k:] == 0).all())


@pytest.mark.parametrize("dtype", DOUBLE)
def test_rb_greedy_scan_matches_chunked_driver(dtype):
    """Above the cancellation floor and with no tau drop in play, the
    fixed-length driver picks rb_greedy's pivots."""
    S = make_smooth_matrix(dtype=dtype)
    full = tgreedy.rb_greedy(S, 1e-6, device=CPU)
    scan = tgreedy.rb_greedy_scan(S, 1e-6, full.k + 3, device=CPU)
    assert int(scan.k) == full.k
    assert torch.equal(scan.pivots[:full.k], full.pivots[:full.k])
    assert torch.equal(scan.Q[:, :full.k], full.Q[:, :full.k])


# ----------------------------------------------- error identities ------
@pytest.mark.parametrize("dtype", DOUBLE)
@pytest.mark.parametrize("ord", [2, "fro"])
def test_r22_norm_matches_jax(dtype, ord):
    R = np.triu(_low_rank(30, 30, 30, dtype, seed=3))
    for k in (0, 5, 17):
        ref = float(jerr.r22_norm(jnp.asarray(R), k, ord=ord))
        port = float(terr.r22_norm(torch.as_tensor(R), k, ord=ord))
        assert port == pytest.approx(ref, rel=1e-12)


def test_determinant_identity_matches_jax():
    """Cor. 5.7 (the reference's case: a well-conditioned 30 x 12 S): the
    (k+1)-th greedy error equals the ratio of the pivoted submatrix's
    singular values to the earlier errors, and both packages compute the
    same ratio from the same inputs."""
    rng = np.random.default_rng(1)
    U, _, Vt = np.linalg.svd(rng.standard_normal((30, 12)),
                             full_matrices=False)
    S = U @ np.diag(np.linspace(3.0, 1.0, 12)) @ Vt
    res = tgreedy.rb_greedy(S, tau=1e-12, device=CPU)
    for k in (3, 6):
        sig = np.linalg.svd(S[:, _np(res.pivots[:k + 1])], compute_uv=False)
        port = float(terr.greedy_error_determinant_identity(
            torch.as_tensor(sig), res.errs, k))
        ref = float(jerr.greedy_error_determinant_identity(
            jnp.asarray(sig), jnp.asarray(_np(res.errs)), k))
        assert port == pytest.approx(ref, rel=1e-12)
        assert float(res.errs[k]) == pytest.approx(port, rel=1e-6)


# ----------------------------------------------------- the front door --
@pytest.mark.parametrize("strategy", ["pod", "mgs"])
@pytest.mark.parametrize("dtype", [np.complex64, np.float64])
def test_build_basis_pod_mgs_matches_jax(strategy, dtype):
    """The front door: k, pivots (empty for POD), errs (sigmas / R(j, j)),
    the span, R's presence and every provenance key of the reference's."""
    S = make_smooth_matrix(n=150, m=90, dtype=dtype)
    scale = float(np.linalg.norm(S, axis=0).max())
    tau = (1e-2 * scale if dtype == np.complex64 else 1e-6)
    ref = japi.build_basis(source=S, strategy=strategy, tau=tau, max_k=9)
    port = tapi.build_basis(source=S, strategy=strategy, tau=tau, max_k=9,
                            device=CPU)
    assert port.k == ref.k >= 3
    np.testing.assert_array_equal(port.pivots, ref.pivots)
    assert port.pivots.dtype == ref.pivots.dtype == np.int32
    tol = dtype_tol(dtype, S.shape[0])
    _errs_close(port.errs, ref.errs, scale, tol)
    if strategy == "mgs":
        _greedy_span_close(port.Q, ref.Q, ref.errs, scale, tol)
    else:   # the basis is the leading singular vectors: the gap bounds it
        s0, gap = ref.errs[0], ref.errs[-1] - float(np.linalg.svd(
            S, compute_uv=False)[ref.k])
        np.testing.assert_allclose(_proj(port.Q), _proj(ref.Q),
                                   atol=10 * _rel(dtype, S.shape[0]) * s0
                                   / gap, rtol=0)
    assert (port.R is None) == (ref.R is None) == (strategy == "pod")
    assert set(ref.provenance) <= set(port.provenance)
    for key in ("strategy", "requested_strategy", "backend", "dtype",
                "shape"):
        assert port.provenance[key] == ref.provenance[key], key


def test_pod_artifact_round_trips_across_packages(tmp_path):
    """A POD artifact (no R, empty pivots) saved by the port loads in the
    reference with the same arrays."""
    S = make_smooth_matrix(dtype=np.complex128)
    port = tapi.build_basis(source=S, strategy="pod", tau=1e-8, device=CPU)
    port.save(str(tmp_path))
    back = japi.ReducedBasis.load(str(tmp_path))
    assert back.k == port.k and back.R is None
    np.testing.assert_array_equal(np.asarray(back.Q), _np(port.Q))
    np.testing.assert_array_equal(np.asarray(back.errs), port.errs)
    assert np.asarray(back.pivots).shape == (0,)


# ------------------------- the reference's own cases, on the port alone --
# tests/test_pod.py
@pytest.mark.parametrize("dtype", DOUBLE)
def test_port_pod_2norm_identity(dtype):
    """Thm 3.2(ii): |S - V_k V_k^H S|_2 == sigma_{k+1}."""
    S = make_smooth_matrix(dtype=dtype)
    sig = np.linalg.svd(S, compute_uv=False)
    for k in (1, 5, 10):
        err = float(tpod.pod_error_2norm(S, k, device=CPU))
        assert err == pytest.approx(float(sig[k]), rel=1e-8, abs=1e-12)


@pytest.mark.parametrize("dtype", DOUBLE)
def test_port_pod_fro_identity(dtype):
    """Thm 3.2(i): |S - V_k V_k^H S|_F^2 == sum_{j>k} sigma_j^2."""
    S = make_smooth_matrix(dtype=dtype)
    sig = np.linalg.svd(S, compute_uv=False)
    for k in (1, 5, 10):
        err = float(tpod.pod_error_fro(S, k, device=CPU)) ** 2
        assert err == pytest.approx(float(np.sum(sig[k:] ** 2)),
                                    rel=1e-8, abs=1e-12)


def test_port_pod_tolerance_selection():
    """Algorithm 1 picks the smallest k with sigma_{k+1} < tau."""
    res = tpod.pod(make_smooth_matrix(), tau=1e-6, device=CPU)
    k = res.k
    sig = _np(res.sigmas)
    assert sig[k] < 1e-6
    assert k == 0 or sig[k - 1] >= 1e-6
    assert tpod.pod(make_smooth_matrix(), tau=0.0, device=CPU).k == len(sig)


def test_port_pod_optimality_vs_random_basis(rng):
    """POD beats an arbitrary orthonormal basis in both norms (Eq. 3.1)."""
    S = torch.as_tensor(make_smooth_matrix())
    k = 8
    Vk = tpod.pod_basis(S, k, device=CPU)
    Q = torch.as_tensor(np.linalg.qr(rng.standard_normal((S.shape[0], k)))[0])
    for ord in (2, "fro"):
        pod_err = float(torch.linalg.matrix_norm(S - Vk @ (Vk.mH @ S), ord))
        rand_err = float(torch.linalg.matrix_norm(S - Q @ (Q.mT @ S), ord))
        assert pod_err <= rand_err


# tests/test_rrqr.py
@pytest.mark.parametrize("dtype", DOUBLE)
@pytest.mark.parametrize("k", [3, 8, 15])
def test_port_optimal_rrqr_matches_pod_error(dtype, k):
    """|S - Q_k Q_k^H S|_2 == sigma_{k+1} (POD-optimal, Eq. 5.5)."""
    S = torch.as_tensor(make_smooth_matrix(dtype=dtype))
    res = trrqr.optimal_rrqr(S, k, device=CPU)
    err = float(trrqr.rrqr_error_2norm(S, res.Qk))
    assert err == pytest.approx(float(res.sigmas[k]), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("k", [3, 6])
def test_port_optimal_rrqr_exactness_low_precision(dtype, k):
    """Theorem-5.1 exactness in the GW production dtypes, up to an
    eps*sqrt(N)-scaled absolute floor set by sigma_1."""
    S = torch.as_tensor(make_smooth_matrix(dtype=dtype))
    res = trrqr.optimal_rrqr(S, k, device=CPU)
    err = float(trrqr.rrqr_error_2norm(S, res.Qk))
    sig0, sigk = float(res.sigmas[0]), float(res.sigmas[k])
    assert abs(err - sigk) <= dtype_tol(dtype, n=S.shape[0],
                                        factor=100.0) * sig0


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 5_000), k=st.integers(1, 8))
def test_port_optimal_rrqr_exactness_property_complex64(seed, k):
    """Property: Thm-5.1 exactness on random complex64 low-rank + noise
    matrices, and an orthonormal basis at working precision."""
    rng = np.random.default_rng(seed)
    n, m, r = 30, 24, k + 2
    A = (rng.standard_normal((n, r)) + 1j * rng.standard_normal((n, r))) @ \
        (rng.standard_normal((r, m)) + 1j * rng.standard_normal((r, m)))
    A = A + 1e-4 * (rng.standard_normal((n, m))
                    + 1j * rng.standard_normal((n, m)))
    S = torch.as_tensor(A.astype(np.complex64))
    res = trrqr.optimal_rrqr(S, k, device=CPU)
    err = float(trrqr.rrqr_error_2norm(S, res.Qk))
    sig0, sigk = float(res.sigmas[0]), float(res.sigmas[k])
    assert abs(err - sigk) <= dtype_tol(np.complex64, n=n,
                                        factor=100.0) * sig0
    G = _np(res.Qk.mH @ res.Qk)
    assert np.allclose(G, np.eye(k), atol=dtype_tol(np.complex64, n=n))


def test_port_optimal_rrqr_orthonormal():
    res = trrqr.optimal_rrqr(make_smooth_matrix(), 10, device=CPU)
    assert np.allclose(_np(res.Qk.mH @ res.Qk), np.eye(10), atol=1e-10)


def test_port_exact_rank_reconstruction(rng):
    """Cor 5.2: ordinary rank k => S == Q_k R exactly."""
    k = 6
    A = rng.standard_normal((40, k)) @ rng.standard_normal((k, 25))
    res = trrqr.optimal_rrqr(A, k, device=CPU)
    assert np.allclose(_np(res.Qk @ res.R), A, atol=1e-10)


def test_port_rrqr_error_bounds_interlace():
    """sigma_{k+1} <= |S - QQ^H S|_2 for ANY rank-k orthonormal Q, with
    equality for the Thm-5.1 construction."""
    S = torch.as_tensor(make_smooth_matrix())
    sig = np.linalg.svd(_np(S), compute_uv=False)
    g = tgreedy.rb_greedy(S, tau=1e-10, device=CPU)
    for k in (3, 6, 9):
        greedy_err = float(proj_error_2norm(S, g.Q[:, :k]))
        assert greedy_err >= sig[k] - 1e-10
        opt_err = float(trrqr.rrqr_error_2norm(
            S, trrqr.optimal_rrqr(S, k, device=CPU).Qk))
        assert opt_err <= greedy_err + 1e-10


# tests/test_reconstruction.py
@pytest.mark.parametrize("dtype", DOUBLE)
def test_port_reconstruction_matches_pod_when_r22_small(dtype):
    """Rem 5.13: with |R22| ~ eps the reconstructed basis behaves like
    POD."""
    S = torch.as_tensor(make_smooth_matrix(dtype=dtype))
    sig = np.linalg.svd(_np(S), compute_uv=False)
    res = trec.reconstruction(S, tau1=1e-13, tau2=1e-10, device=CPU)
    k = res.k
    err = float(proj_error_2norm(S, res.X[:, :k]))
    assert err <= 20 * max(float(sig[k]), 1e-14)


def test_port_reconstruction_beats_plain_greedy_at_same_rank():
    """The SVD rotation enriches the basis (Rem 5.9)."""
    S = torch.as_tensor(make_smooth_matrix())
    res = trec.reconstruction(S, tau1=1e-12, tau2=1e-9, device=CPU)
    g = tgreedy.rb_greedy(S, tau=1e-12, device=CPU)
    for k in (4, 6, 8):
        rec_err = float(proj_error_2norm(S, res.X[:, :k]))
        greedy_err = float(proj_error_2norm(S, g.Q[:, :k]))
        assert rec_err <= greedy_err * 1.5 + 1e-14


def test_port_theorem_5_11_bound():
    """|S - X_j X_j^H S|_2 <= sigma(S1)_{j+1} + |R22|_2."""
    S = torch.as_tensor(make_smooth_matrix())
    res = trec.reconstruction(S, tau1=1e-10, tau2=1e-8, device=CPU)
    S1 = res.Qj @ tgreedy.rb_greedy(S, tau=1e-10, device=CPU).R[:res.j, :]
    sig1 = np.linalg.svd(_np(S1), compute_uv=False)
    r22 = float(torch.linalg.matrix_norm(S - S1, ord=2))
    for jj in (3, 5):
        lhs = float(proj_error_2norm(S, res.X[:, :jj]))
        assert lhs <= (float(sig1[jj]) + r22) * (1 + 1e-8) + 1e-12


# tests/test_equivalence.py
def _mgs(S, tau):
    return tapi.build_basis(source=S, strategy="mgs", tau=tau, device=CPU)


@pytest.mark.parametrize("dtype", DOUBLE)
def test_port_equivalence_smooth(dtype):
    """Prop 5.3: the same pivots, R(j, j) == the greedy errors, the same
    span."""
    S = make_smooth_matrix(dtype=dtype)
    g = tgreedy.rb_greedy(S, tau=1e-4, device=CPU)
    m = _mgs(S, 1e-4)
    k = g.k
    assert m.k == k
    np.testing.assert_array_equal(_np(g.pivots[:k]), m.pivots)
    assert np.allclose(_np(g.errs[:k]), m.errs, rtol=1e-6)
    assert _span_distance(g.Q[:, :k], m.Q) < 1e-5


@pytest.mark.parametrize("dtype", DOUBLE)
def test_port_functional_equivalence_deep(dtype):
    """At deep tolerance both deliver a basis meeting tau, with identical
    error sequences (Cor 5.6) up to the first tie-break divergence."""
    S = make_smooth_matrix(dtype=dtype)
    tau = 1e-8
    g = tgreedy.rb_greedy(S, tau=tau, device=CPU)
    m = _mgs(S, tau)
    assert abs(m.k - g.k) <= 1
    kk = min(g.k, m.k)
    gp, mp = _np(g.pivots[:kk]), m.pivots[:kk]
    j_div = next((i for i in range(kk) if gp[i] != mp[i]), kk)
    assert j_div >= min(kk, 8)
    assert np.allclose(_np(g.errs[:j_div]), m.errs[:j_div], rtol=1e-3)
    St = torch.as_tensor(S)
    assert float(proj_error_max(St, g.Q[:, :g.k])) < tau * 1.01
    # plain MGS deflation loses ~kappa(S)*eps of true accuracy (Rem 5.5)
    assert float(proj_error_max(St, m.Q)) < 1e-5


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(12, 60),
       m=st.integers(8, 40), rank=st.integers(3, 8),
       use_complex=st.booleans())
def test_port_equivalence_random(seed, n, m, rank, use_complex):
    """Property (Prop 5.3) on random low-rank + noise matrices, real and
    complex: the same pivots and span."""
    rng = np.random.default_rng(seed)
    rank = min(rank, n, m)

    def rand(*shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if use_complex else x

    S = rand(n, rank) @ rand(rank, m) + 1e-9 * rand(n, m)
    tau = 1e-6 * float(np.linalg.norm(S, ord=2))
    g = tgreedy.rb_greedy(S, tau=tau, device=CPU)
    ms = _mgs(S, tau)
    k = min(g.k, ms.k)
    assert k >= 1
    np.testing.assert_array_equal(_np(g.pivots[:k]), ms.pivots[:k])
    assert _span_distance(g.Q[:, :k], ms.Q[:, :k]) < 1e-4


def test_port_equivalence_gw_waveforms():
    """Unnormalized GW snapshots (normalized ones tie at iteration 0)."""
    from repro_torch.gw import chirp_grid, frequency_grid
    from repro_torch.gw.waveform import taylorf2_batch

    f = torch.as_tensor(frequency_grid(20.0, 256.0, 300))
    m1, m2 = chirp_grid(n_mc=16, n_eta=5)
    S = taylorf2_batch(f, torch.as_tensor(m1[:60]), torch.as_tensor(m2[:60]),
                       normalize=False, dtype=torch.complex128)
    tau = 1e-5 * float(torch.linalg.vector_norm(S, dim=0).max())
    g = tgreedy.rb_greedy(S, tau=tau, device=CPU)
    m = _mgs(S, tau)
    assert m.k == g.k
    np.testing.assert_array_equal(_np(g.pivots[:g.k]), m.pivots)


def test_mgs_holds_one_working_copy():
    """The deflation is in place: MGS's working matrix is one copy of S
    (Remark 5.4), and the caller's S is left untouched."""
    S = torch.as_tensor(make_smooth_matrix())
    before = S.clone()
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # the impl itself never warns
        res = tmgs._mgs_pivoted_qr_impl(S, 1e-6, device=CPU)
    assert torch.equal(S, before)
    assert res.k >= 5 and tuple(res.R.shape) == (res.k, S.shape[1])
