"""The port's randomized range-finder (``repro_torch.core.randomized``) and
its test-block generator against the JAX reference, on the CPU.

The generator draws the reference's own test matrix
(``repro.core.randomized._test_block``): the keys (``PRNGKey``,
``fold_in``), the raw Threefry bits and every rademacher block bit for
bit; a gaussian block within ``GAUSS_TOL`` of the reference, relative to
``max(1, |omega|)``.  Only ``erfinv`` differs there (XLA's polynomial
against PyTorch's), most in the tails, and far less in float64 than the
float32 tolerance.

Given that test matrix, the port's sketch gives the reference's k, ell,
passes and tiling exactly, and its singular-value estimates, column norms
and projector ``QQ^H`` within tolerance.  A QR's column phases differ
across LAPACK builds, so with ``power >= 1`` Y itself is not compared
across the packages; the projector is, on the leading vectors whose
spectral gap makes them well determined (Davis-Kahan: a perturbation
``eta * sigma_1`` of Y moves the span of the first r singular vectors by
at most ~``eta * sigma_1 / (sigma_r - sigma_{r+1})``).  Within the port,
resume and reruns are bitwise.

The reference's ``test_sketch_primitives_no_complex_dot`` (a TPU lowering
contract: complex products split into real planes) and the ``"auto"``
cases (the roofline, ROADMAP queue 1 item 8) are not ported.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_smooth_matrix
from repro.api import build_basis as jax_build_basis
from repro.checkpoint import io as jio
from repro.core import randomized as jr
from repro.data import providers as jp
from repro_torch.api import ReducedBasis, build_basis
from repro_torch.core import randomized as tr
from repro_torch.core.backend import sketch_fold, sketch_project
from repro_torch.core.errors import proj_error_max
from repro_torch.data import (
    ArrayProvider, FaultPlan, FaultyProvider, MemmapProvider,
    WaveformProvider, write_snapshot_npy,
)
from repro_torch.gw import chirp_grid, frequency_grid
from repro_torch.kernels.sketch_omega import ops as so_ops
from repro_torch.kernels.sketch_omega import ref as so_ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
SEEDS = [0, 7, 2 ** 40 + 3]
TORCH = {np.float32: torch.float32, np.float64: torch.float64,
         np.complex64: torch.complex64, np.complex128: torch.complex128}
DTYPES = list(TORCH)
# |port - reference| <= GAUSS_TOL * max(1, |omega|) on a gaussian draw
GAUSS_TOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-10,
             np.complex128: 1e-10}
# relative perturbation of a sketch between the packages: the gaussian
# draws' erfinv and the products' summation order, ~10x margin each
ETA = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-10,
       np.complex128: 1e-10}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _real(dtype):
    return np.zeros((), dtype).real.dtype


def _rank_family(dtype, r=8, seed=5):
    """An exactly rank-r (200, 120) family of unit scale: its first r
    singular values sit far above the rest (~eps), a clear gap at any tau
    between."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((200, r))
    B = rng.standard_normal((r, 120))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((200, r))
    L = A @ B
    return (L / np.abs(L).max()).astype(dtype)


# -------------------------------------------------------- the generator ----
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    """PRNGKey (x64: a seed past 2^32 keeps its high word) and fold_in by
    tile and by part, bitwise."""
    key = jax.random.PRNGKey(seed)
    assert tuple(int(x) for x in np.asarray(key)) == so_ref.prng_key(seed)
    for t in (0, 1, 49, 2 ** 31 + 5):
        kt = jax.random.fold_in(key, t)
        want = tuple(int(x) for x in np.asarray(kt))
        assert so_ref.fold_in(so_ref.prng_key(seed), t) == want
        parts = so_ref.block_keys(seed, t, True)
        for i in (0, 1):
            got = tuple(int(x) for x in np.asarray(jax.random.fold_in(kt, i)))
            assert parts[i] == got
        assert so_ref.block_keys(seed, t, False) == (want,)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed):
    """Element i is threefry2x32(key, (i >> 32, i & 0xffffffff)): JAX's
    32-bit draws are bits1 ^ bits2, its 64-bit ones (bits1 << 32) |
    bits2."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    k = so_ref.fold_in(so_ref.prng_key(seed), 3)
    b1, b2 = (_np(b).astype(np.uint64) for b in so_ref.random_bits(k, 4097))
    j32 = np.asarray(jax.random.bits(key, (4097,), jnp.uint32))
    j64 = np.asarray(jax.random.bits(key, (4097,), jnp.uint64))
    np.testing.assert_array_equal(j32.astype(np.uint64), b1 ^ b2)
    np.testing.assert_array_equal(j64, (b1 << np.uint64(32)) | b2)


@pytest.mark.parametrize("kind", ["gaussian", "rademacher"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (7, 25), (4097, 1), (33, 5)])
def test_plain_block_matches_jax(shape, dtype, kind):
    """The plain generator against ``_test_block`` for every dtype and kind
    at ragged shapes, seeds and tiles: rademacher bitwise, gaussian within
    GAUSS_TOL (erfinv only)."""
    for seed, tile in zip(SEEDS, (0, 49, 7)):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), tile)
        ref = np.asarray(jr._test_block(key, shape, dtype, kind))
        got = _np(so_ref.sketch_omega_ref(seed, tile, shape, TORCH[dtype],
                                          kind))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if kind == "rademacher":
            np.testing.assert_array_equal(got, ref)
        else:
            err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
            assert err.max() <= GAUSS_TOL[dtype], (seed, tile, err.max())


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU ``out`` gets the plain version (no launch counted); an unknown
    kind, dtype or device raises."""
    n0 = so_ops.launches
    out = torch.empty((5, 3), dtype=torch.complex64)
    got = so_ops.sketch_omega(2 ** 40 + 3, 4, out, "rademacher")
    assert got is out and so_ops.launches == n0
    assert torch.equal(out, so_ref.sketch_omega_ref(
        2 ** 40 + 3, 4, (5, 3), torch.complex64, "rademacher"))
    with pytest.raises(ValueError, match="kind"):
        so_ops.sketch_omega(0, 0, out, "srht")
    with pytest.raises(ValueError, match="dtype"):
        so_ops.sketch_omega(0, 0, torch.empty((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        so_ops.sketch_omega(0, 0, torch.empty((2, 2), device="meta"))


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_sketch_primitives_match_jax(rng, dtype):
    """sketch_fold and sketch_project compute the reference's products
    (both of its backends), within the summation-order rounding."""
    from repro.core import backend as jb

    N, M, L = 40, 30, 8

    def mk(s):
        x = rng.standard_normal(s)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(s)
        return x.astype(dtype)

    T, Om, Y = mk((N, M)), mk((M, L)), mk((N, L))
    tol = 200 * np.finfo(_real(dtype)).eps
    t = [torch.from_numpy(a) for a in (T, Om, Y)]
    for bk in ("xla", "xla_ref"):
        np.testing.assert_allclose(
            _np(sketch_fold(*t)), np.asarray(jb.sketch_fold(T, Om, Y, bk)),
            rtol=tol, atol=tol)
        np.testing.assert_allclose(
            _np(sketch_project(t[0], t[2])),
            np.asarray(jb.sketch_project(T, Y, bk)), rtol=tol, atol=tol)


# ---------------------------------------------- the sketch vs reference ----
def _lead_projector_gap(svals, k, eta):
    """The largest r <= k whose spectral gap bounds the movement of the
    first r singular vectors below 1e-3 under a relative perturbation
    eta of Y, and that bound (10 eta sigma_1 / gap_r); (0, None) if
    none."""
    best = (0, None)
    for r in range(1, min(k, len(svals) - 1) + 1):
        gap = float(svals[r - 1] - svals[r])
        bound = 10.0 * eta * float(svals[0]) / gap if gap > 0 else math.inf
        if bound <= 1e-3:
            best = (r, bound)
    return best


def _assert_sketch_matches_jax(ref, got, dtype, N):
    assert (got.k, got.ell, got.n_passes, got.n_tiles) == \
        (ref.k, ref.ell, ref.n_passes, ref.n_tiles)
    assert (got.sketch_p, got.power, got.seed, got.kind) == \
        (ref.sketch_p, ref.power, ref.seed, ref.kind)
    eta = ETA[dtype]
    assert got.svals.dtype == ref.svals.dtype
    np.testing.assert_allclose(got.svals, ref.svals, rtol=0,
                               atol=10 * eta * float(ref.svals[0]))
    eps = np.finfo(_real(dtype)).eps
    norms = np.asarray(ref.norms_sq)
    np.testing.assert_allclose(_np(got.norms_sq), norms, rtol=0,
                               atol=10 * eps * math.sqrt(N) * norms.max())
    Q = _np(got.Q)
    assert Q.dtype == np.dtype(dtype) and Q.shape == (N, got.k)
    r, bound = _lead_projector_gap(ref.svals, ref.k, eta)
    assert r >= 3, "the case leaves no well-separated leading vectors"
    Qa = np.asarray(ref.Q)[:, :r].astype(np.complex128)
    Qb = Q[:, :r].astype(np.complex128)
    diff = np.linalg.norm(Qa @ Qa.conj().T - Qb @ Qb.conj().T, 2)
    assert diff <= bound, (r, diff, bound)


@pytest.mark.parametrize("kind", ["gaussian", "rademacher"])
@pytest.mark.parametrize("power", [0, 1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_matches_jax(dtype, power, kind):
    """The smooth family at tile_m 32 (a ragged last tile) with tau None,
    and a rank-8 family at tile_m 40 with tau in its gap: the same k, ell,
    passes and tiles; sigma_hat, the norms and the leading projector
    within tolerance."""
    cases = (
        (make_smooth_matrix(200, 120, dtype=dtype), 32, None),
        (_rank_family(dtype), 40, 1e-3),
    )
    for S, tile_m, tau in cases:
        kw = dict(tau=tau, max_k=15, sketch_p=10, power=power, kind=kind,
                  tile_m=tile_m, seed=11)
        ref = jr.rb_randomized_streamed(S, **kw)
        got = tr.rb_randomized_streamed(S, device=CPU, **kw)
        _assert_sketch_matches_jax(ref, got, dtype, S.shape[0])
        if tau is not None:
            assert got.k == 8


# ------------------------------------------------ the reference's tests ----
def _proj_err_fro(S, Q):
    S = np.asarray(S, np.complex128 if np.iscomplexobj(S) else np.float64)
    Q = _np(Q).astype(S.dtype)
    return float(np.linalg.norm(S - Q @ (Q.conj().T @ S)))


def _assert_range_finder_bound(S, res, max_k, sketch_p, slack=4.0):
    """Halko et al. Thm. 10.5 in expectation, with the reference's slack
    and its dtype floor."""
    sig = np.linalg.svd(
        np.asarray(S, np.complex128 if np.iscomplexobj(S) else np.float64),
        compute_uv=False)
    tail = float(np.sqrt(np.sum(sig[max_k:] ** 2)))
    err = _proj_err_fro(S, res.Q)
    bound = math.sqrt(1.0 + max_k / (sketch_p - 1)) * tail
    eps = np.finfo(_np(res.Q).real.dtype).eps
    floor = 100.0 * eps * float(np.linalg.norm(sig))
    assert err <= slack * bound + floor, (err, bound, floor)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("provider", ["array", "memmap"])
def test_sketch_quality_matrix(tmp_path, dtype, provider):
    """{f32, c64} x {array, memmap}: one pass, orthonormal Q of the
    provider's dtype, the range-finder bound, the column norms."""
    S = make_smooth_matrix(200, 120, dtype=dtype)
    if provider == "memmap":
        src = MemmapProvider(write_snapshot_npy(tmp_path / "S.npy", S),
                             device=CPU)
    else:
        src = ArrayProvider(torch.from_numpy(S), device=CPU)
    res = tr.rb_randomized_streamed(src, tau=None, max_k=15, sketch_p=10,
                                    tile_m=32)
    assert res.k == 15 and res.ell == 25 and res.n_passes == 1
    Q = _np(res.Q)
    assert Q.dtype == np.dtype(dtype)
    assert np.abs(Q.conj().T @ Q - np.eye(res.k)).max() < 1e-4
    _assert_range_finder_bound(S, res, max_k=15, sketch_p=10)
    np.testing.assert_allclose(_np(res.norms_sq),
                               np.sum(np.abs(S) ** 2, axis=0), rtol=1e-4)


def test_sketch_quality_waveform():
    """Columns generated on the fly (WaveformProvider): the same bound, and
    the reference's sigma_hat on the same grid."""
    f = frequency_grid(20.0, 256.0, 200)
    m1, m2 = chirp_grid(n_mc=11, n_eta=7)
    prov = WaveformProvider(f, m1, m2, dtype=torch.complex64, device=CPU)
    S = _np(prov.tile(0, prov.shape[1]))
    res = tr.rb_randomized_streamed(prov, tau=None, max_k=12, sketch_p=10,
                                    tile_m=16)
    assert res.n_passes == 1
    _assert_range_finder_bound(S, res, max_k=12, sketch_p=10)
    ref = jr.rb_randomized_streamed(S, tau=None, max_k=12, sketch_p=10,
                                    tile_m=16)
    np.testing.assert_allclose(res.svals, ref.svals, rtol=0,
                               atol=1e-4 * float(ref.svals[0]))


def test_power_iteration_sharpens_sigma_estimates():
    """power >= 1: Ritz values within 1e-3 of the true spectrum, closer than
    power 0's estimates, and no worse a projection."""
    S = make_smooth_matrix(200, 120, dtype=np.float64)
    sig = np.linalg.svd(S, compute_uv=False)
    r0 = tr.rb_randomized_streamed(S, tau=None, max_k=15, sketch_p=10,
                                   tile_m=40, device=CPU)
    r1 = tr.rb_randomized_streamed(S, tau=None, max_k=15, sketch_p=10,
                                   power=1, tile_m=40, device=CPU)
    assert r1.n_passes == 3
    np.testing.assert_allclose(r1.svals[:10], sig[:10], rtol=1e-3)
    e0 = np.abs(r0.svals[:10] - sig[:10]) / sig[:10]
    e1 = np.abs(r1.svals[:10] - sig[:10]) / sig[:10]
    assert e1.max() < e0.max()
    assert _proj_err_fro(S, r1.Q) <= 2.0 * _proj_err_fro(S, r0.Q)


def test_tau_rank_selection_matches_pod_criterion():
    S = make_smooth_matrix(200, 120, dtype=np.float64)
    res = tr.rb_randomized_streamed(S, tau=1e-3, max_k=60, sketch_p=10,
                                    power=1, tile_m=40, device=CPU)
    assert res.k == int(np.sum(res.svals >= 1e-3))
    assert res.k < 60
    capped = tr.rb_randomized_streamed(S, tau=1e-3, max_k=5, sketch_p=10,
                                       power=1, tile_m=40, device=CPU)
    assert capped.k == 5


def test_rademacher_kind_same_bound():
    S = make_smooth_matrix(200, 120, dtype=np.complex64)
    res = tr.rb_randomized_streamed(S, tau=None, max_k=15, sketch_p=10,
                                    tile_m=32, kind="rademacher", device=CPU)
    _assert_range_finder_bound(S, res, max_k=15, sketch_p=10)


def _faulty(S, **plan):
    return FaultyProvider(ArrayProvider(torch.from_numpy(S), device=CPU),
                          FaultPlan(**plan))


def test_one_streamed_pass_read_counter():
    """n_tiles tile reads at power 0, (1 + 2 power) n_tiles otherwise."""
    S = make_smooth_matrix(200, 120, dtype=np.float32)
    n_tiles = math.ceil(120 / 32)
    prov = _faulty(S)
    tr.rb_randomized_streamed(prov, tau=None, max_k=15, tile_m=32)
    assert prov.reads == n_tiles
    prov2 = _faulty(S)
    tr.rb_randomized_streamed(prov2, tau=None, max_k=15, tile_m=32, power=2)
    assert prov2.reads == 5 * n_tiles


def test_sketch_deterministic_and_seeded():
    S = make_smooth_matrix(200, 120, dtype=np.complex64)
    kw = dict(tau=None, max_k=10, tile_m=32, device=CPU)
    a = tr.rb_randomized_streamed(S, seed=3, **kw)
    b = tr.rb_randomized_streamed(S, seed=3, **kw)
    assert torch.equal(a.Q, b.Q) and np.array_equal(a.svals, b.svals)
    c = tr.rb_randomized_streamed(S, seed=4, **kw)
    assert not torch.equal(a.Q, c.Q)


@pytest.mark.parametrize("power,raise_at", [(0, 2), (0, 5), (1, 9)])
def test_mid_sketch_crash_resume_bit_identity(tmp_path, power, raise_at):
    """Killed mid-phase (power 1: inside the odd pass), the resumed pass
    redraws the remaining blocks and lands on the uninterrupted bits.  At
    read 2 no checkpoint of every 2 tiles exists yet (the reference's own
    case: the resume starts afresh); at reads 5 and 9 one does, mid-pass."""
    S = make_smooth_matrix(200, 120, dtype=np.complex64)
    kw = dict(tau=None, max_k=12, sketch_p=6, power=power, tile_m=16)
    ref = tr.rb_randomized_streamed(S, device=CPU, **kw)
    d = str(tmp_path / "ckpt")
    with pytest.raises(IOError):
        tr.rb_randomized_streamed(_faulty(S, raise_at_tile=raise_at),
                                  checkpoint_dir=d, checkpoint_every_tiles=2,
                                  **kw)
    if raise_at > 2:
        tree = jio.load_checkpoint_raw(d)
        assert int(tree["phase"]) == power and int(tree["done"]) == 0
    res = tr.rb_randomized_streamed(S, checkpoint_dir=d, resume=True,
                                    device=CPU, **kw)
    assert torch.equal(res.Q, ref.Q)
    assert np.array_equal(res.svals, ref.svals)
    assert torch.equal(res.norms_sq, ref.norms_sq)


def test_resume_validates_checkpoint_compatibility(tmp_path):
    S = make_smooth_matrix(100, 60, dtype=np.float32)
    d = str(tmp_path / "ckpt")
    with pytest.raises(IOError):
        tr.rb_randomized_streamed(_faulty(S, raise_at_tile=2), tau=None,
                                  max_k=8, sketch_p=4, tile_m=16,
                                  checkpoint_dir=d, checkpoint_every_tiles=1)
    common = dict(tau=None, checkpoint_dir=d, resume=True, device=CPU)
    with pytest.raises(ValueError, match="tile_m"):
        tr.rb_randomized_streamed(S, max_k=8, sketch_p=4, tile_m=20,
                                  **common)
    with pytest.raises(ValueError, match="width"):
        tr.rb_randomized_streamed(S, max_k=9, sketch_p=4, tile_m=16,
                                  **common)
    with pytest.raises(ValueError, match="test-matrix"):
        tr.rb_randomized_streamed(S, max_k=8, sketch_p=4, tile_m=16, seed=1,
                                  **common)
    with pytest.raises(ValueError, match="test-matrix"):
        tr.rb_randomized_streamed(S, max_k=8, sketch_p=4, tile_m=16,
                                  kind="rademacher", **common)
    with pytest.raises(ValueError, match="shape"):
        tr.rb_randomized_streamed(S[:, :50], max_k=8, sketch_p=4,
                                  tile_m=16, **common)
    with pytest.raises(ValueError, match="dtype"):
        tr.rb_randomized_streamed(S.astype(np.float64), max_k=8, sketch_p=4,
                                  tile_m=16, **common)
    with pytest.raises(ValueError, match="backend"):
        tr.rb_randomized_streamed(S, max_k=8, sketch_p=4, tile_m=16,
                                  backend="ref", **common)


@pytest.mark.parametrize("kw,match", [
    (dict(sketch_p=-1), "sketch_p"), (dict(power=-1), "power"),
    (dict(kind="srht"), "kind"), (dict(resume=True), "resume"),
    (dict(tile_m=0), "tile_m"), (dict(checkpoint_every_tiles=-1),
                                 "checkpoint_every_tiles")])
def test_argument_validation(kw, match):
    S = make_smooth_matrix(50, 30, dtype=np.float32)
    with pytest.raises(ValueError, match=match):
        tr.rb_randomized_streamed(S, tau=None, device=CPU, **kw)


def _low_rank(seed, N, M, r):
    g = np.random.default_rng(seed)
    L = g.standard_normal((N, r)) @ g.standard_normal((r, M))
    return (L / np.abs(L).max()).astype(np.float32)


@pytest.mark.parametrize("case", ["finds", "doubles", "saturates"])
def test_estimate_rank_matches_jax(case):
    """The reference's three estimate_rank cases: k, ell, saturated and
    passes equal to its own, and its asserted values."""
    if case == "finds":
        L, kw = _low_rank(3, 256, 400, 20), dict(tau=1e-5)
    elif case == "doubles":
        L, kw = _low_rank(4, 256, 400, 48), dict(tau=1e-5, ell0=16)
    else:
        L = np.random.default_rng(5).standard_normal((64, 96)).astype(
            np.float32)
        kw = dict(tau=1e-9, ell0=8, max_ell=16)
    ref = jr.estimate_rank(jnp.asarray(L), **kw)
    got = tr.estimate_rank(torch.from_numpy(L), device=CPU, **kw)
    assert tuple(got) == tuple(ref)
    if case == "finds":
        assert not got.saturated and got.ell == 32 and got.passes == 1
        assert 18 <= got.k <= 22
    elif case == "doubles":
        assert not got.saturated and got.ell == 64 and got.passes == 3
        assert 44 <= got.k <= 52
    else:
        assert got.saturated and got.ell == 16 and got.k == 16


class _JaxCrashing(jp.ArrayProvider):
    """The reference's provider that fails after ``budget`` tile reads."""

    def __init__(self, S, budget):
        super().__init__(S)
        self.budget = budget

    def tile(self, lo, hi):
        if self.budget <= 0:
            raise IOError("injected crash")
        self.budget -= 1
        return super().tile(lo, hi)


@pytest.mark.parametrize("dtype,power,budget", [
    (np.float64, 0, 3), (np.complex128, 1, 10)])
def test_jax_partial_sketch_resumes_in_port(tmp_path, dtype, power,
                                            budget):
    """A partial sketch checkpoint written by the JAX package (backend
    ``xla``) resumes in the port (``auto``) and finishes within tolerance
    of the reference's uninterrupted result."""
    S = make_smooth_matrix(200, 120, dtype=dtype)
    kw = dict(tau=None, max_k=15, sketch_p=10, power=power, tile_m=16,
              seed=2)
    ref = jr.rb_randomized_streamed(S, backend="xla", **kw)
    ck = str(tmp_path / "ck")
    with pytest.raises(IOError, match="injected crash"):
        jr.rb_randomized_streamed(_JaxCrashing(S, budget), backend="xla",
                                  checkpoint_dir=ck,
                                  checkpoint_every_tiles=1, **kw)
    tree = jio.load_checkpoint_raw(ck)
    assert int(tree["phase"]) == power and int(tree["cursor"]) > 0
    assert str(tree["backend"]) == "xla" and int(tree["done"]) == 0
    got = tr.rb_randomized_streamed(S, checkpoint_dir=ck, resume=True,
                                    device=CPU, **kw)
    _assert_sketch_matches_jax(ref, got, dtype, S.shape[0])


# -------------------------------------------------------- the front door ----
def test_front_door_randomized_strategy():
    """strategy="randomized": a POD-shaped artifact (no pivots), the
    reference's provenance keys (and the port's ``device``), its sketch
    record and k; sigma estimates non-increasing, within tolerance."""
    S = make_smooth_matrix(200, 120, dtype=np.complex64)
    kw = dict(source=S, strategy="randomized", tau=1e-4, max_k=40,
              tile_m=32, sketch_power=1)
    ref = jax_build_basis(**kw)
    b = build_basis(device=CPU, **kw)
    assert set(b.provenance) == set(ref.provenance) | {"device"}
    assert b.provenance["sketch"] == ref.provenance["sketch"]
    assert b.pivots.shape == (0,) and b.k == ref.k
    sk = b.provenance["sketch"]
    assert sk["p"] == 10 and sk["power"] == 1 and sk["n_passes"] == 3
    assert sk["kind"] == "gaussian" and sk["ell"] == 50
    est = b.provenance["sigma_estimates"]
    assert len(est) == sk["ell"] and est == sorted(est, reverse=True)
    np.testing.assert_allclose(est, ref.provenance["sigma_estimates"],
                               rtol=0, atol=1e-4 * est[0])
    assert len(b.errs) == b.k
    assert float(b.per_column_errors(S).max()) < 1e-3


def test_front_door_randomized_workdir_resume(tmp_path):
    S = make_smooth_matrix(200, 120, dtype=np.float32)
    wd = str(tmp_path / "wd")
    kw = dict(source=S, strategy="randomized", tau=None, max_k=20,
              tile_m=32, workdir=wd, device=CPU)
    built = build_basis(**kw)
    again = build_basis(resume=True, **kw)
    assert torch.equal(built.Q, again.Q)
    assert not os.path.exists(os.path.join(wd, "build"))
    loaded = ReducedBasis.load(wd, CPU)
    assert loaded.provenance["sketch"] == built.provenance["sketch"]


def test_front_door_randomized_checkpoint_resume(tmp_path):
    """A randomized build killed mid-pass resumes through the front door
    (checkpoint_dir) on the uninterrupted bits."""
    S = make_smooth_matrix(200, 120, dtype=np.float32)
    kw = dict(strategy="randomized", tau=None, max_k=20, tile_m=16,
              sketch_power=1, device=CPU)
    ref = build_basis(source=S, **kw)
    ck = str(tmp_path / "ck")
    with pytest.raises(IOError):
        build_basis(source=_faulty(S, raise_at_tile=11), checkpoint_dir=ck,
                    checkpoint_every_tiles=1, **kw)
    got = build_basis(source=S, checkpoint_dir=ck, resume=True, **kw)
    assert torch.equal(got.Q, ref.Q) and np.array_equal(got.errs, ref.errs)


def test_sketch_greedy_exact_low_rank_needs_no_refinement():
    """Exactly rank r with ell >= r: the refinement accepts no pivot (all
    -1) and stops at tau, as the reference's."""
    rng = np.random.default_rng(5)
    S = (rng.standard_normal((200, 8)) @ rng.standard_normal((8, 120)))
    kw = dict(source=S, strategy="sketch+greedy", tau=1e-8, max_k=30,
              sketch_p=10, tile_m=32)
    ref = jax_build_basis(**kw)
    b = build_basis(device=CPU, **kw)
    assert b.provenance["sketch"] == ref.provenance["sketch"]
    assert b.provenance["sketch"]["k0"] == b.k == 8
    assert np.all(b.pivots == -1)
    assert b.provenance["stop"] == ref.provenance["stop"] == "STOP_TAU"
    assert float(proj_error_max(torch.from_numpy(S), b.Q)) < 1e-8


def test_sketch_greedy_refines_to_tau_as_the_reference():
    """The smooth complex64 family: the sketch's k0 is the reference's, the
    warm columns keep pivot -1, any refinement pivot is a real column, and
    the basis meets tau; no more refinement than a cold streamed build
    needs bases."""
    S = make_smooth_matrix(200, 120, dtype=np.complex64)
    tau = 1e-4
    kw = dict(source=S, strategy="sketch+greedy", tau=tau, max_k=60,
              sketch_p=5, tile_m=32, sketch_power=1)
    ref = jax_build_basis(**kw)
    warm = build_basis(device=CPU, **kw)
    cold = build_basis(source=S, strategy="streamed", tau=tau, max_k=60,
                       tile_m=32, device=CPU)
    k0 = warm.provenance["sketch"]["k0"]
    assert k0 == ref.provenance["sketch"]["k0"]
    assert warm.provenance["sketch"]["refined_k"] == warm.k
    assert np.all(warm.pivots[:k0] == -1) and np.all(warm.pivots[k0:] >= 0)
    assert float(proj_error_max(torch.from_numpy(S), warm.Q)) < tau
    assert warm.k - k0 <= cold.k
    assert warm.provenance["sweeps"] == warm.k - k0


@pytest.mark.parametrize("strategy", ["randomized", "sketch+greedy"])
def test_artifact_round_trip(tmp_path, strategy):
    """Saved and loaded bit-equal: empty pivots (randomized) and -1 pivots
    (the sketch's columns in sketch+greedy)."""
    S = make_smooth_matrix(200, 120, dtype=np.complex64)
    b = build_basis(source=S, strategy=strategy, tau=1e-4, max_k=40,
                    tile_m=32, device=CPU)
    b.save(str(tmp_path))
    back = ReducedBasis.load(str(tmp_path), CPU)
    assert torch.equal(back.Q, b.Q) and back.k == b.k
    assert back.pivots.dtype == b.pivots.dtype
    assert np.array_equal(back.pivots, b.pivots)
    assert np.array_equal(back.errs, b.errs)
    assert back.provenance == b.provenance
