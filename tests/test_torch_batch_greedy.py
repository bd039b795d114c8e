"""The port's lockstep many-basis build (``repro_torch.core.batch_greedy``)
on the CPU.

Every lane of ``batch_rb_greedy`` is BITWISE the port's own scalar
``rb_greedy`` on its matrix and tau (Q, R, pivots, errs, rnorms, pass
counts, rank, stop code), in both layouts (stacked and shared S), at
f32 / c64 / f64 / c128, masked-convergence, refresh and floor-stop lanes
included.  Against the JAX reference (the same numpy inputs, tau above the
Eq.-(6.3) floor) each lane's rank, stop, pivots and pass counts are exact
and Q / R / errs within ``_assert_parity``'s tolerance, through the
reference's ``xla_ref`` and ``xla`` (fused shared GEMM) routes.  The
reference's own bitwise lane contracts are not held here.

Also: the five ``batched_*`` backend primitives against the reference's
``xla_ref``, ``band_split``, the ``"batched"`` front door (spec validation,
``"auto"`` delegation, ``ReducedBasisSet`` save / load / register, workdir
finalize and resume) and the callback.
"""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import dtype_tol, make_smooth_matrix
from test_torch_greedy import _assert_parity, _parity_tau

from repro.core import backend as jbe
from repro.core.batch_greedy import batch_rb_greedy as jax_batch
from repro_torch import api as tapi
from repro_torch.core import backend as tbe
from repro_torch.core.batch_greedy import batch_rb_greedy
from repro_torch.core.greedy import STOP_FLOOR, STOP_RANK, STOP_TAU, rb_greedy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
DTYPES = (np.float32, np.complex64, np.float64, np.complex128)
BACKENDS = ("auto", "ref")
_BITWISE_FIELDS = ("Q", "R", "pivots", "errs", "rnorms", "n_ortho_passes")


def _noisy(dtype, N=96, M=160, rank=12, seed=0, noise=0.01):
    """The reference test's family: a rank-``rank`` matrix plus noise."""
    r = np.random.default_rng(seed)
    X = r.standard_normal((N, rank)) @ r.standard_normal((rank, M))
    X = X + noise * r.standard_normal((N, M))
    if np.issubdtype(dtype, np.complexfloating):
        X = X + 1j * (r.standard_normal((N, rank))
                      @ r.standard_normal((rank, M)))
    return X.astype(dtype)


def _assert_lane_bitwise(lane, ref, ctx):
    assert lane.k == ref.k, (ctx, lane.k, ref.k)
    assert lane.stop == ref.stop, (ctx, lane.stop, ref.stop)
    for name in _BITWISE_FIELDS:
        a, b = getattr(lane, name), getattr(ref, name)
        assert torch.equal(a, b), (
            ctx, name, float((a - b).abs().max()) if a.is_floating_point()
            or a.is_complex() else "int")


# ------------------------------------------ each lane the scalar driver ----


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_stacked_lanes_bitwise_vs_scalar_driver(dtype, backend):
    """Acceptance: the lockstep driver's lanes are BITWISE the scalar
    driver's, lane by lane, on distinct same-shape matrices."""
    Ss = [_noisy(dtype, seed=s) for s in (1, 2, 3)]
    taus = [1e-4, 1e-3, 1e-5]
    res = batch_rb_greedy(np.stack(Ss), taus, max_k=40, backend=backend,
                          chunk=7, device=CPU)
    assert res.batch == 3
    for b, (S, tau) in enumerate(zip(Ss, taus)):
        ref = rb_greedy(S, tau, max_k=40, backend=backend, chunk=7,
                        device=CPU)
        _assert_lane_bitwise(res.lane(b), ref,
                             (np.dtype(dtype).name, backend, b))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_convergence_lanes_stop_at_different_ranks(dtype, backend):
    """Lanes that stop at different k freeze in place (their flag false in
    the sweep and the GS passes) while the rest keep building, and every
    lane, frozen tail included, is its scalar run bitwise.  Exact low-rank
    lanes force well-separated STOP_RANK points."""
    ranks = (5, 12, 8)
    Ss = [_noisy(dtype, rank=r, seed=10 + r, noise=0.0) for r in ranks]
    res = batch_rb_greedy(np.stack(Ss), 1e-8, max_k=30, backend=backend,
                          chunk=6, device=CPU)
    ks = [int(k) for k in res.k]
    assert len(set(ks)) == len(ks), f"ranks did not separate: {ks}"
    for b, S in enumerate(Ss):
        ref = rb_greedy(S, 1e-8, max_k=30, backend=backend, chunk=6,
                        device=CPU)
        assert ref.stop in (STOP_RANK, STOP_TAU)
        _assert_lane_bitwise(res.lane(b), ref,
                             (np.dtype(dtype).name, backend, b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_tau_sweep_lanes_bitwise_vs_scalar_driver(dtype):
    """Shared layout: one S swept by B basis states (a tau sweep); each
    lane is BITWISE the scalar driver at its tau (the reference's shared
    lanes match pivot for pivot only)."""
    S = make_smooth_matrix(160, 120, dtype)
    taus = [1e-2, 1e-3, 1e-4, 1e-5]
    res = batch_rb_greedy(S, taus, max_k=60, chunk=7, device=CPU)
    assert res.batch == 4
    ks = [int(k) for k in res.k]
    assert ks == sorted(ks)  # tighter tau never needs fewer bases
    for b, tau in enumerate(taus):
        ref = rb_greedy(S, tau, max_k=60, chunk=7, device=CPU)
        _assert_lane_bitwise(res.lane(b), ref, (np.dtype(dtype).name, b))


@pytest.mark.parametrize("layout", ["stacked", "shared"])
def test_refresh_lanes_bitwise_vs_scalar_driver(layout, monkeypatch):
    """Lanes whose tracked residual nears the Eq.-(6.3) floor refresh on
    their own (the scalar driver's greedy_refresh on the lane's views) and
    go on, bitwise the scalar driver, beside lanes that do not."""
    from repro_torch.core import batch_greedy

    S = make_smooth_matrix(dtype=np.float64)
    if layout == "stacked":
        mats = [S, S[:, ::-1].copy()]
        src, taus = np.stack(mats), [1e-10, 1e-12]
    else:
        src, taus, mats = S, [1e-4, 1e-10, 1e-12], [S, S, S]
    calls = []
    real = batch_greedy.greedy_refresh
    monkeypatch.setattr(batch_greedy, "greedy_refresh",
                        lambda *a: calls.append(1) or real(*a))
    res = batch_rb_greedy(src, taus, chunk=5, device=CPU)
    assert calls, "no lane refreshed"
    for b, (Sb, tau) in enumerate(zip(mats, taus)):
        ref = rb_greedy(Sb, tau, chunk=5, device=CPU)
        _assert_lane_bitwise(res.lane(b), ref, (layout, b))


@pytest.mark.parametrize("shared", [True, False])
def test_one_lockstep_step_is_each_lanes_greedy_step(shared):
    """batch_greedy_init and batch_greedy_step are the scalar greedy_init
    and greedy_step lane by lane, bitwise, step after step."""
    from repro_torch.core.batch_greedy import (
        batch_greedy_init, batch_greedy_step,
    )
    from repro_torch.core.greedy import greedy_init, greedy_step

    mats = [torch.from_numpy(_noisy(np.complex64, seed=s)) for s in (1, 2)]
    S = mats[0] if shared else torch.stack(mats)
    state = batch_greedy_init(S, 6, batch=2 if shared else None)
    lanes = [greedy_init(mats[0] if shared else m, 6) for m in mats]
    for _ in range(4):
        state = batch_greedy_step(S, state)
        lanes = [greedy_step(mats[0] if shared else m, st)
                 for m, st in zip(mats, lanes)]
    for b, lane in enumerate(lanes):
        for name, x in lane._asdict().items():
            assert torch.equal(getattr(state, name)[b], x), (b, name)


def test_list_of_sources_equals_stacked():
    Ss = [_noisy(np.float32, seed=s) for s in (4, 5)]
    a = batch_rb_greedy(Ss, 1e-4, max_k=20, device=CPU)
    b = batch_rb_greedy(np.stack(Ss), 1e-4, max_k=20, device=CPU)
    c = batch_rb_greedy(tuple(torch.from_numpy(s) for s in Ss), 1e-4,
                        max_k=20, device=CPU)
    for lane in range(2):
        assert torch.equal(a.Q[lane], b.Q[lane])
        assert torch.equal(a.Q[lane], c.Q[lane])


def test_floor_stop_lane_matches_scalar_driver():
    """A lane whose refresh lands on the incompressible noise floor latches
    STOP_FLOOR exactly as the scalar driver does (the reference's recipe:
    smooth modes cliffing onto a ~2e-6 noise floor, tau below it, an
    aggressive refresh cadence)."""
    rng = np.random.default_rng(7)
    U, _ = np.linalg.qr(rng.standard_normal((200, 50)))
    V, _ = np.linalg.qr(rng.standard_normal((160, 50)))
    sv = np.logspace(0, -4, 50)
    S = ((U * sv) @ V.T
         + 1.45e-7 * rng.standard_normal((200, 160))).astype(np.float32)

    ref = rb_greedy(S, 1e-7, refresh_safety=2e6, device=CPU)
    assert ref.stop == STOP_FLOOR
    res = batch_rb_greedy(np.stack([S, S]), 1e-7, refresh_safety=2e6,
                          device=CPU)
    assert list(res.stops) == [STOP_FLOOR, STOP_FLOOR]
    for b in range(2):
        _assert_lane_bitwise(res.lane(b), ref, f"floor lane {b}")
    # the same lane shared with a lane that stops early on tau
    res = batch_rb_greedy(S, [1e-1, 1e-7], refresh_safety=2e6, device=CPU)
    _assert_lane_bitwise(res.lane(1), ref, "shared floor lane")
    assert res.stops[0] == STOP_TAU


def test_shared_layout_batch_inference():
    S = _noisy(np.float32, seed=7)
    # length-B tau implies B; batch= with scalar tau broadcasts it; a bare
    # scalar tau on a shared source is a 1-lane build
    assert batch_rb_greedy(S, [1e-3, 1e-4], max_k=10, device=CPU).batch == 2
    assert batch_rb_greedy(S, 1e-3, max_k=10, batch=3,
                           device=CPU).batch == 3
    assert batch_rb_greedy(S, 1e-3, max_k=10, device=CPU).batch == 1
    with pytest.raises(ValueError, match="tau"):
        batch_rb_greedy(S, [1e-3, 1e-4, 1e-5], max_k=10, batch=2,
                        device=CPU)
    with pytest.raises(ValueError, match="batch"):
        batch_rb_greedy(np.stack([S, S]), 1e-3, batch=3, device=CPU)
    with pytest.raises(ValueError, match="chunk"):
        batch_rb_greedy(S, 1e-3, chunk=0, device=CPU)


def test_stacked_shape_validation():
    with pytest.raises(ValueError, match="shape"):
        batch_rb_greedy([_noisy(np.float32, N=32), _noisy(np.float32, N=48)],
                        1e-4, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        batch_rb_greedy(np.zeros((2, 3, 4, 5), np.float32), 1e-4,
                        device=CPU)


def test_callback_reports_lockstep_progress():
    """The callback fires once a chunk with a copy of the B-lane state,
    whose ranks never fall; the result counts the rounds."""
    seen = []
    res = batch_rb_greedy(
        np.stack([_noisy(np.float32, seed=s) for s in (1, 2)]), 1e-4,
        max_k=12, chunk=5, device=CPU,
        callback=lambda st: seen.append(st.k.tolist()))
    assert len(seen) == res.chunks >= 2
    assert all(b >= a for s0, s1 in zip(seen, seen[1:])
               for a, b in zip(s0, s1))
    assert res.rounds >= res.live_rounds >= max(res.k)


# --------------------------------------------------- against the JAX one ----


def _jax_batch(src, taus, backend, **kw):
    return jax_batch(jnp.asarray(src), taus, backend=backend, **kw)


@pytest.mark.parametrize("jax_backend", ["xla_ref", "xla"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lanes_match_jax(dtype, jax_backend):
    """The same numpy inputs through both packages, tau above the floor:
    per lane k, stop, pivots and pass counts exact, Q / R / errs within
    _assert_parity's tolerance; the stacked layout and the shared one
    (the reference's xla route fuses the shared lanes' GEMMs)."""
    S = make_smooth_matrix(dtype=dtype)
    Ss = [S, S[:, ::-1].copy()]
    # in double precision, 4e-6: at 1e-6 the complex128 family's 10th pivot
    # is a near-tie on which the reference's own xla and xla_ref routes
    # part (columns 5 and 6), so no tolerance can hold the pivots there
    tau = _parity_tau(S) if S.real.dtype == np.float32 else 4e-6
    port = batch_rb_greedy(np.stack(Ss), tau, chunk=7, device=CPU)
    ref = _jax_batch(np.stack(Ss), tau, jax_backend, chunk=7)
    for b, S in enumerate(Ss):
        _assert_parity(port.lane(b), ref.lane(b), dtype, S.shape[0])
    taus = [tau, 0.7 * tau, 0.5 * tau]
    port = batch_rb_greedy(S, taus, chunk=7, device=CPU)
    ref = _jax_batch(S, taus, jax_backend, chunk=7)
    for b in range(3):
        _assert_parity(port.lane(b), ref.lane(b), dtype, S.shape[0])


def _lane_inputs(rng, B, N, M, K, dtype, shared):
    def r(*shape):
        x = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    S = r(N, M) if shared else r(B, N, M)
    rdt = np.zeros((), dtype).real.dtype
    acc = rng.random((B, M)).astype(rdt)
    norms = ((np.abs(S) ** 2).sum(-2) * np.ones((B, 1)) + 3 * acc
             + np.arange(M)[None, :]).astype(rdt)
    Q = np.stack([np.linalg.qr(r(N, K))[0] for _ in range(B)])
    return S, r(B, N), acc, norms, Q, r(B, N, 3)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_primitives_match_jax(rng, dtype, shared):
    """The five batched_* primitives against the reference's xla_ref, in
    both layouts: the sweep (c, acc, max, first-index argmax, residuals
    separated by design), the GS pass and the panel pass, the blocked
    sweep, the sketch fold; each lane bitwise the scalar primitive on its
    slice."""
    B, N, M, K = 3, 40, 50, 7
    S, q, acc, norms, Q, V = _lane_inputs(rng, B, N, M, K, dtype, shared)
    tol = dtype_tol(dtype, N)
    scale = max(1.0, float(np.abs(S).max()))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         dict(S=S, q=q, acc=acc, norms=norms, Q=Q, V=V).items()}

    def close(a, b, s=1.0):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=tol, atol=tol * s)

    port = tbe.batched_pivot_update(t["q"], t["S"], t["acc"], t["norms"])
    ref = jbe.batched_pivot_update(jnp.asarray(q), jnp.asarray(S),
                                   jnp.asarray(acc), jnp.asarray(norms),
                                   backend="xla_ref")
    close(port[0], ref[0], scale * N ** 0.5)
    close(port[1], ref[1], scale ** 2 * N)
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))
    for b in range(B):
        one = tbe.pivot_update(t["q"][b], t["S"] if shared else t["S"][b],
                               t["acc"][b], t["norms"][b])
        assert all(torch.equal(x[b], y) for x, y in zip(port, one))

    port = tbe.batched_project_pass(t["q"], t["Q"])
    ref = jbe.batched_project_pass(jnp.asarray(q), jnp.asarray(Q),
                                   backend="xla_ref")
    for x, y in zip(port, ref):
        close(x, y, 10.0)
    for b in range(B):
        one = tbe.project_pass(t["q"][b], t["Q"][b])
        assert all(torch.equal(x[b], y) for x, y in zip(port, one))

    port = tbe.batched_panel_project(t["V"], t["Q"])
    ref = jbe.batched_panel_project(jnp.asarray(V), jnp.asarray(Q),
                                    backend="xla_ref")
    for x, y in zip(port, ref):
        close(x, y, 10.0)

    Qnew = t["Q"][:, :, :3].contiguous()
    port = tbe.batched_block_sweep(Qnew, t["S"], t["acc"])
    ref = jbe.batched_block_sweep(jnp.asarray(Qnew.numpy()), jnp.asarray(S),
                                  jnp.asarray(acc), backend="xla_ref")
    close(port[0], ref[0], scale * N ** 0.5)
    close(port[1], ref[1], scale ** 2 * N)

    T = t["S"][..., :5]
    Om = t["V"][0, :5] if shared else t["V"][:, :5]
    Y = t["V"][:, :, :3] * 0.5
    port = tbe.batched_sketch_fold(T, Om, Y)
    ref = jbe.batched_sketch_fold(jnp.asarray(T.numpy()),
                                  jnp.asarray(Om.numpy()),
                                  jnp.asarray(Y.numpy()), backend="xla_ref")
    close(port, ref, scale * 10.0)
    assert torch.equal(Y, t["V"][:, :, :3] * 0.5)


def test_batched_primitives_refuse_a_mismatched_stack(rng):
    S, q, acc, norms, *_ = _lane_inputs(rng, 2, 8, 9, 2, np.float64, False)
    q, S, acc, norms = map(torch.from_numpy, (q, S, acc, norms))
    with pytest.raises(ValueError, match="stacked snapshot batch"):
        tbe.batched_pivot_update(q[:1], S, acc[:1], norms[:1])
    with pytest.raises(ValueError, match="snapshot operand"):
        tbe.batched_pivot_update(q, S[None], acc, norms)


# ------------------------------------------------------- band splitting ----


def test_band_split_layout_and_edges():
    """Edges, n_freq and from_real exactly the reference's; the stack
    within tolerance of its (and numpy's) spectrum rows."""
    from repro.data import band_split as jax_split
    from repro_torch.data import BandSplit, band_split

    S = np.asarray(make_smooth_matrix(128, 40, np.float64))
    split = band_split(S, 4, device=CPU)
    ref = jax_split(S, 4)
    assert isinstance(split, BandSplit) and isinstance(split, tuple)
    n_freq = 128 // 2 + 1  # one-sided rFFT bins
    h = n_freq // 4
    assert split.batch == ref.batch == 4
    assert split.from_real and split.n_freq == ref.n_freq == n_freq
    assert tuple(split.stack.shape) == (4, h, 40)
    assert split.edges == ref.edges == tuple(
        (b * h, (b + 1) * h) for b in range(4))
    F = np.fft.rfft(S, axis=0)
    for b, (lo, hi) in enumerate(split.edges):
        np.testing.assert_allclose(split.stack[b].numpy(), F[lo:hi],
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(split.stack[b].numpy(),
                                   np.asarray(ref.stack[b]), rtol=1e-9,
                                   atol=1e-9)
    # complex input: the full (two-sided) FFT
    split_c = band_split(S.astype(np.complex128), 4, device=CPU)
    assert not split_c.from_real and split_c.n_freq == 128
    assert split_c.edges == jax_split(S.astype(np.complex128), 4).edges
    # float32 in, complex64 out, as the reference's
    split_f = band_split(S.astype(np.float32), 3, device=CPU)
    assert split_f.stack.dtype == torch.complex64
    assert np.dtype(jax_split(S.astype(np.float32), 3).stack.dtype) \
        == np.complex64

    with pytest.raises(ValueError, match="bands"):
        band_split(S, 0, device=CPU)
    with pytest.raises(ValueError, match="empty"):
        band_split(S, 4096, device=CPU)
    with pytest.raises(ValueError, match="2-D"):
        band_split(np.zeros((4, 4, 4)), 2, device=CPU)


def test_band_split_feeds_batched_build():
    from repro_torch.data import band_split

    split = band_split(make_smooth_matrix(96, 48, np.float64)
                       .astype(np.float32), 3, device=CPU)
    bset = tapi.build_basis(source=split, tau=1e-3, max_k=20, device=CPU)
    assert bset.batch == 3
    meta = bset.provenance["bands"]
    assert meta["from_real"] is True
    assert [tuple(e) for e in meta["edges"]] == list(split.edges)
    # each child reduces ITS band bitwise like a scalar build on it
    for b in range(3):
        ref = rb_greedy(split.stack[b], 1e-3, max_k=20, device=CPU)
        k = bset[b].k
        assert k == ref.k
        assert torch.equal(bset[b].Q, ref.Q[:, :k])


# ------------------------------------------------------------ front door ----


def test_spec_batched_validation():
    with pytest.raises(ValueError, match="batch"):
        tapi.ReductionSpec(source="x", strategy="batched", batch=0)
    with pytest.raises(ValueError, match="batch"):
        tapi.ReductionSpec(source="x", strategy="greedy", batch=2)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tapi.ReductionSpec(source="x", strategy="batched",
                           checkpoint_dir="c")
    # batch rides along with auto (it implies the batched strategy)
    assert tapi.ReductionSpec(source="x", strategy="auto", batch=2).batch \
        == 2
    with pytest.raises(ValueError, match="batched strategy"):
        tapi.build_basis_set(source=np.zeros((4, 4)), strategy="greedy")


def test_auto_delegates_batched_workloads(caplog):
    stack = np.stack([_noisy(np.float32, seed=s) for s in (1, 2)])
    with caplog.at_level(logging.INFO, logger="repro_torch.api"):
        bset = tapi.build_basis(source=stack, tau=1e-3, max_k=15,
                                device=CPU)
    assert isinstance(bset, tapi.ReducedBasisSet)
    assert any("'batched'" in r.getMessage() for r in caplog.records)
    assert bset.provenance["requested_strategy"] == "auto"
    assert bset.provenance["strategy"] == "batched"
    # batch= on a shared source flips auto too
    shared = tapi.build_basis(source=stack[0], tau=1e-3, max_k=15, batch=2,
                              device=CPU)
    assert shared.provenance["layout"] == "shared" and shared.batch == 2


def test_front_door_lane_provenance_and_parity():
    Ss = [_noisy(np.complex64, seed=s) for s in (1, 2)]
    taus = [1e-4, 1e-3]
    bset = tapi.build_basis(source=Ss, strategy="batched", tau=taus,
                            max_k=25, chunk=6, device=CPU)
    prov = bset.provenance
    assert prov["layout"] == "stacked" and prov["tau"] == taus
    assert prov["batch"] == 2 and prov["device"] == "cpu"
    assert prov["shape"] == [96, 160] and prov["dtype"] == "complex64"
    assert prov["lockstep"]["rounds"] >= max(c.k for c in bset)
    for b, (S, tau) in enumerate(zip(Ss, taus)):
        ref = rb_greedy(S, tau, max_k=25, chunk=6, device=CPU)
        child = bset[b]
        k = child.k
        assert k == ref.k
        assert torch.equal(child.Q, ref.Q[:, :k])
        assert np.array_equal(child.R, ref.R[:k].numpy())
        assert np.array_equal(child.pivots, ref.pivots[:k].numpy())
        lane = child.provenance["lane"]
        assert lane["index"] == b and lane["tau"] == tau
        assert "stop" in lane


def test_front_door_provenance_keys_are_the_references():
    """The set's provenance carries every key of the reference's (plus the
    port's device and lockstep counters), and so does each lane's."""
    from repro.api import build_basis as jax_build

    Ss = [_noisy(np.float32, seed=s) for s in (1, 2)]
    port = tapi.build_basis(source=Ss, strategy="batched", tau=1e-3,
                            max_k=10, device=CPU)
    ref = jax_build(source=[jnp.asarray(s) for s in Ss], strategy="batched",
                    tau=1e-3, max_k=10)
    assert set(ref.provenance) <= set(port.provenance)
    assert set(ref[0].provenance["lane"]) <= set(port[0].provenance["lane"])
    for key in ("layout", "batch", "tau", "shape", "dtype", "strategy"):
        assert port.provenance[key] == ref.provenance[key], key


def test_set_save_load_register_roundtrip(tmp_path):
    from repro_torch.serving.router import BasisRouter

    bset = tapi.build_basis_set(
        source=[_noisy(np.complex64, seed=s) for s in (3, 4)],
        strategy="batched", tau=1e-3, max_k=20, device=CPU)
    d = str(tmp_path / "set")
    bset.save(d)
    assert os.path.exists(os.path.join(d, "set.json"))
    loaded = tapi.ReducedBasisSet.load(d, CPU)
    assert loaded.batch == 2 and len(loaded) == 2
    for b in range(2):
        assert loaded[b].k == bset[b].k
        assert torch.equal(loaded[b].Q, bset[b].Q)
        assert np.array_equal(loaded[b].R, bset[b].R)
        # children are full artifacts: EIM machinery intact after reload
        nodes = loaded[b].eim().nodes
        assert len(nodes) == loaded[b].k
        assert torch.equal(nodes, bset[b].eim().nodes)
    router = BasisRouter(device=CPU)
    ids = loaded.register(router, prefix="lane")
    assert ids == ["lane_0", "lane_1"]
    basis, eim = router.get("lane_1")
    assert basis.k == loaded[1].k and torch.equal(basis.Q, bset[1].Q)
    with pytest.raises(ValueError, match="names"):
        loaded.register(BasisRouter(device=CPU), names=["only_one"])
    with pytest.raises(FileNotFoundError, match="set"):
        tapi.ReducedBasisSet.load(str(tmp_path / "nope"), CPU)


def test_set_saved_by_either_package_loads_in_the_other(tmp_path):
    """The on-disk set is the reference's: a set saved by the port loads in
    the JAX package with bit-equal children, and back."""
    from repro.api import ReducedBasisSet as JaxSet
    from repro.api import build_basis as jax_build

    Ss = [_noisy(np.float64, seed=s) for s in (3, 4)]
    port = tapi.build_basis(source=Ss, strategy="batched", tau=1e-6,
                            max_k=15, device=CPU)
    port.save(str(tmp_path / "port"))
    back = JaxSet.load(str(tmp_path / "port"))
    for b in range(2):
        np.testing.assert_array_equal(np.asarray(back[b].Q),
                                      port[b].Q.numpy())
    ref = jax_build(source=[jnp.asarray(s) for s in Ss], strategy="batched",
                    tau=1e-6, max_k=15)
    ref.save(str(tmp_path / "ref"))
    mine = tapi.ReducedBasisSet.load(str(tmp_path / "ref"), CPU)
    for b in range(2):
        np.testing.assert_array_equal(mine[b].Q.numpy(),
                                      np.asarray(ref[b].Q))


def test_save_cut_before_the_manifest_does_not_load(tmp_path, monkeypatch):
    """A save that dies after the children but before set.json leaves no
    loadable set; saving again completes it."""
    from repro_torch.api import basis_set

    bset = tapi.build_basis_set(
        source=np.stack([_noisy(np.float32, seed=s) for s in (5, 6)]),
        tau=1e-3, max_k=10, device=CPU)
    d = str(tmp_path / "cut")

    def die(*a, **k):
        raise OSError("killed before the manifest")

    monkeypatch.setattr(basis_set, "_write_manifest", die)
    with pytest.raises(OSError, match="killed"):
        bset.save(d)
    assert os.path.isdir(os.path.join(d, "basis_1"))
    assert not os.path.exists(os.path.join(d, "set.json"))
    with pytest.raises(FileNotFoundError, match="manifest"):
        tapi.ReducedBasisSet.load(d, CPU)
    monkeypatch.undo()
    bset.save(d)
    again = tapi.ReducedBasisSet.load(d, CPU)
    assert [c.k for c in again] == [c.k for c in bset]
    with open(os.path.join(d, "set.json")) as f:
        assert json.load(f)["children"] == ["basis_0", "basis_1"]


def test_workdir_finalize_and_resume(tmp_path, monkeypatch):
    """A workdir build finalizes the set there; resume returns it without
    building again."""
    from repro_torch.core import batch_greedy

    wd = str(tmp_path / "wd")
    stack = np.stack([_noisy(np.float32, seed=s) for s in (5, 6)])
    built = tapi.build_basis(source=stack, strategy="batched", tau=1e-3,
                             max_k=15, workdir=wd, device=CPU)
    assert os.path.exists(os.path.join(wd, "set.json"))

    def no_build(*a, **k):
        raise AssertionError("resume rebuilt a finalized set")

    monkeypatch.setattr(batch_greedy, "batch_rb_greedy", no_build)
    resumed = tapi.build_basis(source=stack, strategy="batched", tau=1e-3,
                               max_k=15, workdir=wd, resume=True,
                               device=CPU)
    for b in range(2):
        assert torch.equal(resumed[b].Q, built[b].Q)
        assert resumed[b].provenance["lane"] == built[b].provenance["lane"]
