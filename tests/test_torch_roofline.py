"""The port's ``"auto"`` strategy and its roofline model vs the JAX
reference: the reference's own ``"auto"`` tests (tests/test_api.py's auto
selection and roofline cases, tests/test_randomized.py's two cutover
cases) ported to the port, the decision table of both packages on a grid
of specs, shapes, dtypes and pinned roofs, and the default call over a
generated source that exceeds the budget (it streams, never
materializes).

The conftest sets ``REPRO_ROOFLINE_MEASURE=0``, so both packages plan
against their CPU row of default roofs unless a test pins or measures
them.
"""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_smooth_matrix

import repro.api as japi
import repro_torch.api as tapi
from repro.api.build import _auto_strategy as jax_auto_strategy
from repro_torch.api import roofline as R
from repro_torch.api.build import (
    _PLATFORM_ROOFS, _auto_strategy, machine_roofline,
)
from repro_torch.core.block_greedy import _rb_greedy_block_impl
from repro_torch.core.greedy import rb_greedy
from repro_torch.core.streaming import rb_greedy_streamed
from repro_torch.gw import chirp_grid, frequency_grid
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
TAU = 1e-3
LOGGER = "repro_torch.api"


def _S(dtype=np.complex64):
    return make_smooth_matrix(dtype=dtype)


def _assert_bitwise(basis, Q, pivots, errs, k):
    assert basis.k == k
    assert basis.Q.shape == (Q.shape[0], k)
    assert torch.equal(basis.Q, Q[:, :k])
    np.testing.assert_array_equal(basis.pivots, pivots[:k].numpy())
    np.testing.assert_array_equal(basis.errs, errs[:k].numpy())


def _spec(**kw):
    return tapi.ReductionSpec(source="unused", strategy="auto", device=CPU,
                              **kw)


# ----------------------------------------------------- auto selection ----
def test_auto_picks_resident_when_it_fits(caplog):
    S = _S(np.complex64)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        basis = tapi.build_basis(source=S, tau=TAU, device=CPU)
    assert basis.provenance["strategy"] == "greedy"
    assert basis.provenance["requested_strategy"] == "auto"
    assert any("auto strategy" in r.getMessage() for r in caplog.records)
    ref = rb_greedy(S, tau=TAU, device=CPU)
    _assert_bitwise(basis, ref.Q, ref.pivots, ref.errs, int(ref.k))
    assert japi.build_basis(source=S, tau=TAU).provenance["strategy"] \
        == "greedy"


def test_auto_picks_streamed_on_forced_small_budget():
    S = _S(np.complex64)
    basis = tapi.build_basis(source=S, tau=TAU, memory_budget_bytes=1024,
                             tile_m=40, device=CPU)
    assert basis.provenance["strategy"] == "streamed"
    ref = rb_greedy_streamed(S, tau=TAU, tile_m=40, device=CPU)
    _assert_bitwise(basis, ref.Q, ref.pivots, ref.errs, int(ref.k))


def test_auto_with_mesh_names_the_distributed_item(monkeypatch):
    """"auto" picks "distributed" when a mesh is passed, as the
    reference's does, before any roofline work (the model is not
    consulted); the build itself is tested in
    tests/test_torch_distributed.py."""
    from repro_torch.api import build as tbuild

    def no_roofline(*_a, **_k):
        raise AssertionError("the roofline model was consulted")

    monkeypatch.setattr(tbuild, "_sweep_roofline", no_roofline)
    monkeypatch.setattr(tbuild, "device_memory_budget", no_roofline)
    mesh = object()
    port = tbuild._auto_strategy(
        tapi.ReductionSpec(source=_S(), tau=TAU, mesh=mesh, device=CPU),
        (200, 120), torch.complex64)
    ref = jax_auto_strategy(
        japi.ReductionSpec(source=_S(), tau=TAU, mesh=mesh), (200, 120),
        jnp.complex64)
    assert port == ref == ("distributed", 1, None)


def test_auto_respects_env_budget(monkeypatch):
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", "12345")
    assert tapi.device_memory_budget() == 12345
    assert tapi.device_memory_budget(CPU) == 12345


# ------------------------------------------------ auto DRAM roofline ----
def test_auto_picks_block_greedy_on_roof_bound_shape():
    """The paper benchmark's roof-bound f32 resident shape (N=4096,
    M=16384) selects block_greedy.  Decision-level: the spec's source is
    never touched."""
    choice, block_p, _k = _auto_strategy(_spec(), (4096, 16384),
                                         torch.float32)
    assert choice == "block_greedy"
    assert block_p > 1


def test_auto_block_greedy_end_to_end(caplog):
    """Forcing the roofline knobs makes a small matrix roof-bound: auto
    builds through the blocked driver (logged), bit-identical to calling
    it directly."""
    S = _S(np.float32)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        basis = tapi.build_basis(source=S, tau=TAU, block_p=2,
                                 cache_bytes=1, device=CPU)
    assert basis.provenance["strategy"] == "block_greedy"
    assert basis.provenance["requested_strategy"] == "auto"
    assert basis.provenance["block_p"] == 2
    assert any("roof-bound" in r.getMessage() for r in caplog.records)
    ref = _rb_greedy_block_impl(S, tau=TAU, p=2, device=CPU)
    _assert_bitwise(basis, ref.Q, ref.pivots, ref.errs, int(ref.k))


def test_auto_blocked_streamed_when_too_big():
    """Too big for the budget AND roof-bound -> blocked streamed: the
    block_p the model picked reaches the streamed driver."""
    S = _S(np.complex64)
    basis = tapi.build_basis(source=S, tau=TAU, memory_budget_bytes=1024,
                             tile_m=40, cache_bytes=1, device=CPU)
    assert basis.provenance["strategy"] == "streamed"
    assert basis.provenance["block_p"] > 1
    ref = rb_greedy_streamed(S, tau=TAU, tile_m=40,
                             block_p=basis.provenance["block_p"],
                             device=CPU)
    _assert_bitwise(basis, ref.Q, ref.pivots, ref.errs, int(ref.k))


def test_auto_roofline_env_overrides(monkeypatch):
    """REPRO_DRAM_BW_GBPS / REPRO_PEAK_GFLOPS / REPRO_LLC_BYTES feed the
    model; spec fields win over the env (and both win over any
    measurement, which pinned knobs skip entirely)."""
    monkeypatch.setenv("REPRO_DRAM_BW_GBPS", "10")
    monkeypatch.setenv("REPRO_PEAK_GFLOPS", "100")
    monkeypatch.setenv("REPRO_LLC_BYTES", "1000")
    monkeypatch.setenv("REPRO_ROOFLINE_MEASURE", "1")  # pinned knobs win
    assert machine_roofline(None, device=CPU) == (10.0, 100.0, 1000)
    assert machine_roofline(_spec(bandwidth_gbps=5.0)) == (5.0, 100.0, 1000)


# ------------------------------------------------- measured roofline ----
def test_roofline_measurement_disabled_by_default_in_tests(monkeypatch):
    """Under REPRO_ROOFLINE_MEASURE=0 (the conftest default) the model
    falls back to the device's default roofs — no measurement runs."""
    assert not R.roofline_measurement_enabled()
    for var in ("REPRO_DRAM_BW_GBPS", "REPRO_PEAK_GFLOPS",
                "REPRO_LLC_BYTES"):
        monkeypatch.delenv(var, raising=False)

    def boom(*a, **kw):  # measurement must not even be consulted
        raise AssertionError("measured_roofline called despite opt-out")

    monkeypatch.setattr(R, "measured_roofline", boom)
    monkeypatch.setattr(R, "measured_cache_bytes", boom)
    assert machine_roofline(None, device=CPU) == _PLATFORM_ROOFS["cpu"]
    # the CPU row is the reference's, so the CPU reproduces its table
    from repro.api.build import _PLATFORM_ROOFS as JAX_ROOFS
    assert _PLATFORM_ROOFS["cpu"] == JAX_ROOFS["cpu"]


def test_measured_roofline_feeds_model_when_enabled(monkeypatch, caplog):
    """REPRO_ROOFLINE_MEASURE=1 with no pinned knobs: the one-time
    calibration fills bandwidth/FLOPs (positive, finite, logged) AND the
    LLC knob (stubbed here).  Cached per process and device: the second
    model call does not re-measure."""
    monkeypatch.setenv("REPRO_ROOFLINE_MEASURE", "1")
    for var in ("REPRO_DRAM_BW_GBPS", "REPRO_PEAK_GFLOPS",
                "REPRO_LLC_BYTES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(R, "measured_cache_bytes", lambda dev: 48 << 20)
    R.measured_roofline.cache_clear()
    try:
        with caplog.at_level(logging.INFO, logger=LOGGER):
            bw, gf, cache = machine_roofline(None, device=CPU)
        assert np.isfinite(bw) and bw > 0
        assert np.isfinite(gf) and gf > 0
        assert cache == 48 << 20  # the measured LLC fed the model
        assert any("measured roofline" in r.getMessage()
                   for r in caplog.records)
        assert machine_roofline(None, device=CPU) == (bw, gf, cache)
        info = R.measured_roofline.cache_info()
        assert info.currsize == 1 and info.hits >= 1  # measured once
    finally:
        R.measured_roofline.cache_clear()


def test_measured_roofline_failure_not_cached(monkeypatch):
    """A transient calibration failure reports the (0.0, 0.0) sentinel
    UNCACHED: the next call retries and a later success is cached."""
    R.measured_roofline.cache_clear()
    calls = {"n": 0}
    real_steady = R._steady_min

    def flaky_steady(fn, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected transient calibration failure")
        return real_steady(fn, repeats=1, warmup=0, device=kw.get("device"))

    monkeypatch.setattr(R, "_steady_min", flaky_steady)
    try:
        assert R.measured_roofline(CPU) == (0.0, 0.0)
        assert R.measured_roofline.cache_info().currsize == 0
        bw, gf = R.measured_roofline(CPU)  # retried -> real measurement
        assert bw > 0 and gf > 0
        assert R.measured_roofline(CPU) == (bw, gf)
        info = R.measured_roofline.cache_info()
        assert info.currsize == 1 and info.hits >= 1  # success cached
    finally:
        R.measured_roofline.cache_clear()  # drop the 1-repeat numbers


def test_auto_decision_table_deterministic_without_measurement():
    """Under REPRO_ROOFLINE_MEASURE=0 the decision table reproduces the
    reference's classifications from the default roofs."""
    assert os.environ.get("REPRO_ROOFLINE_MEASURE") == "0"  # conftest
    for dtype in (torch.float32, torch.complex64):
        choice, block_p, _k = _auto_strategy(_spec(), (4096, 16384), dtype)
        assert choice == "block_greedy"
        assert block_p == 8
    choice, block_p, _k = _auto_strategy(_spec(), (200, 120), torch.float32)
    assert choice == "greedy"
    assert block_p == 1
    # explicit block_p is respected, not overridden
    choice, block_p, _k = _auto_strategy(_spec(block_p=3), (4096, 16384),
                                         torch.float32)
    assert choice == "block_greedy"
    assert block_p == 3


# ---------------------------------------------- the randomized cutover ----
def test_auto_picks_randomized_when_sketch_passes_win():
    """Roof-bound sweep + a rank target whose greedy pass count exceeds 2x
    the sketch's -> the one-pass range-finder; with no max_k and probing
    disabled it must NOT."""
    roofs = dict(bandwidth_gbps=10.0, peak_gflops=1e4, cache_bytes=1)
    shape = (4096, 16384)
    choice, block_p, _k = _auto_strategy(_spec(max_k=64, **roofs), shape,
                                         torch.float32)
    assert choice == "randomized"
    assert block_p == 1  # blocking is a greedy knob; not forced on
    choice, _, _k = _auto_strategy(_spec(**roofs), shape, torch.float32)
    assert choice == "block_greedy"
    # blocked greedy passes <= 2x sketch: blocking wins
    choice, _, _k = _auto_strategy(_spec(max_k=16, **roofs), shape,
                                   torch.float32)
    assert choice == "block_greedy"
    # deeper power iteration raises the sketch's pass bill
    choice, _, _k = _auto_strategy(_spec(max_k=64, sketch_power=2, **roofs),
                                   shape, torch.float32)
    assert choice == "block_greedy"


def test_auto_rank_estimation_enables_randomized_cutover(monkeypatch,
                                                         caplog):
    """With no max_k, roof-bound, and probing enabled, "auto"
    sketch-estimates a rank, caps max_k with headroom, and picks the
    range-finder — the reference's cap, on the same numpy source; under
    REPRO_ROOFLINE_MEASURE=0 the estimate never runs."""
    r_ = np.random.default_rng(6)
    L = r_.standard_normal((256, 20)) @ r_.standard_normal((20, 512))
    S = (L / np.abs(L).max()).astype(np.float32)
    roofs = dict(bandwidth_gbps=10.0, peak_gflops=1e4, cache_bytes=1)
    spec = tapi.ReductionSpec(source=S, strategy="auto", tau=1e-5,
                              device=CPU, **roofs)
    jspec = japi.ReductionSpec(source=jnp.asarray(S), strategy="auto",
                               tau=1e-5, **roofs)

    monkeypatch.setenv("REPRO_ROOFLINE_MEASURE", "1")
    with caplog.at_level(logging.INFO, logger=LOGGER):
        choice, _, max_k = _auto_strategy(spec, S.shape, torch.float32)
    assert choice == "randomized"
    assert max_k is not None and max_k >= 20  # estimate + headroom
    assert any("sketch-estimated" in rec.getMessage()
               for rec in caplog.records)
    assert (choice, max_k) == jax_auto_strategy(jspec, S.shape,
                                                jnp.float32)[::2]

    monkeypatch.setenv("REPRO_ROOFLINE_MEASURE", "0")
    choice, _, max_k = _auto_strategy(spec, S.shape, torch.float32)
    assert choice == "block_greedy"  # deterministic leg: no probing
    assert max_k is None


def test_auto_randomized_end_to_end_matches_the_named_strategy():
    """The cutover through the front door: the estimated cap reaches the
    randomized builder, and the basis is the one strategy="randomized"
    with that max_k builds."""
    r_ = np.random.default_rng(6)
    L = r_.standard_normal((256, 20)) @ r_.standard_normal((20, 512))
    S = (L / np.abs(L).max()).astype(np.float32)
    kw = dict(tau=1e-5, max_k=64, bandwidth_gbps=10.0, peak_gflops=1e4,
              cache_bytes=1, tile_m=128, device=CPU)
    auto = tapi.build_basis(source=S, **kw)
    assert auto.provenance["strategy"] == "randomized"
    named = tapi.build_basis(source=S, strategy="randomized", **kw)
    assert auto.k == named.k and torch.equal(auto.Q, named.Q)
    np.testing.assert_array_equal(auto.errs, named.errs)


# ------------------------------------------- the decision table, both ----
ROOFS = [(25.0, 80.0, 64 << 20),      # the CPU row: c64 and f32 roof-bound
         (3350.0, 1000.0, 50 << 20),  # balance 0.3: nothing roof-bound
         (10.0, 1e4, 1)]              # every sweep roof-bound


@pytest.mark.parametrize("max_k", [None, 16, 64, 100])
@pytest.mark.parametrize("dtype", ["float32", "complex64"])
@pytest.mark.parametrize("shape", [(200, 120), (4096, 16384),
                                   (10_000, 3_276_800)])
def test_auto_strategy_matches_jax_on_the_grid(shape, dtype, max_k):
    """The port's decision is the reference's (choice, block_p, max_k) for
    every sketch_power 0-3, block_p 1 / 3, budget 1 KB / 80 GB and set of
    pinned roofs."""
    for power in range(4):
        for block_p in (1, 3):
            for budget in (1 << 10, 80 << 30):
                for bw, gf, cache in ROOFS:
                    kw = dict(strategy="auto", max_k=max_k,
                              sketch_power=power, block_p=block_p,
                              memory_budget_bytes=budget,
                              bandwidth_gbps=bw, peak_gflops=gf,
                              cache_bytes=cache)
                    want = jax_auto_strategy(
                        japi.ReductionSpec(source="unused", **kw), shape,
                        jnp.dtype(dtype))
                    got = _auto_strategy(
                        tapi.ReductionSpec(source="unused", device=CPU,
                                           **kw), shape,
                        getattr(torch, dtype))
                    assert got == want, (kw, got, want)


# --------------------------------- fault 1: the default call streams ----
def test_default_call_streams_a_source_past_the_budget(monkeypatch):
    """A TaylorF2 grid past the budget (N 256, M 512, complex64, tau 1e-4,
    max_k 20, a 64 KB budget) through the default call: both packages
    choose "streamed" and build k 20, and neither materializes the source.
    The port's basis is bitwise its strategy="streamed" build; its pivots
    are not the reference's: the normalized columns' norms tie to an ulp,
    each package sums them in its own order (the reference with XLA, the
    port in the fixed tree of repro_torch.sums), so the first pivot
    differs (ROADMAP.md queue 3), and the reference's own auto build is
    its streamed build in turn."""
    import repro.data.providers as jprov
    import repro_torch.data.providers as tprov

    def never(*a, **kw):
        raise AssertionError("the source was materialized")

    for mod in (jprov, tprov):
        monkeypatch.setattr(mod, "materialize_source", never)
        monkeypatch.setattr(mod.WaveformProvider, "materialize", never)
    f = frequency_grid(40.0, 1024.0, 256)
    m1, m2 = chirp_grid(n_mc=32, n_eta=16)
    kw = dict(tau=1e-4, max_k=20, memory_budget_bytes=65_536)
    port = tapi.build_basis(
        tapi.ReductionSpec.waveform(f, m1, m2, device=CPU, **kw))
    ref = japi.build_basis(japi.ReductionSpec.waveform(f, m1, m2, **kw))
    assert port.provenance["strategy"] == ref.provenance["strategy"] \
        == "streamed"
    assert port.provenance["block_p"] == ref.provenance["block_p"] == 1
    assert port.k == ref.k == 20
    assert port.provenance["stop"] == ref.provenance["stop"]
    named = tapi.build_basis(tapi.ReductionSpec.waveform(
        f, m1, m2, device=CPU, strategy="streamed", **kw))
    assert torch.equal(port.Q, named.Q)
    np.testing.assert_array_equal(port.pivots, named.pivots)
    jnamed = japi.build_basis(japi.ReductionSpec.waveform(
        f, m1, m2, strategy="streamed", **kw))
    np.testing.assert_array_equal(ref.pivots, jnamed.pivots)


def test_default_call_streams_with_the_reference_pivots(monkeypatch):
    """The same decision on a family without ties (the smooth family,
    float64, held on the host): both packages stream it under a 1 KB
    budget with the same k, pivots and stop, and the port never
    materializes it."""
    import repro_torch.data.providers as tprov

    def never(*a, **kw):
        raise AssertionError("the source was materialized")

    monkeypatch.setattr(tprov, "materialize_source", never)
    S = _S(np.float64)
    kw = dict(tau=1e-6, memory_budget_bytes=1024, tile_m=40)
    port = tapi.build_basis(source=S, device=CPU, **kw)
    ref = japi.build_basis(source=S, **kw)
    assert port.provenance["strategy"] == ref.provenance["strategy"] \
        == "streamed"
    assert port.k == ref.k >= 5
    np.testing.assert_array_equal(port.pivots, ref.pivots)
    assert port.provenance["stop"] == ref.provenance["stop"]


# ---------------------------------------------- the measurement helpers ----
def test_timed_stream_rate_on_the_cpu_is_positive():
    """The cache probe's CPU route (a loop of torch.dot) gives a positive,
    finite rate."""
    rate = R._timed_stream_rate(1 << 16, 4, CPU)
    assert np.isfinite(rate) and rate > 0


@pytest.mark.parametrize("rates,want", [
    # a cliff between 32 and 64 MB: the cache is the last size above the
    # geometric mean of the peak and the DRAM floor
    ([900, 950, 1000, 1000, 990, 980, 400, 380], 32),
    ([900, 950, 1000, 600, 420, 400, 400, 380], 4),
    # no contrast: the 0 sentinel (the device's default stands)
    ([400, 410, 405, 400, 398, 401, 399, 400], 0),
])
def test_cache_cliff_rule(monkeypatch, rates, want):
    """_measure_cache_once's rule over the 1-128 MB working sets, on given
    rates (the reference's rule)."""
    monkeypatch.setattr(R, "_stream_rates", lambda device: list(rates))
    R.measured_cache_bytes.cache_clear()
    try:
        assert R.measured_cache_bytes(CPU) == want << 20
        assert R.measured_cache_bytes.cache_info().currsize == 1
    finally:
        R.measured_cache_bytes.cache_clear()


def test_spec_takes_the_reference_fields():
    """The roofline knobs are the reference's fields with its defaults,
    describe() serializes them; batch is validated as the reference does
    it and makes a spec (item 6 is ported), and so does mesh (item 7),
    summarized in describe() by its dimension names and shape."""
    spec = tapi.ReductionSpec(source=np.zeros((4, 4)),
                              memory_budget_bytes=123, cache_bytes=7)
    d = spec.describe()
    for name in ("memory_budget_bytes", "bandwidth_gbps", "peak_gflops",
                 "cache_bytes", "mesh", "batch"):
        assert getattr(japi.ReductionSpec(source="x"), name) is None
        assert name in d
    assert d["memory_budget_bytes"] == 123 and d["cache_bytes"] == 7
    with pytest.raises(ValueError, match="batch must be >= 1"):
        tapi.ReductionSpec(source="x", batch=0)
    with pytest.raises(ValueError, match="only applies to the batched"):
        tapi.ReductionSpec(source="x", strategy="greedy", batch=2)
    assert tapi.ReductionSpec(source="x", batch=2).batch == 2
    assert tapi.ReductionSpec(source="x", batch=2).describe()["batch"] == 2
    from types import SimpleNamespace

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           mesh=torch.arange(4).view(2, 2))
    assert tapi.ReductionSpec(source="x", mesh=mesh).describe()["mesh"] == \
        {"axis_names": ["data", "model"], "shape": [2, 2]}


@pytest.mark.parametrize("source", ["stack", "list", "tuple"])
def test_auto_on_a_batched_workload_names_the_batched_item(source):
    """A (B, N, M), list or tuple source is a many-basis workload in both
    packages; "auto" delegates it to the batched strategy (item 6) in
    both, and the lanes are the reference's: rank, stop and pivots exact,
    Q within the tolerance of the parity tests."""
    from conftest import dtype_tol
    from repro.api.build import _is_batched_workload as jax_batched
    from repro_torch.api.build import _is_batched_workload

    S = _S(np.float64)
    S2 = S[:, ::-1].copy()
    src = {"stack": np.stack([S, S2]), "list": [S, S2],
           "tuple": (S, S2)}[source]
    assert jax_batched(japi.ReductionSpec(source=src))
    assert _is_batched_workload(tapi.ReductionSpec(source=src))
    assert not _is_batched_workload(tapi.ReductionSpec(source=S))
    port = tapi.build_basis(source=src, tau=TAU, device=CPU)
    jsrc = jnp.asarray(src) if source == "stack" else type(src)(
        jnp.asarray(x) for x in src)
    ref = japi.build_basis(source=jsrc, tau=TAU)
    assert isinstance(port, tapi.ReducedBasisSet)
    assert port.provenance["strategy"] == ref.provenance["strategy"] \
        == "batched"
    assert port.provenance["layout"] == ref.provenance["layout"] \
        == "stacked"
    assert port.batch == ref.batch == 2
    for b in range(2):
        assert port[b].k == ref[b].k >= 5
        assert port[b].provenance["lane"]["stop"] \
            == ref[b].provenance["lane"]["stop"]
        np.testing.assert_array_equal(port[b].pivots, ref[b].pivots)
        np.testing.assert_allclose(port[b].Q.numpy(), np.asarray(ref[b].Q),
                                   atol=dtype_tol(np.float64, S.shape[0]))
