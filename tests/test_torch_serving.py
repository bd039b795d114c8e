"""The port's ROQ serving engine on the CPU: the cases of the reference's
``tests/test_serving.py`` and ``tests/test_robust_serving.py`` on
:mod:`repro_torch.serving`, plus cases across the two packages (an
artifact saved by the JAX package served by the port) and the
padded-bucket contract in every dtype.

The load-bearing contract: every answer the engine gives — through padded
batch buckets, warm cache entries, routed bases — is BIT-IDENTICAL to
:func:`repro_torch.serving.direct_interpolate` of the same request.
Answers are host tensors.  Timing bounds are the reference's (generous
future timeouts; no tighter deadline than it uses).
"""

import concurrent.futures
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import dtype_tol, make_smooth_matrix

import repro.api as japi
from repro.serving import direct_interpolate as jax_direct
from repro_torch.api import ReducedBasis, build_basis
from repro_torch.device import numpy_dtype
from repro_torch.serving import (
    AdmissionController,
    BasisRouter,
    CircuitBreakerBoard,
    CircuitOpenError,
    EngineClosedError,
    EngineUnhealthyError,
    InterpolantCache,
    QueueFullError,
    QuotaExceededError,
    RestartPolicy,
    RestartTracker,
    ROQEngine,
    ShedError,
    batch_bucket,
    direct_interpolate,
)

WAIT_S = 10.0  # generous future timeout: the worker flushes in milliseconds
CPU = "cpu"


def _build(n, m, dtype, tau, max_k, strategy="greedy"):
    return build_basis(source=make_smooth_matrix(n, m, dtype),
                       strategy=strategy, tau=tau, max_k=max_k, device=CPU)


def _requests(basis, n, seed=0):
    """n random request vectors (k,) in the basis dtype, as numpy columns."""
    rng = np.random.default_rng(seed)
    dtype = numpy_dtype(basis.Q.dtype)
    f = rng.standard_normal((basis.k, n))
    if np.issubdtype(dtype, np.complexfloating):
        f = f + 1j * rng.standard_normal((basis.k, n))
    return f.astype(dtype)


def _engine(mapping, **kw):
    return ROQEngine(mapping, device=CPU, **kw)


def _router(**kw):
    return BasisRouter(device=CPU, **kw)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One f32 greedy + one c64 POD artifact (no R, no pivots), saved."""
    root = tmp_path_factory.mktemp("torch_serving_bases")
    f32 = _build(120, 60, np.float32, 1e-5, 8)
    c64 = _build(80, 50, np.complex64, 1e-5, 6, strategy="pod")
    dirs = {"f32_greedy": str(root / "f32_greedy"),
            "c64_pod": str(root / "c64_pod")}
    f32.save(dirs["f32_greedy"])
    c64.save(dirs["c64_pod"])
    return dirs


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_robust_bases") / "a")
    _build(96, 50, np.float32, 1e-5, 6).save(d)
    return d


def _wait_until(cond, timeout=WAIT_S, step=0.005):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(step)
    return False


# ----------------------------------------------------------- buckets ----
def test_batch_bucket_powers_of_two_with_floor_two():
    assert [batch_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9, 16, 17)] == \
        [2, 2, 4, 4, 8, 8, 16, 16, 32]
    with pytest.raises(ValueError):
        batch_bucket(0)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.float64,
                                   np.complex128])
def test_padded_bucket_eval_bitwise_vs_unpadded(dtype):
    """Ragged batch widths through the cache == unpadded direct eval, bit
    for bit — and each column == the per-request direct eval, in every
    dtype the engine serves."""
    basis = _build(64, 40, dtype, 1e-5, 7)
    eim = basis.eim()
    cache = InterpolantCache()
    for width in (1, 2, 3, 5, 7, 16, 33):
        F = _requests(basis, width, seed=width)
        out, bucket, _ = cache.evaluate(f"b_{dtype.__name__}", eim,
                                        torch.as_tensor(F))
        assert bucket == batch_bucket(width)
        assert tuple(out.shape) == (basis.N, width)
        assert out.device.type == "cpu"
        assert torch.equal(out, direct_interpolate(eim, F))
        for j in range(width):
            assert torch.equal(out[:, j], direct_interpolate(eim, F[:, j]))


@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.float64,
                                   np.complex128])
def test_apply_columns_independent_of_width(dtype):
    """The CPU apply at the GW basis's k (83) over buckets 2..128: every
    column has the bits it has at the full width."""
    from repro_torch.kernels.roq_apply.ops import roq_apply

    rng = np.random.default_rng(5)

    def rand(*shape):
        x = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(shape)
        return torch.as_tensor(x.astype(dtype))

    B, F = rand(500, 83), rand(83, 128)
    full = roq_apply(B, F)
    for b in (2, 3, 4, 8, 16, 31, 32, 64, 128):
        assert torch.equal(roq_apply(B, F[:, :b].contiguous()), full[:, :b])


def test_cache_warm_after_first_bucket_and_evict():
    basis = _build(48, 30, np.float32, 1e-5, 5)
    cache = InterpolantCache()
    F = torch.as_tensor(_requests(basis, 3))
    _, bucket, warm0 = cache.evaluate("x", basis.eim(), F)
    _, _, warm1 = cache.evaluate("x", basis.eim(), F)
    assert (warm0, warm1) == (False, True)
    assert cache.warm_keys("x") == [("x", 0, bucket, str(F.dtype))]
    cache.evict("x")
    assert cache.warm_keys("x") == []
    _, _, warm2 = cache.evaluate("x", basis.eim(), F)
    assert warm2 is False


# ------------------------------------------------------------ router ----
def test_router_lru_eviction_reload_roundtrip(artifacts):
    evicted = []
    # budget of 1 byte: exactly the requested basis stays resident
    router = _router(memory_budget_bytes=1, on_evict=evicted.append)
    for bid, d in artifacts.items():
        router.register(bid, d)
    b1, e1 = router.get("f32_greedy")
    q1 = b1.Q.clone()
    assert router.loaded_ids() == ["f32_greedy"]
    router.get("c64_pod")
    assert router.loaded_ids() == ["c64_pod"]
    assert evicted == ["f32_greedy"]
    b1b, e1b = router.get("f32_greedy")  # reload round-trip
    assert evicted == ["f32_greedy", "c64_pod"]
    assert torch.equal(b1b.Q, q1)
    assert torch.equal(e1b.nodes, e1.nodes)
    assert torch.equal(e1b.B, e1.B)


def test_router_pinned_in_memory_basis_never_evicted(artifacts):
    pinned = _build(48, 30, np.float32, 1e-5, 5)
    assert pinned.directory is None
    router = _router(memory_budget_bytes=1)
    router.register("pinned", pinned)
    router.register("disk", artifacts["f32_greedy"])
    router.get("pinned")
    router.get("disk")
    assert sorted(router.loaded_ids()) == ["disk", "pinned"]


def test_router_unknown_and_duplicate_ids(artifacts):
    router = _router(memory_budget_bytes=1 << 30)
    router.register("a", artifacts["f32_greedy"])
    with pytest.raises(ValueError, match="already registered"):
        router.register("a", artifacts["c64_pod"])
    with pytest.raises(KeyError, match="unknown basis_id"):
        router.get("nope")
    with pytest.raises(TypeError):
        router.register("b", 123)


def test_router_default_budget_honors_env(monkeypatch):
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", str(12345))
    assert _router().memory_budget_bytes == 12345
    monkeypatch.delenv("REPRO_DEVICE_MEM_BUDGET")
    from repro_torch.api.build import device_memory_budget

    # a CPU router plans against half the host's available memory
    assert device_memory_budget(CPU) > 0
    assert _router().memory_budget_bytes > 0


def test_router_entry_bytes_from_sizes(artifacts):
    router = _router(memory_budget_bytes=1 << 30)
    router.register("a", artifacts["f32_greedy"])
    entry = router.get_entry("a")
    b, e = entry.basis, entry.eim
    assert entry.nbytes == (b.Q.numel() * 4 + e.B.numel() * 4
                            + e.nodes.numel() * e.nodes.element_size())
    assert router.stats()["resident_bytes"] == entry.nbytes


# ------------------------------------------------------------ engine ----
def test_engine_serves_bitwise_and_routes(artifacts):
    with _engine(artifacts, max_batch=4, max_wait_ms=1.0) as eng:
        futs = []
        for bid in artifacts:
            basis, _ = eng.router.get(bid)
            F = _requests(basis, 9, seed=3)
            futs += [(bid, F[:, j], eng.submit(bid, F[:, j]))
                     for j in range(9)]
        for bid, f, fut in futs:
            out = fut.result(timeout=WAIT_S)
            _, eim = eng.router.get(bid)
            assert out.device.type == "cpu"
            assert torch.equal(out, direct_interpolate(eim, f))
    snap = eng.stats()
    assert snap["counters"]["completed"] == 18
    assert snap["counters"]["errors"] == 0
    assert snap["latency_ms"]["n"] == 18
    assert snap["latency_ms"]["p50"] <= snap["latency_ms"]["p99"]


def test_engine_takes_tensor_requests(artifacts):
    """A request may be a tensor as well as a numpy array."""
    with _engine({"a": artifacts["f32_greedy"]}, max_batch=4,
                 max_wait_ms=1.0) as eng:
        basis, eim = eng.router.get("a")
        F = torch.as_tensor(_requests(basis, 3, seed=8))
        futs = [eng.submit("a", F[:, j]) for j in range(3)]
        for j, fut in enumerate(futs):
            assert torch.equal(fut.result(timeout=WAIT_S),
                               direct_interpolate(eim, F[:, j]))


def test_engine_warm_prewarms_all_buckets(artifacts):
    with _engine({"a": artifacts["f32_greedy"]}, max_batch=8,
                 max_wait_ms=0.5) as eng:
        eng.warm("a")
        assert {k[2] for k in eng.cache.warm_keys("a")} == {2, 4, 8}
        basis, _ = eng.router.get("a")
        F = _requests(basis, 20)
        futs = [eng.submit("a", F[:, j]) for j in range(20)]
        for fut in futs:
            fut.result(timeout=WAIT_S)
    snap = eng.stats()
    assert snap["counters"]["cache_misses"] == 0
    assert snap["counters"]["cache_hits"] >= 3
    assert snap["cache_hit_rate"] == 1.0


def test_malformed_request_fails_alone_batchmates_serve(artifacts):
    eng = _engine({"a": artifacts["f32_greedy"]}, max_batch=8,
                  max_wait_ms=0.5, start=False)
    basis, eim = eng.router.get("a")
    F = _requests(basis, 3)
    good = [eng.submit("a", F[:, j]) for j in range(3)]
    bad_len = eng.submit("a", np.zeros(basis.k + 1, np.float32))
    bad_dtype = eng.submit("a", np.zeros(basis.k, np.complex64))
    bad_id = eng.submit("missing", F[:, 0])
    eng.start()
    eng.close(drain=True)
    for j, fut in enumerate(good):
        assert torch.equal(fut.result(timeout=WAIT_S),
                           direct_interpolate(eim, F[:, j]))
    with pytest.raises(ValueError, match="one value per EIM node"):
        bad_len.result(timeout=WAIT_S)
    with pytest.raises(ValueError, match="does not cast"):
        bad_dtype.result(timeout=WAIT_S)
    with pytest.raises(KeyError, match="unknown basis_id"):
        bad_id.result(timeout=WAIT_S)
    snap = eng.stats()
    assert snap["counters"]["completed"] == 3
    assert snap["counters"]["errors"] == 3


def test_submit_rejects_2d_batch_synchronously(artifacts):
    with _engine({"a": artifacts["f32_greedy"]}) as eng:
        with pytest.raises(ValueError, match="ONE vector"):
            eng.submit("a", np.zeros((4, 4), np.float32))


def test_timeout_expires_alone_batchmates_serve(artifacts):
    eng = _engine({"a": artifacts["f32_greedy"]}, max_batch=8,
                  max_wait_ms=0.5, start=False)
    basis, eim = eng.router.get("a")
    F = _requests(basis, 2)
    doomed = eng.submit("a", F[:, 0], timeout_s=0.0)
    ok = eng.submit("a", F[:, 1])
    time.sleep(0.01)  # let the deadline pass before the worker ever runs
    eng.start()
    eng.close(drain=True)
    with pytest.raises(TimeoutError):
        doomed.result(timeout=WAIT_S)
    assert torch.equal(ok.result(timeout=WAIT_S),
                       direct_interpolate(eim, F[:, 1]))
    snap = eng.stats()
    assert snap["counters"]["timeouts"] == 1
    assert snap["counters"]["completed"] == 1


def test_queue_full_backpressure_explicit_reject(artifacts):
    eng = _engine({"a": artifacts["f32_greedy"]}, queue_depth=2,
                  start=False)
    basis, _ = eng.router.get("a")
    F = _requests(basis, 3)
    f0 = eng.submit("a", F[:, 0])
    f1 = eng.submit("a", F[:, 1])
    with pytest.raises(QueueFullError, match="backpressure"):
        eng.submit("a", F[:, 2])
    assert eng.stats()["counters"]["rejected"] == 1
    eng.start()
    eng.close(drain=True)
    f0.result(timeout=WAIT_S)
    f1.result(timeout=WAIT_S)
    assert eng.stats()["counters"]["completed"] == 2


def test_injected_batch_fault_isolated_engine_survives(
        artifacts, monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_SERVE_RAISE_AT_BATCH", "1")
    monkeypatch.delenv("REPRO_FAULT_ONCE", raising=False)
    eng = _engine({"a": artifacts["f32_greedy"]}, max_batch=8,
                  max_wait_ms=0.5, start=False)
    basis, eim = eng.router.get("a")
    F = _requests(basis, 2)
    doomed = [eng.submit("a", F[:, j]) for j in range(2)]
    eng.start()
    for fut in doomed:  # batch 1: the injected fault fails ALL its requests
        with pytest.raises(RuntimeError, match="injected serving fault"):
            fut.result(timeout=WAIT_S)
    ok = eng.submit("a", F[:, 0])      # ... but only that batch
    assert torch.equal(ok.result(timeout=WAIT_S),
                       direct_interpolate(eim, F[:, 0]))
    eng.close(drain=True)
    snap = eng.stats()
    assert snap["counters"]["errors"] == 2
    assert snap["counters"]["completed"] == 1


def test_fault_once_marker_fires_once(artifacts, monkeypatch, tmp_path):
    """``REPRO_FAULT_ONCE`` arms the batch fault at most once: a second
    engine with the same marker serves batch 1."""
    monkeypatch.setenv("REPRO_FAULT_SERVE_RAISE_AT_BATCH", "1")
    monkeypatch.setenv("REPRO_FAULT_ONCE", str(tmp_path / "marker"))
    for expect_fault in (True, False):
        with _engine({"a": artifacts["f32_greedy"]}, max_batch=8,
                     max_wait_ms=0.5) as eng:
            basis, _ = eng.router.get("a")
            fut = eng.submit("a", _requests(basis, 1)[:, 0])
            err = fut.exception(timeout=WAIT_S)
            assert (err is not None) == expect_fault
    assert (tmp_path / "marker.serve_raise_at_batch").exists()


def test_close_drains_then_rejects_new_requests(artifacts):
    eng = _engine({"a": artifacts["f32_greedy"]}, max_batch=64,
                  max_wait_ms=1e4, start=False)  # no flush until drain
    basis, eim = eng.router.get("a")
    F = _requests(basis, 5)
    futs = [eng.submit("a", F[:, j]) for j in range(5)]
    eng.start()
    eng.close(drain=True)  # max_wait of 10s never elapsed: drain flushes
    for j, fut in enumerate(futs):
        assert torch.equal(fut.result(timeout=WAIT_S),
                           direct_interpolate(eim, F[:, j]))
    with pytest.raises(EngineClosedError):
        eng.submit("a", F[:, 0])


def test_close_abort_fails_pending(artifacts):
    eng = _engine({"a": artifacts["f32_greedy"]}, max_batch=64,
                  max_wait_ms=1e4, start=False)
    basis, _ = eng.router.get("a")
    fut = eng.submit("a", _requests(basis, 1)[:, 0])
    eng.start()
    eng.close(drain=False)
    with pytest.raises(EngineClosedError):
        fut.result(timeout=WAIT_S)


def test_router_eviction_drops_warm_cache_entries(artifacts):
    router = _router(memory_budget_bytes=1)
    for bid, d in artifacts.items():
        router.register(bid, d)
    with ROQEngine(router, max_batch=4, max_wait_ms=0.5) as eng:
        basis_a, _ = eng.router.get("f32_greedy")
        eng.submit("f32_greedy",
                   _requests(basis_a, 1)[:, 0]).result(timeout=WAIT_S)
        assert eng.cache.warm_keys("f32_greedy")
        eng.router.get("c64_pod")   # evicts f32_greedy
        assert eng.cache.warm_keys("f32_greedy") == []
        f = _requests(basis_a, 1, seed=9)[:, 0]
        out = eng.submit("f32_greedy", f).result(timeout=WAIT_S)
        _, eim = eng.router.get("f32_greedy")
        assert torch.equal(out, direct_interpolate(eim, f))
    assert eng.stats()["counters"]["basis_evictions"] >= 2


def test_concurrent_submitters_all_bitwise(artifacts):
    """Many threads hammering both bases: every response still exact."""
    with _engine(artifacts, max_batch=8, max_wait_ms=1.0,
                 queue_depth=4096) as eng:
        results = []
        lock = threading.Lock()

        def client(bid, seed):
            basis, eim = eng.router.get(bid)
            F = _requests(basis, 16, seed=seed)
            futs = [(F[:, j], eng.submit(bid, F[:, j])) for j in range(16)]
            good = all(torch.equal(fut.result(timeout=WAIT_S),
                                   direct_interpolate(eim, f))
                       for f, fut in futs)
            with lock:
                results.append(good)

        threads = [threading.Thread(target=client, args=(bid, s))
                   for s, bid in enumerate(list(artifacts) * 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert results and all(results)
    assert eng.stats()["counters"]["completed"] == 16 * len(threads)


# ------------------------------------------------- across the packages ----
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_jax_artifact_served_by_port(tmp_path, dtype):
    """A basis built and saved by the JAX package is served by the port:
    the port loads its EIM leaves (no recompute), and every answer is
    within dtype_tol of the reference's direct evaluation."""
    S = make_smooth_matrix(90, 50, dtype)
    ref = japi.build_basis(source=S, strategy="greedy", tau=1e-5, max_k=7)
    d = str(tmp_path / "jax_basis")
    ref.save(d)
    with _engine({"j": d}, max_batch=4, max_wait_ms=1.0) as eng:
        basis, eim = eng.router.get("j")
        assert "_eim" in vars(basis)
        assert torch.equal(eim.nodes.to(torch.int32),
                           torch.as_tensor(np.array(ref.eim().nodes)))
        F = _requests(basis, 6, seed=4)
        futs = [eng.submit("j", F[:, j]) for j in range(6)]
        outs = [fut.result(timeout=WAIT_S) for fut in futs]
    want = np.asarray(jax_direct(ref.eim(), jnp.asarray(F)))
    scale = float(np.abs(want).max())
    tol = dtype_tol(dtype, basis.k) * scale
    for j, out in enumerate(outs):
        np.testing.assert_allclose(out.numpy(), want[:, j], atol=tol, rtol=0)


# ----------------------------------------------- EIM artifact leaves ----
def test_eim_persisted_on_save_preseeded_on_load(artifacts):
    loaded = ReducedBasis.load(artifacts["f32_greedy"], CPU)
    assert "_eim" in vars(loaded)
    from repro_torch.core.eim import eim_nodes

    fresh = eim_nodes(loaded.Q)
    assert torch.equal(loaded.eim().nodes, fresh.nodes)
    assert torch.equal(loaded.eim().B, fresh.B)


def test_legacy_artifact_without_eim_leaves_recomputes(tmp_path):
    """Artifacts saved before the EIM leaves existed still load and serve;
    eim() falls back to recomputing."""
    import json

    from repro_torch.checkpoint.io import save_checkpoint

    basis = _build(48, 30, np.float32, 1e-5, 5)
    tree = {
        "artifact_version": np.asarray(1, np.int64),
        "Q": basis.Q.numpy(),
        "pivots": np.asarray(basis.pivots),
        "errs": np.asarray(basis.errs),
        "k": np.asarray(basis.k, np.int64),
        "provenance_json": np.asarray(json.dumps(basis.provenance,
                                                 default=str)),
    }
    save_checkpoint(tree, str(tmp_path), 0, meta={"final": True})
    loaded = ReducedBasis.load(str(tmp_path), CPU)
    assert "_eim" not in vars(loaded)
    assert torch.equal(loaded.eim().nodes, basis.eim().nodes)
    with _engine({"legacy": str(tmp_path)}, max_wait_ms=0.5) as eng:
        f = _requests(loaded, 1)[:, 0]
        assert torch.equal(eng.submit("legacy", f).result(timeout=WAIT_S),
                           direct_interpolate(loaded.eim(), f))


def test_eim_leaves_gated_on_version(tmp_path, monkeypatch):
    """A future eim_version is ignored (recompute), not misread."""
    import repro_torch.api.artifact as artifact_mod

    basis = _build(48, 30, np.float32, 1e-5, 5)
    monkeypatch.setattr(artifact_mod, "_EIM_VERSION", 999)
    basis.save(str(tmp_path))
    monkeypatch.undo()
    loaded = ReducedBasis.load(str(tmp_path), CPU)
    assert "_eim" not in vars(loaded)
    assert tuple(loaded.eim().B.shape) == (basis.N, basis.k)


# ------------------------------------------------------ launcher e2e ----
def test_serve_launcher_end_to_end(artifacts):
    from repro_torch.launch.serve import main

    stats = main(["--basis", artifacts["f32_greedy"],
                  "--basis", artifacts["c64_pod"],
                  "--max-batch", "8", "--max-wait-ms", "1",
                  "--requests", "64", "--device", CPU])
    assert stats["served"] == 64
    assert stats["counters"]["completed"] == 64
    assert stats["direct_mismatches"] == 0
    assert stats["max_err"] < 1e-4
    assert stats["latency_ms"]["n"] == 64
    assert stats["device"] == CPU
    for q in ("p50", "p95", "p99"):
        assert stats["latency_ms"][q] > 0.0


# ===================================================== robust serving ====
# ----------------------------------------------------- worker death ----
def test_worker_death_fails_futures_and_restarts(artifact, monkeypatch):
    """A fault injected into the BATCHING loop (outside per-batch
    isolation) fails every in-flight future with EngineUnhealthyError —
    never strands them — and the supervised worker comes back."""
    monkeypatch.setenv("REPRO_FAULT_SERVE_KILL_WORKER", "1")
    monkeypatch.delenv("REPRO_FAULT_ONCE", raising=False)
    # a wait long enough that the three requests make up the killed batch
    # even on a loaded host (at 1 ms the worker could flush the first one
    # alone, die, and refuse the next submits)
    with _engine({"a": artifact}, max_batch=8, max_wait_ms=100.0,
                 restart=RestartPolicy(backoff_base_s=0.01)) as eng:
        basis, eim = eng.router.get("a")
        F = _requests(basis, 3)
        futs = [eng.submit("a", F[:, j]) for j in range(3)]
        for fut in futs:   # the killed batch: failed, not hung
            with pytest.raises(EngineUnhealthyError):
                fut.result(timeout=WAIT_S)
        assert _wait_until(eng.healthy)   # supervision restarted it
        f = _requests(basis, 1, seed=7)[:, 0]
        out = eng.submit("a", f).result(timeout=WAIT_S)
        assert torch.equal(out, direct_interpolate(eim, f))
    snap = eng.stats()
    assert snap["counters"]["worker_deaths"] == 1
    assert snap["counters"]["worker_restarts"] == 1
    trans = snap["health"]["transitions"]
    assert [t["healthy"] for t in trans] == [True, False, True]


def test_worker_death_without_restart_latches_unhealthy(
        artifact, monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_SERVE_KILL_WORKER", "1")
    monkeypatch.delenv("REPRO_FAULT_ONCE", raising=False)
    eng = _engine({"a": artifact}, max_batch=8, max_wait_ms=1.0,
                  restart=RestartPolicy(enabled=False))
    basis, _ = eng.router.get("a")
    fut = eng.submit("a", _requests(basis, 1)[:, 0])
    with pytest.raises(EngineUnhealthyError):
        fut.result(timeout=WAIT_S)
    assert _wait_until(lambda: not eng.healthy())
    with pytest.raises(EngineUnhealthyError):   # intake refused while down
        eng.submit("a", _requests(basis, 1)[:, 0])
    snap = eng.stats()
    assert snap["counters"]["worker_deaths"] == 1
    assert snap["counters"]["worker_restarts"] == 0
    assert snap["healthy"] is False
    eng.close()


def test_restart_tracker_window_and_backoff():
    p = RestartPolicy(max_restarts=2, window_s=10.0,
                      backoff_base_s=0.5, backoff_cap_s=4.0)
    tr = RestartTracker(p)
    assert tr.next_delay(now=100.0) == 0.5          # 2**0
    assert tr.next_delay(now=100.1) == 1.0          # 2**1
    assert tr.next_delay(now=100.2) is None         # budget exhausted
    assert tr.next_delay(now=111.0) == 0.5          # window slid
    assert RestartTracker(RestartPolicy(enabled=False)).next_delay() is None


# ----------------------------------------------------- close()/submit race ----
def test_submit_racing_close_never_strands_future(artifact):
    """A request enqueued between submit's intake check and close()'s final
    drain still resolves (with EngineClosedError), not hangs."""
    eng = _engine({"a": artifact}, start=False)
    basis = ReducedBasis.load(artifact, CPU)
    orig_put = eng._queue.put_nowait

    def racing_put(req):   # close() wins the race right after the enqueue
        orig_put(req)
        eng._closed = True

    eng._queue.put_nowait = racing_put
    fut = eng.submit("a", _requests(basis, 1)[:, 0])
    assert fut.done()
    with pytest.raises(EngineClosedError):
        fut.result(timeout=0)
    eng._queue.put_nowait = orig_put
    eng.close(drain=False)


def _mkreq(basis):
    from repro_torch.serving.roq import _Request

    return _Request(basis_id="a",
                    f=torch.as_tensor(_requests(basis, 1)[:, 0]),
                    future=concurrent.futures.Future(),
                    t_submit=time.perf_counter(), deadline=None)


def test_close_drains_queue_left_by_dead_worker(artifact, monkeypatch):
    """With the worker down and restarts disabled, close() fails whatever
    is still queued — exactly-once resolution, no strands."""
    monkeypatch.setenv("REPRO_FAULT_SERVE_KILL_WORKER", "1")
    monkeypatch.delenv("REPRO_FAULT_ONCE", raising=False)
    eng = _engine({"a": artifact}, max_batch=8, max_wait_ms=1.0,
                  restart=RestartPolicy(enabled=False))
    basis, _ = eng.router.get("a")
    fut = eng.submit("a", _requests(basis, 1)[:, 0])
    with pytest.raises(EngineUnhealthyError):
        fut.result(timeout=WAIT_S)
    assert _wait_until(lambda: not eng._worker.is_alive())
    req = _mkreq(basis)     # sneak a request past intake onto the dead queue
    eng._queue.put_nowait(req)
    eng.close()
    assert req.future.done()
    with pytest.raises(EngineClosedError):
        req.future.result(timeout=0)


# ------------------------------------------------- deadlines while waiting ----
def test_deadline_enforced_while_waiting(artifact):
    """timeout_s far below max_wait_ms gets a PROMPT TimeoutError."""
    with _engine({"a": artifact}, max_batch=64, max_wait_ms=2000.0) as eng:
        basis, _ = eng.router.get("a")
        t0 = time.monotonic()
        fut = eng.submit("a", _requests(basis, 1)[:, 0], timeout_s=0.05)
        with pytest.raises(TimeoutError):
            fut.result(timeout=WAIT_S)
        elapsed = time.monotonic() - t0
        assert elapsed < 1.0, f"deadline enforced lazily ({elapsed:.2f}s)"
    assert eng.stats()["counters"]["timeouts"] == 1


# ------------------------------------------------------------- admission ----
def test_quota_token_bucket_per_client():
    ctl = AdmissionController(client_rate=10.0, client_burst=2)
    now = 1000.0
    ctl.admit("alice", None, now)
    ctl.admit("alice", None, now)
    with pytest.raises(QuotaExceededError):
        ctl.admit("alice", None, now)       # burst spent
    ctl.admit("bob", None, now)             # other clients unaffected
    ctl.admit("alice", None, now + 0.1)     # refilled one token (10/s)
    with pytest.raises(QuotaExceededError):
        ctl.admit("alice", None, now + 0.1)


def test_quota_tightens_in_degraded_mode():
    ctl = AdmissionController(client_rate=10.0, client_burst=1,
                              degraded_factor=0.5)
    now = 1000.0
    ctl.admit("c", None, now)
    assert ctl.set_degraded(True)
    with pytest.raises(QuotaExceededError):
        ctl.admit("c", None, now + 0.1)   # 0.5 tokens under the halved rate
    ctl.admit("c", None, now + 0.2)
    assert ctl.set_degraded(False)
    assert not ctl.set_degraded(False)   # idempotent


def test_shed_hopeless_deadline():
    ctl = AdmissionController(delay_estimator=lambda: 1.0)
    now = 1000.0
    with pytest.raises(ShedError):
        ctl.admit(None, now + 0.1, now)    # 100ms budget vs 1s backlog
    ctl.admit(None, now + 5.0, now)        # feasible deadline admitted
    ctl.admit(None, None, now)             # no deadline: never shed
    cold = AdmissionController(delay_estimator=lambda: 0.0)
    cold.admit(None, now + 1e-9, now)      # no backlog estimate: admit


def test_engine_sheds_under_measured_backlog(artifact):
    eng = _engine({"a": artifact}, max_batch=4, start=False)
    basis, _ = eng.router.get("a")
    eng._batch_ewma_s = 1.0     # pretend batches take 1s
    for _ in range(8):          # unserviced backlog: est = 8/4 * 1s = 2s
        eng.submit("a", _requests(basis, 1)[:, 0])
    with pytest.raises(ShedError):
        eng.submit("a", _requests(basis, 1)[:, 0], timeout_s=0.01)
    eng.submit("a", _requests(basis, 1)[:, 0], timeout_s=30.0)
    snap = eng.stats()
    assert snap["counters"]["shed"] == 1
    assert snap["estimated_delay_ms"] > 0
    eng.close(drain=False)


def test_degraded_mode_watermarks_and_hysteresis(artifact):
    eng = _engine({"a": artifact}, max_batch=4, queue_depth=8,
                  degrade_queue_frac=0.5, start=False)
    basis, _ = eng.router.get("a")
    for _ in range(5):          # 5/8 = 62% > 50% watermark
        eng.submit("a", _requests(basis, 1)[:, 0])
    eng._update_pressure(time.perf_counter())
    assert eng.admission.degraded
    eng._fail_all_pending(EngineClosedError("test drain"))
    eng._last_pressure_check = 0.0   # bypass the 20 Hz throttle
    eng._update_pressure(time.perf_counter())   # 0/8 <= half watermark
    assert not eng.admission.degraded
    snap = eng.stats()
    assert snap["counters"]["degraded_entered"] == 1
    assert snap["counters"]["degraded_exited"] == 1
    assert snap["gauges"]["degraded"] == 0
    eng.close(drain=False)


# ------------------------------------------------------ circuit breakers ----
def test_breaker_lifecycle_unit():
    bd = CircuitBreakerBoard(threshold=2, cooldown_s=5.0)
    bd.allow("b", now=0.0)
    bd.record_failure("b", now=0.0)
    bd.allow("b", now=0.1)                     # under threshold: closed
    bd.record_failure("b", now=0.2)            # 2nd consecutive -> OPEN
    assert bd.state("b") == "open"
    with pytest.raises(CircuitOpenError):
        bd.allow("b", now=1.0)                 # inside cooldown
    bd.allow("b", now=6.0)                     # cooldown over -> HALF_OPEN
    assert bd.state("b") == "half_open"
    bd.on_batch_start("b")                     # probe batch in flight
    with pytest.raises(CircuitOpenError):
        bd.allow("b", now=6.1)
    bd.record_success("b")                     # probe served -> CLOSED
    assert bd.state("b") == "closed"
    bd.allow("b", now=6.2)
    bd.record_failure("b", now=7.0)
    bd.record_failure("b", now=7.1)
    bd.allow("b", now=13.0)                    # half-open again
    bd.record_failure("b", now=13.1)           # a failed probe re-opens
    assert bd.state("b") == "open"


def test_engine_breaker_opens_and_recovers(artifact):
    with _engine({"a": artifact}, max_batch=4, max_wait_ms=0.5,
                 breaker_threshold=2, breaker_cooldown_s=0.2) as eng:
        basis, eim = eng.router.get("a")
        real_evaluate = eng.cache.evaluate

        def broken(*a, **k):
            raise RuntimeError("injected basis meltdown")

        eng.cache.evaluate = broken
        for _ in range(2):   # two consecutive failed batches -> OPEN
            fut = eng.submit("a", _requests(basis, 1)[:, 0])
            with pytest.raises(RuntimeError, match="meltdown"):
                fut.result(timeout=WAIT_S)
        with pytest.raises(CircuitOpenError):   # fast-fail, no queueing
            eng.submit("a", _requests(basis, 1)[:, 0])
        eng.cache.evaluate = real_evaluate
        time.sleep(0.3)      # past cooldown: next request is the probe
        f = _requests(basis, 1, seed=3)[:, 0]
        out = eng.submit("a", f).result(timeout=WAIT_S)
        assert torch.equal(out, direct_interpolate(eim, f))
        assert eng.breakers.state("a") == "closed"
    snap = eng.stats()
    assert snap["counters"]["breaker_opened"] >= 1
    assert snap["counters"]["breaker_rejected"] >= 1
    assert snap["counters"]["breaker_half_open"] >= 1
    assert snap["counters"]["breaker_closed"] >= 1


def test_router_load_fault_feeds_breaker(artifact, monkeypatch):
    """``REPRO_FAULT_SERVE_RAISE_AT_LOAD`` fails the router's load: the
    batch's requests fail with the IOError and the breaker counts it."""
    monkeypatch.setenv("REPRO_FAULT_SERVE_RAISE_AT_LOAD", "a")
    monkeypatch.delenv("REPRO_FAULT_ONCE", raising=False)
    basis = ReducedBasis.load(artifact, CPU)
    with _engine({"a": artifact}, max_batch=4, max_wait_ms=0.5,
                  breaker_threshold=1, breaker_cooldown_s=60.0) as eng:
        fut = eng.submit("a", _requests(basis, 1)[:, 0])
        with pytest.raises(IOError, match="injected router load fault"):
            fut.result(timeout=WAIT_S)
        assert _wait_until(lambda: eng.breakers.state("a") == "open")
        with pytest.raises(CircuitOpenError):
            eng.submit("a", _requests(basis, 1)[:, 0])


# ------------------------------------------------------- hot artifact reload ----
def test_refresh_swaps_generations_bitwise(tmp_path):
    d = str(tmp_path / "hot")
    _build(80, 40, np.float32, 1e-5, 4).save(d)
    with _engine({"hot": d}, max_batch=4, max_wait_ms=0.5) as eng:
        basis1, eim1 = eng.router.get("hot")
        f1 = _requests(basis1, 1)[:, 0]
        out1 = eng.submit("hot", f1).result(timeout=WAIT_S)
        assert torch.equal(out1, direct_interpolate(eim1, f1))
        # rebuild offline (larger basis), save a NEW artifact step in place
        b2 = _build(80, 40, np.float32, 1e-6, 8)
        b2.save(d)
        assert eng.refresh("hot") == 1
        basis2, eim2 = eng.router.get("hot")
        assert basis2.k == b2.k
        f2 = _requests(basis2, 1, seed=5)[:, 0]
        out2 = eng.submit("hot", f2).result(timeout=WAIT_S)
        assert torch.equal(out2, direct_interpolate(eim2, f2))
        # old generation's warm entries were retired, new gen is live
        assert all(k[1] == 1 for k in eng.cache.warm_keys("hot"))
    snap = eng.stats()
    assert snap["counters"]["reloads"] == 1
    assert snap["router"]["generations"] == {"hot": 1}


def test_refresh_rejects_corrupt_candidate_keeps_serving(tmp_path):
    d = str(tmp_path / "hot")
    _build(64, 32, np.float32, 1e-5, 4).save(d)
    with _engine({"hot": d}, max_batch=4, max_wait_ms=0.5) as eng:
        basis, eim = eng.router.get("hot")
        # a rebuild lands... and rots on disk before the swap
        _build(64, 32, np.float32, 1e-6, 6).save(d)
        from repro_torch.checkpoint.io import list_steps

        step_dir = os.path.join(d, f"step_{list_steps(d)[-1]:08d}")
        victim = next(p for p in sorted(os.listdir(step_dir))
                      if p.endswith(".npy"))
        path = os.path.join(step_dir, victim)
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        with pytest.raises((IOError, KeyError)):
            eng.refresh("hot")
        # live basis untouched: same generation, still serving bitwise
        f = _requests(basis, 1, seed=2)[:, 0]
        out = eng.submit("hot", f).result(timeout=WAIT_S)
        assert torch.equal(out, direct_interpolate(eim, f))
    snap = eng.stats()
    assert snap["counters"]["reload_failures"] == 1
    assert snap["counters"]["reloads"] == 0
    assert snap["router"]["generations"] == {}


def test_refresh_injected_corruption_hook(artifact, monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_SERVE_CORRUPT_RELOAD", "1")
    monkeypatch.delenv("REPRO_FAULT_ONCE", raising=False)
    with _engine({"a": artifact}, max_wait_ms=0.5) as eng:
        with pytest.raises(IOError, match="injected corrupt reload"):
            eng.refresh("a")
    assert eng.stats()["counters"]["reload_failures"] == 1


# ------------------------------------------------------- overload soak ----
def test_overload_soak_every_submit_resolves_exactly_once(
        artifact, monkeypatch):
    """Sustained overload with slow batches, a tight queue, quotas and
    mixed deadlines: every submit ends in EXACTLY one bucket — bitwise
    result, QueueFullError, ShedError, QuotaExceededError or TimeoutError
    — and the metrics counters sum to the offered load."""
    monkeypatch.setenv("REPRO_FAULT_SERVE_SLOW_BATCH", "3")   # 3ms/batch
    eng = _engine({"a": artifact}, max_batch=4, max_wait_ms=1.0,
                  queue_depth=16, client_rate=400.0, client_burst=40.0)
    basis, eim = eng.router.get("a")
    n_threads, per_thread = 4, 60
    lock = threading.Lock()
    sync_rejects = {"queue_full": 0, "shed": 0, "quota": 0}
    accepted = []   # (future, f_vector)

    def client(tid):
        rng = np.random.default_rng(tid)
        for i in range(per_thread):
            f = _requests(basis, 1, seed=tid * 1000 + i)[:, 0]
            timeout = None if rng.random() < 0.5 else \
                float(rng.choice([0.002, 0.05, 5.0]))
            try:
                fut = eng.submit("a", f, timeout_s=timeout,
                                 client_id=f"client-{tid}")
            except QueueFullError:
                with lock:
                    sync_rejects["queue_full"] += 1
            except ShedError:
                with lock:
                    sync_rejects["shed"] += 1
            except QuotaExceededError:
                with lock:
                    sync_rejects["quota"] += 1
            else:
                with lock:
                    accepted.append((fut, f))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    eng.close(drain=True)   # serve/fail everything accepted

    offered = n_threads * per_thread
    served = timed_out = 0
    for fut, f in accepted:
        err = fut.exception(timeout=WAIT_S)   # never hangs
        if err is None:
            assert torch.equal(fut.result(), direct_interpolate(eim, f))
            served += 1
        elif isinstance(err, TimeoutError):
            timed_out += 1
        else:
            pytest.fail(f"unexpected resolution: {err!r}")
    assert served + timed_out == len(accepted)
    assert len(accepted) + sum(sync_rejects.values()) == offered

    c = eng.stats()["counters"]
    assert c["submitted"] == len(accepted)
    assert c["completed"] == served
    assert c["timeouts"] == timed_out
    assert c["rejected"] == sync_rejects["queue_full"]
    assert c["shed"] == sync_rejects["shed"]
    assert c["quota_rejected"] == sync_rejects["quota"]
    assert c["submitted"] == c["completed"] + c["timeouts"] + c["errors"]
    assert c["errors"] == 0
    assert c["worker_deaths"] == 0
