"""The port's column-distributed greedy vs the JAX reference, and its own
contracts.

Two groups of cases, both on the CPU over gloo:

- a world of one rank in this process (a ``FileStore`` in a temporary
  directory, created and destroyed by a module fixture), held to the
  reference's ``distributed_greedy`` on a one-device mesh for the cases of
  ``tests/test_api.py`` and ``tests/test_fault_matrix.py``;
- one spawned group of 4 ranks (``_torch_dist_ranks.cases``) running the
  cases of ``tests/test_distributed_greedy.py`` and of the distributed
  chunk tests of ``tests/test_chunked_driver.py`` on their 600 x 256
  complex128 GW family, at meshes (4,) and (2, 2) (the chunk and blocked
  cases at (4,)): held to the reference's
  serial ``rb_greedy`` (k, stop and pivots exact, errs within 1e-10) and to
  the port's serial drivers bit for bit; then a 2-rank group resumes the
  4-rank build's checkpoint (elastic).

Tolerances: the world-1 comparisons hold pivots, k and stop exact and Q
and errs within ``dtype_tol`` scaled by each basis vector's amplification
(scale / err_j, as ``test_torch_greedy.py`` derives it).
"""

import datetime
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from conftest import dtype_tol, make_smooth_matrix

import _torch_dist_ranks as ranks
from repro.core import distributed as jd
from repro.core import greedy as jg
from repro_torch.core import distributed as td
from repro_torch.core import greedy as tg
from repro_torch.launch.mesh import spawn_ranks

CPU = "cpu"
SPAWN_TIMEOUT_S = 240


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def floor_regime_matrix(seed=7, N=200, M=160, r=50, sigma=1.45e-7):
    """The reference's fault-matrix floor scenario (same construction):
    an f32 family whose exact residual plateaus above a tiny tau."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((N, r)))
    V, _ = np.linalg.qr(rng.standard_normal((M, r)))
    sv = np.logspace(0, -4, r)
    return ((U * sv) @ V.T + sigma * rng.standard_normal((N, M))).astype(
        np.float32)


# --------------------------------------------- one rank, in this process --


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo group of one rank and its (1,) mesh."""
    from repro.compat import make_auto_mesh as jax_mesh
    from repro_torch.compat import make_auto_mesh

    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "s"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield make_auto_mesh((1,), ("cols",), CPU), jax_mesh((1,), ("cols",))
    finally:
        dist.destroy_process_group()


def _assert_close(port, ref, dtype):
    """k, stop and pivots exact; Q and errs within dtype_tol, amplified
    by scale / err_j for basis vector j (its residual scaled to unit
    norm)."""
    k = int(ref.k)
    assert port.k == k >= 5
    assert int(port.stop) == int(ref.stop)
    np.testing.assert_array_equal(_np(port.pivots)[:k], _np(ref.pivots)[:k])
    N = port.Q.shape[0]
    tol = dtype_tol(dtype, N)
    err_ref = _np(ref.errs)[:k].astype(np.float64)
    scale = float(err_ref[0])
    grow = scale / np.maximum(err_ref, tol * scale)
    dq = np.abs(_np(port.Q)[:, :k] - _np(ref.Q)[:, :k])
    assert np.all(dq <= tol * grow[None, :]), float((dq / grow).max())
    de = np.abs(_np(port.errs)[:k] - err_ref)
    assert np.all(de <= tol * scale * (1 + grow)), "errs"


@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.float64,
                                   np.complex128])
def test_world1_matches_jax_distributed(world1, dtype):
    """The reference's single-device distributed case (tests/test_api.py)
    over the four types, on the smooth family.  Single precision stops at
    1e-2 of the column scale, where its pivots stand well apart (the
    margin of the serial parity tests, test_torch_greedy.py); double at
    1e-6."""
    mesh, jmesh = world1
    S = make_smooth_matrix(dtype=dtype)
    tau = 1e-6 if dtype in (np.float64, np.complex128) \
        else 1e-2 * float(np.linalg.norm(S, axis=0).max())
    ref = jd.distributed_greedy(jnp.asarray(S), tau, min(S.shape), jmesh,
                                backend="xla")
    port = td.distributed_greedy(S, tau, min(S.shape), mesh, device=CPU)
    _assert_close(port, ref, dtype)


def test_world1_front_door_is_the_core_call(world1):
    """strategy="distributed" hands back exactly what distributed_greedy
    produces, and "auto" with a mesh resolves to it."""
    from repro_torch.api import build_basis

    mesh, _ = world1
    S = make_smooth_matrix(dtype=np.complex64)
    core = td.distributed_greedy(S, 1e-3, min(S.shape), mesh, device=CPU)
    k = core.k
    for strategy in ("distributed", "auto"):
        b = build_basis(source=S, strategy=strategy, tau=1e-3, mesh=mesh,
                        device=CPU)
        assert b.provenance["strategy"] == "distributed"
        assert b.provenance["spec"]["mesh"] == {"axis_names": ["cols"],
                                                "shape": [1]}
        assert b.k == k
        assert torch.equal(b.Q, core.Q[:, :k])
        assert np.array_equal(b.pivots, _np(core.pivots)[:k])
        assert np.array_equal(b.errs, _np(core.errs)[:k])
        assert np.array_equal(b.R, _np(core.R)[:k])


def test_distributed_requires_mesh():
    from repro_torch.api import build_basis

    with pytest.raises(ValueError, match="mesh"):
        build_basis(source=make_smooth_matrix(dtype=np.complex64),
                    strategy="distributed", tau=1e-3, device=CPU)


def test_world1_block_p_matches_jax_and_resident_blocked(world1):
    """block_p > 1 on a mesh runs the blocked distributed sweep: the
    reference's case (tests/test_api.py: complex64, tau 1e-3, block_p 2)
    is the port's resident blocked driver bit for bit; against the
    reference's driver on a one-device mesh, complex128 at tau 1e-6 (in
    complex64 two of the block's candidates tie to rounding, and the two
    packages order them differently)."""
    from repro_torch.api import build_basis
    from repro_torch.core.block_greedy import _rb_greedy_block_impl

    mesh, jmesh = world1
    S = make_smooth_matrix(dtype=np.complex64)
    b = build_basis(source=S, strategy="distributed", tau=1e-3, mesh=mesh,
                    block_p=2, device=CPU)
    res = _rb_greedy_block_impl(S, 1e-3, p=2, chunk=16, device=CPU)
    assert b.k == res.k
    assert np.array_equal(b.pivots, _np(res.pivots)[:res.k])
    assert torch.equal(b.Q, res.Q[:, :res.k])
    S = make_smooth_matrix(dtype=np.complex128)
    ref = jd.distributed_greedy(jnp.asarray(S), 1e-6, min(S.shape), jmesh,
                                block_p=2, backend="xla")
    _assert_close(td.distributed_greedy(S, 1e-6, min(S.shape), mesh,
                                        block_p=2, device=CPU),
                  ref, np.complex128)


def test_world1_floor_stop_matches_jax(world1):
    """tests/test_fault_matrix.py's floor case: STOP_FLOOR above tau in
    both packages, the pivots equal until the residual sinks into the
    noise floor."""
    mesh, jmesh = world1
    S = floor_regime_matrix()
    tau, safety = 1e-7, 2e6
    ref = jd.distributed_greedy(jnp.asarray(S), tau, min(S.shape), jmesh,
                                refresh_safety=safety, backend="xla")
    port = td.distributed_greedy(S, tau, min(S.shape), mesh,
                                 refresh_safety=safety, device=CPU)
    assert int(ref.stop) == port.stop == tg.STOP_FLOOR
    assert float(port.errs[port.k - 1]) > tau
    lead = 40
    assert port.k >= lead and int(ref.k) >= lead
    np.testing.assert_array_equal(_np(port.pivots)[:lead],
                                  _np(ref.pivots)[:lead])


def test_world1_checkpoint_is_the_reference_tree(world1, tmp_path):
    """The checkpoint tree has the reference's keys, dtypes, shapes and
    version, and a resumed build equals the uninterrupted one bit for
    bit; a tree of another shape or dtype is refused."""
    from repro_torch.checkpoint.io import load_checkpoint_raw

    mesh, jmesh = world1
    S = make_smooth_matrix(dtype=np.complex128)
    d = str(tmp_path / "ck")
    full = td.distributed_greedy(S, 1e-8, 60, mesh, chunk=4,
                                 checkpoint_dir=d, device=CPU)
    tree = load_checkpoint_raw(d)
    jS = jnp.asarray(S)
    jstate = jd.dist_greedy_init(jS, 60, jmesh)
    jtree = jd._dist_state_tree(jstate, 1.0, 1.0, False, 0)
    jtree["R"] = np.zeros((full.k, S.shape[1]), jtree["R"].dtype)
    assert sorted(tree) == sorted(jtree)
    for key in jtree:
        assert tree[key].dtype == jtree[key].dtype, key
        assert tree[key].shape == jtree[key].shape, key
    assert int(tree["k"]) == full.k and bool(int(tree["done"]))
    # a run stopped after its second chunk, resumed from the newest step
    d2 = str(tmp_path / "ck2")
    calls = []

    def stop(state):
        calls.append(int(state.k))
        if len(calls) > 2:
            raise ranks.Stop

    with pytest.raises(ranks.Stop):
        td.distributed_greedy(S, 1e-8, 60, mesh, chunk=4, callback=stop,
                              checkpoint_dir=d2, device=CPU)
    back = td.distributed_greedy(S, 1e-8, 60, mesh, chunk=4,
                                 checkpoint_dir=d2, resume=True, device=CPU)
    assert back.k == full.k and back.stop == full.stop
    for name in ("Q", "R", "pivots", "errs"):
        assert torch.equal(getattr(back, name), getattr(full, name)), name
    with pytest.raises(ValueError, match="shape mismatch"):
        td.distributed_greedy(S, 1e-8, 50, mesh, checkpoint_dir=d2,
                              resume=True, device=CPU)
    with pytest.raises(ValueError, match="dtype mismatch"):
        td.distributed_greedy(S.astype(np.complex64), 1e-8, 60, mesh,
                              checkpoint_dir=d2, resume=True, device=CPU)


def test_world1_mesh_rules(world1):
    """chunk >= 1; NCCL needs the card; the host and rank meshes
    and the dp/tp sizes read from their names; the layout of the state's
    leaves."""
    from repro_torch.compat import make_auto_mesh
    from repro_torch.launch.mesh import (
        dp_size, init_ranks, make_host_mesh, make_rank_mesh, tp_size,
    )

    mesh, _ = world1
    S = make_smooth_matrix(n=40, m=6, dtype=np.float64)
    with pytest.raises(ValueError, match="chunk must be"):
        td.distributed_greedy(S, 1e-6, 6, mesh, chunk=0, device=CPU)
    with pytest.raises(ValueError, match="nccl backend needs"):
        init_ranks("nccl", device=CPU)
    dm = make_auto_mesh((1, 1), ("data", "model"), CPU)
    assert dp_size(dm) == 1 and tp_size(dm) == 1 and td.is_writer(dm)
    assert make_host_mesh(device_type=CPU).mesh.shape == (1, 1)
    assert make_host_mesh(1, ("cols",), CPU).mesh_dim_names == ("cols",)
    pm = make_rank_mesh(CPU)
    assert pm.mesh_dim_names == ("data", "model")
    assert pm.mesh.shape == (1, 1)
    assert dp_size(pm) == 1 and tp_size(pm) == 1
    assert td.state_specs() == td.DistGreedyState(
        Q=None, R=1, norms_sq=0, acc=0, pivots=None, errs=None, k=None)


def test_world1_step_is_the_chunk(world1):
    """make_dist_greedy_step, one step a call, writes what the chunked
    driver writes: the same pivots, errors and basis, bit for bit."""
    mesh, _ = world1
    S = make_smooth_matrix(dtype=np.float64)
    full = td.distributed_greedy(S, 1e-6, 10, mesh, chunk=4, device=CPU)
    S_t = torch.from_numpy(S)
    state = td.dist_greedy_init(S_t, 10)
    step = td.make_dist_greedy_step(mesh, S.shape[1])
    for _ in range(full.k):
        state = step(S_t, state)
    k = full.k
    assert int(state.k) == k
    assert torch.equal(state.pivots[:k], full.pivots[:k])
    assert torch.equal(state.errs[:k], full.errs[:k])
    assert torch.equal(state.Q[:, :k], full.Q[:, :k])


# ------------------------------------------------ a spawned group of 4 ----


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 4-rank cases, then the 2-rank resume of the stopped build."""
    ckpt = str(tmp_path_factory.mktemp("elastic") / "ck")
    four = spawn_ranks(ranks.cases, 4, (ckpt,), device=CPU,
                       timeout_s=SPAWN_TIMEOUT_S)
    two = spawn_ranks(ranks.resume_on_two, 2, (ckpt,), device=CPU,
                      timeout_s=SPAWN_TIMEOUT_S)
    return four, two


@pytest.fixture(scope="module")
def jax_serial():
    S = jnp.asarray(_np(ranks.gw_matrix()))
    return jg.rb_greedy(S, tau=ranks.TAU)


def _bitwise(a, b):
    """k, stop, pivots, errs and Q equal bit for bit, and R's first k rows
    (at a tau or rank stop the distributed driver leaves row k as the
    reference's does, where the serial one zeroes it)."""
    k = a["k"]
    assert k == b["k"] and a["stop"] == b["stop"]
    for name in ("pivots", "errs", "Q"):
        assert np.array_equal(a[name], b[name]), name
    assert np.array_equal(a["R"][:k], b["R"][:k]), "R"


@pytest.mark.parametrize("mesh,chunk", [("(4,)", 1), ("(4,)", 16),
                                        ("(2, 2)", 16)])
def test_spawned_matches_jax_serial(group, jax_serial, mesh, chunk):
    """tests/test_distributed_greedy.py: the distributed build against the
    reference's serial rb_greedy: k, stop and pivots exact, errs within
    1e-10, orthonormal, every column within tau."""
    r = group[0][0][mesh, chunk]
    k = int(jax_serial.k)
    assert r["k"] == k and r["stop"] == int(jax_serial.stop)
    np.testing.assert_array_equal(r["pivots"][:k],
                                  _np(jax_serial.pivots)[:k])
    assert np.max(np.abs(r["errs"][:k] - _np(jax_serial.errs)[:k])) < 1e-10
    Q = r["Q"][:, :k]
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(k), 2) < 1e-12
    S = _np(ranks.gw_matrix())
    assert np.linalg.norm(S - Q @ (Q.conj().T @ S), axis=0).max() < 1e-4


@pytest.mark.parametrize("mesh,case", [
    *(("(4,)", case) for case in (*ranks.CHUNKS, "raw")), ("(2, 2)", 16)])
def test_spawned_bitwise_port_serial(group, mesh, case):
    """tests/test_chunked_driver.py's distributed chunk cases, held to the
    port's own serial driver at the same chunk, bit for bit (Q, R, errs,
    pivots, k, stop); "raw": the family as generated, whose first pivot
    is a tie to an ulp, which the port breaks the same way serial and
    distributed.  The reference's chunk-8 case against its serial driver
    is red on this host (ROADMAP.md queue 3); the port's is held to its
    serial driver here, and to the reference's by
    test_spawned_matches_jax_serial at chunks 1 and 16.  (The 64-column
    shards of a 256-column matrix keep the serial GEMVs' column bits on
    the CPU; other widths need not, test_elastic_resume_four_to_two.)"""
    out = group[0][0]
    _bitwise(out[mesh, case], out["serial", case])


@pytest.mark.parametrize("mesh", list(ranks.MESHES))
def test_spawned_chunk1_equals_chunk8(group, mesh):
    """Chunk 1 and chunk 8 give the same build (at mesh (2, 2), its chunk
    16 build is chunk 1's at mesh (4,): the mesh's shape only lays out
    the same 4 shards)."""
    out = group[0][0]
    other = out["(4,)", 8] if mesh == "(4,)" else out[mesh, 16]
    _bitwise(out["(4,)", 1], other)


def test_spawned_blocked_matches_resident_blocked(group):
    """block_p 4 on 4 ranks (mesh (4,), as the reference's case): the
    exchanged top-p selection and the sharded panel sweep reproduce the
    port's resident blocked driver bit for bit, and the reference's
    pivots."""
    from repro.core.block_greedy import _rb_greedy_block_impl

    mesh = "(4,)"
    out = group[0][0]
    _bitwise(out[mesh, "blocked"], out["serial", "blocked"])
    ref = _rb_greedy_block_impl(jnp.asarray(_np(ranks.gw_matrix())),
                                tau=ranks.TAU, p=ranks.BLOCK_P)
    k = int(ref.k)
    assert out[mesh, "blocked"]["k"] == k
    np.testing.assert_array_equal(out[mesh, "blocked"]["pivots"][:k],
                                  _np(ref.pivots)[:k])


def test_spawned_ranks_agree(group):
    """Every rank returns the same (replicated) result."""
    four = group[0]
    assert [r["world"] for r in four] == [4] * 4
    for key in [k for k in four[0] if isinstance(k, tuple)
                and k[0] != "serial"]:
        for r in four[1:]:
            _bitwise(r[key], four[0][key])


def test_elastic_resume_four_to_two(group):
    """A 4-rank build checkpointed after two chunks and resumed on 2
    ranks ends where the uninterrupted 4-rank build ends: k, stop and
    pivots exact, the errors bit for bit up to the checkpoint and within
    1e-10 after it (the reference test's bound), Q within 1e-9.  (The CPU's GEMV gives
    a column other bits in the 2 ranks' 128-column shards than in the 4
    ranks' 64-column ones, float64 too: ROADMAP.md queue 3, "Limits
    recorded".  The card's kernels do not: chip_smoke.py's phase
    distributed holds its elastic case bit for bit.)"""
    four, two = group
    at = ranks.ELASTIC_CHUNK * ranks.ELASTIC_CHUNKS
    assert four[0]["stopped_at_k"] == at
    full = four[0]["(4,)", 16]
    for got in two:
        assert got["k"] == full["k"] and got["stop"] == full["stop"]
        np.testing.assert_array_equal(got["pivots"], full["pivots"])
        assert np.array_equal(got["errs"][:at], full["errs"][:at])
        assert np.max(np.abs(got["errs"] - full["errs"])) < 1e-10
        k = full["k"]
        assert np.max(np.abs(got["Q"][:, :k] - full["Q"][:, :k])) < 1e-9


def test_spawned_workdir_is_finalized_once(group):
    """build_basis with a mesh and a workdir on 4 ranks (max_k 20): every
    rank gets the basis, rank 0 alone finalizes it (and drops the build
    scratch), and the artifact is that basis, the first 20 pivots of the
    full build."""
    from repro_torch.api import ReducedBasis

    four = group[0]
    work = four[0]["ckpt_dir"] + "_work"
    back = ReducedBasis.load(work, CPU)
    assert not os.path.exists(os.path.join(work, "build"))
    assert back.k == ranks.WORKDIR_K
    assert back.provenance["strategy"] == "distributed"
    np.testing.assert_array_equal(
        back.pivots, four[0]["(4,)", 16]["pivots"][:ranks.WORKDIR_K])
    for r in four:
        assert r["workdir"]["strategy"] == "distributed"
        assert np.array_equal(r["workdir"]["pivots"], back.pivots)
        assert np.array_equal(r["workdir"]["Q"], back.Q.numpy())


def test_torch_distributed_example_runs_on_cpu(group, capsys):
    """examples/torch_distributed_greedy.py's rank program on the 4 ranks,
    at half the reference demo's grid (600 x 256 complex128; the
    example's own size is 1,000 x 512), and its report: "auto" with a
    mesh runs "distributed", and its basis is the serial build's."""
    import importlib.util
    from pathlib import Path

    path = Path(ranks.EXAMPLES) / "torch_distributed_greedy.py"
    spec = importlib.util.spec_from_file_location("torch_distributed_greedy",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = group[0][0]["example"]
    assert all(r["example"] is None for r in group[0][1:])
    example.report(out, CPU)
    assert out["strategy"] == "distributed" and out["ranks"] == 4
    assert out["k"] == out["serial_k"] >= 50 and out["pivots_equal"]
    assert out["max_err"] < 1e-6
    assert "pivots equal: True" in capsys.readouterr().out


def test_failed_rank_fails_the_caller():
    """A rank that raises fails spawn_ranks at once, and the other rank
    is stopped; a group that overruns its timeout is stopped too."""
    import time

    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_ranks(ranks.fail_on_rank_one, 2, device=CPU, timeout_s=120)
    assert time.monotonic() - t0 < 60
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not done within"):
        spawn_ranks(ranks.fail_on_rank_one, 1, device=CPU, timeout_s=2)
    assert time.monotonic() - t0 < 60
