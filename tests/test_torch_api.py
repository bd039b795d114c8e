"""The port's front door vs the JAX reference: build_basis, artifacts that
load across the two packages, EIM/ROQ, TaylorF2 snapshots — and the port's
rules (no JAX imports, CUDA unless asked for the CPU).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import dtype_tol, make_smooth_matrix

import repro.api as japi
import repro_torch.api as tapi
from repro.core.eim import eim_nodes as jax_eim
from repro.core.eim import roq_weights as jax_roq
from repro.gw import build_snapshot_matrix as jax_snapshots
from repro.gw.waveform import taylorf2 as jax_taylorf2
from repro_torch.checkpoint import io as tio
from repro_torch.core.eim import eim_nodes, empirical_interpolant, roq_weights
from repro_torch.gw import build_snapshot_matrix, chirp_grid, frequency_grid
from repro_torch.gw.waveform import taylorf2

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _smooth(dtype=np.complex128):
    return make_smooth_matrix(n=150, m=90, dtype=dtype)


# ------------------------------------------------------------ front door --
@pytest.mark.parametrize("dtype", [np.complex64, np.float64])
def test_build_basis_matches_jax(dtype):
    """Same spec through both front doors: rank, pivots and stop exact;
    Q and errs within dtype_tol (tau above the cancellation floor, as in
    the driver parity tests); the port's provenance has every key the
    reference's has."""
    S = _smooth(dtype)
    tau = 1e-2 * float(np.linalg.norm(S, axis=0).max()) \
        if dtype == np.complex64 else 1e-6
    ref = japi.build_basis(source=S, strategy="greedy", tau=tau)
    port = tapi.build_basis(source=S, strategy="greedy", tau=tau,
                            device="cpu")
    assert port.k == ref.k >= 5
    np.testing.assert_array_equal(port.pivots, ref.pivots)
    assert port.pivots.dtype == ref.pivots.dtype == np.int32
    assert port.provenance["stop"] == ref.provenance["stop"]
    assert set(ref.provenance) <= set(port.provenance)
    assert port.provenance["backend"] == "auto"
    assert port.provenance["device"] == "cpu"
    assert port.provenance["dtype"] == ref.provenance["dtype"]
    tol = dtype_tol(dtype, S.shape[0])
    # the leading basis vectors have errs > 1e-2 errs[0], so their
    # rounding grows by at most scale / errs <= 100 (the growth factor of
    # test_torch_greedy._assert_parity); compare those columns
    lead = int(np.sum(ref.errs > 1e-2 * ref.errs[0]))
    np.testing.assert_allclose(_np(port.Q)[:, :lead], np.asarray(ref.Q)[
        :, :lead], atol=tol * 100)
    np.testing.assert_allclose(port.errs[:lead], ref.errs[:lead],
                               rtol=tol * 100)


# (dtype, tau, spec fields, the strategy "auto" resolves to): the CPU row
# of default roofs, a forced budget, a forced cache (roof-bound), both,
# and a rank target past twice the sketch's passes
AUTO_CASES = [
    (np.float64, 1e-6, {}, "greedy"),
    (np.float64, 1e-6, dict(memory_budget_bytes=1024, tile_m=40),
     "streamed"),
    (np.complex64, 1e-3, dict(cache_bytes=1), "block_greedy"),
    (np.float64, 1e-6, dict(memory_budget_bytes=1024, cache_bytes=1,
                            tile_m=40), "streamed"),
    (np.float64, 1e-6, dict(max_k=40, cache_bytes=1, tile_m=40),
     "randomized"),
]


@pytest.mark.parametrize("case", range(len(AUTO_CASES)))
def test_auto_strategy_matches_jax(case, caplog):
    """strategy="auto" through both front doors: the same choice, block_p
    and max_k in the provenance, the same rank; pivots and stop exact for
    the greedy family; the choice logged on the port's logger."""
    dtype, tau, kw, want = AUTO_CASES[case]
    S = _smooth(dtype)
    ref = japi.build_basis(source=S, tau=tau, **kw)
    with caplog.at_level("INFO", logger="repro_torch.api"):
        port = tapi.build_basis(source=S, tau=tau, device="cpu", **kw)
    assert port.provenance["requested_strategy"] == "auto"
    assert f"auto strategy -> {want!r}" in caplog.text
    for key in ("strategy", "block_p", "max_k"):
        assert port.provenance[key] == ref.provenance[key], key
    assert port.provenance["strategy"] == want
    assert port.k == ref.k >= 5
    if want != "randomized":
        np.testing.assert_array_equal(port.pivots, ref.pivots)
        assert port.provenance["stop"] == ref.provenance["stop"]


@pytest.mark.parametrize("strategy", ["distributed", "randomized",
                                      "sketch+greedy", "batched"])
def test_unported_strategy_names_roadmap(strategy):
    """Every strategy of the reference is ported and makes a spec:
    ``distributed`` (queue 1 item 7; its mesh is checked when the build
    runs, tests/test_torch_distributed.py), ``randomized`` and
    ``sketch+greedy`` (item 5) and ``batched`` (item 6); an unknown name
    raises."""
    if strategy in ("randomized", "sketch+greedy"):
        spec = tapi.ReductionSpec(source=np.zeros((4, 4)), strategy=strategy)
        assert spec.strategy == strategy and spec.sketch_p == 10
    elif strategy == "batched":
        spec = tapi.ReductionSpec(source=np.zeros((4, 4)), strategy=strategy,
                                  batch=3)
        assert spec.strategy == "batched" and spec.batch == 3
    else:
        spec = tapi.ReductionSpec(source=np.zeros((4, 4)), strategy=strategy)
        assert spec.strategy == "distributed" and spec.mesh is None
    with pytest.raises(ValueError, match="unknown strategy"):
        tapi.ReductionSpec(source=np.zeros((4, 4)), strategy="nope")


@pytest.mark.parametrize("adaptive", [False, True])
def test_block_greedy_front_door_matches_jax(adaptive):
    """strategy="block_greedy" through both front doors (the reference's
    adaptive scenario: smooth c64 family, tau 1e-3, block_p 8): rank,
    pivots, stop and the adaptive width trajectory exact; provenance
    carries block_p and every key the reference's has."""
    S = _smooth(np.complex64)
    kw = dict(source=S, strategy="block_greedy", tau=1e-3, block_p=8,
              adaptive_block=adaptive)
    ref = japi.build_basis(**kw)
    port = tapi.build_basis(**kw, device="cpu")
    assert port.k == ref.k >= 5
    np.testing.assert_array_equal(port.pivots, ref.pivots)
    assert set(ref.provenance) <= set(port.provenance)
    for key in ("strategy", "requested_strategy", "block_p", "stop"):
        assert port.provenance[key] == ref.provenance[key], key
    assert port.provenance["block_p"] == 8
    assert port.provenance["spec"]["panel_ortho"] is True
    if adaptive:
        traj = port.provenance["p_trajectory"]
        assert traj == ref.provenance["p_trajectory"]
        assert traj[0]["p"] == 8 and any(e["p"] < 8 for e in traj)
    else:
        assert "p_trajectory" not in port.provenance
    # the greedy front door records block_p 1, from its spec
    assert tapi.build_basis(source=S, tau=1e-3, device="cpu"
                            ).provenance["block_p"] == 1


def test_block_greedy_workdir_resume(tmp_path):
    """The blocked build owns a workdir like the greedy one, and its
    artifact loads in the reference with the same pivots."""
    S = _smooth(np.float64)
    wd = str(tmp_path / "w")
    b = tapi.build_basis(source=S, strategy="block_greedy", tau=1e-6,
                         block_p=4, chunk=8, workdir=wd, device="cpu")
    assert not os.path.exists(os.path.join(wd, "build"))
    again = tapi.build_basis(source=S, strategy="block_greedy", tau=1e-6,
                             block_p=4, chunk=8, workdir=wd, resume=True,
                             device="cpu")
    assert torch.equal(again.Q, b.Q)
    j = japi.ReducedBasis.load(wd)
    np.testing.assert_array_equal(j.pivots, b.pivots)
    assert j.provenance["block_p"] == 4


def test_workdir_lifecycle(tmp_path):
    """Finalized into the workdir, scratch removed; resume returns the
    finalized artifact without rebuilding."""
    S = _smooth()
    wd = str(tmp_path / "w")
    b = tapi.build_basis(source=S, tau=1e-6, workdir=wd, device="cpu")
    assert not os.path.exists(os.path.join(wd, "build"))
    again = tapi.build_basis(source=S, tau=1e-6, workdir=wd, resume=True,
                             device="cpu")
    assert torch.equal(again.Q, b.Q)
    assert again.provenance["wall_time_s"] == b.provenance["wall_time_s"]


# ---------------------------------------------- artifacts across packages --
def _assert_same_artifact(a_Q, a, b_Q, b):
    assert np.array_equal(a_Q, b_Q) and a_Q.dtype == b_Q.dtype
    for name in ("pivots", "errs", "R"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.k == b.k
    assert a.provenance == b.provenance


def test_jax_artifact_loads_in_port(tmp_path):
    ref = japi.build_basis(source=_smooth(), strategy="greedy", tau=1e-6)
    ref.save(str(tmp_path))
    port = tapi.ReducedBasis.load(str(tmp_path), device="cpu")
    _assert_same_artifact(_np(port.Q), port, np.asarray(ref.Q), ref)
    ei = ref.eim()
    assert np.array_equal(_np(port.eim().nodes), np.asarray(ei.nodes))
    assert np.array_equal(_np(port.eim().B), np.asarray(ei.B))


def test_port_artifact_loads_in_jax(tmp_path):
    port = tapi.build_basis(source=_smooth(), tau=1e-6, device="cpu")
    port.save(str(tmp_path))
    ref = japi.ReducedBasis.load(str(tmp_path))
    _assert_same_artifact(np.asarray(ref.Q), ref, _np(port.Q), port)
    assert np.array_equal(np.asarray(ref.eim().nodes),
                          _np(port.eim().nodes))
    assert np.asarray(ref.eim().nodes).dtype == np.int32
    assert np.array_equal(np.asarray(ref.eim().B), _np(port.eim().B))


def test_from_arrays_and_load_skip_corrupt_step(tmp_path):
    """A damaged newest step is skipped for the next intact one."""
    ref = japi.build_basis(source=_smooth(), strategy="greedy", tau=1e-6)
    b = tapi.ReducedBasis.from_arrays(np.asarray(ref.Q), ref.pivots,
                                      ref.errs, R=ref.R, device="cpu")
    b.save(str(tmp_path))
    newest = b.save(str(tmp_path))
    with open(os.path.join(newest, "Q.npy"), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x00" if f.read(1) != b"\x00" else b"\x01")
    assert tio.latest_step(str(tmp_path)) == 1
    loaded = tapi.ReducedBasis.load(str(tmp_path), device="cpu")
    assert np.array_equal(_np(loaded.Q), np.asarray(ref.Q))
    tio.prune_steps(str(tmp_path), keep=1)
    assert tio.list_steps(str(tmp_path)) == [1]


# ----------------------------------------------------------------- EIM/ROQ --
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_eim_and_roq_match_jax(rng, dtype):
    """Nodes exact; B and ROQ weights within dtype_tol scaled by the
    conditioning of the node matrix (B = Q Q[nodes]^-1)."""
    ref = japi.build_basis(source=_smooth(dtype), strategy="greedy",
                           tau=1e-2 if dtype == np.complex64 else 1e-6)
    Q = np.array(ref.Q)  # a writable copy: torch.from_numpy shares it
    port = tapi.ReducedBasis.from_arrays(Q, ref.pivots, ref.errs,
                                         device="cpu")
    je, te = jax_eim(jnp.asarray(Q)), port.eim()
    np.testing.assert_array_equal(_np(te.nodes), np.asarray(je.nodes))
    cond = np.linalg.cond(Q[np.asarray(je.nodes)])
    tol = dtype_tol(dtype, Q.shape[0]) * cond
    np.testing.assert_allclose(_np(te.B), np.asarray(je.B), atol=tol)
    data = (rng.standard_normal(Q.shape[0])
            + 1j * rng.standard_normal(Q.shape[0])).astype(dtype)
    w = np.full(Q.shape[0], 0.5)
    om = port.roq_weights(data, w)
    jom = jax_roq(jnp.asarray(data), jnp.asarray(w), je.B)
    np.testing.assert_allclose(_np(om), np.asarray(jom),
                               atol=tol * np.abs(data).sum())
    # the interpolant reproduces the basis exactly at its own columns
    np.testing.assert_allclose(
        _np(empirical_interpolant(te.B, te.nodes, torch.from_numpy(Q))), Q,
        atol=tol)
    assert torch.equal(eim_nodes(torch.from_numpy(Q)).nodes, te.nodes)
    assert torch.equal(roq_weights(torch.from_numpy(data),
                                   torch.from_numpy(w), te.B), om)


# ------------------------------------------------------------ GW snapshots --
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_taylorf2_and_snapshots_match_jax(dtype):
    """The phase is float64 in both (x64 reference), so the columns agree
    to the output precision; unit-normalized columns have O(1/sqrt(N))
    entries, compared within dtype_tol."""
    N = 256
    f = frequency_grid(20.0, 512.0, N)
    m1, m2 = chirp_grid(n_mc=7, n_eta=3)
    tdt = torch.complex64 if dtype == np.complex64 else torch.complex128
    got = build_snapshot_matrix(f, m1, m2, dtype=tdt, chunk=8, device="cpu")
    want = np.asarray(jax_snapshots(f, m1, m2, dtype=dtype))
    assert got.shape == want.shape and got.is_contiguous()
    tol = dtype_tol(dtype, N)
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)
    h = taylorf2(torch.from_numpy(f), 12.0, 9.0, dtype=tdt)
    hj = np.asarray(jax_taylorf2(jnp.asarray(f), 12.0, 9.0, dtype=dtype))
    np.testing.assert_allclose(_np(h), hj, atol=tol, rtol=0)


# ------------------------------------------------------------------- rules --
def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference():
    """No module of the port, nor chip_smoke.py, imports JAX or anything of
    the reference package (repro_torch only)."""
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro") or name.startswith(
                        "jax"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert len(_port_files()) > 20
    assert not bad, bad


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")


def test_entry_points_refuse_cpu_without_being_asked(no_cuda, tmp_path):
    """With no CUDA device an entry point not asked for the CPU raises; it
    never carries on on the CPU."""
    from repro_torch.core.greedy import rb_greedy, rb_greedy_stepwise
    from repro_torch.data.providers import materialize_source

    S = _smooth()
    from repro_torch.core.block_greedy import (
        _rb_greedy_block_impl, rb_greedy_block_stepwise,
    )

    for call in (lambda: tapi.build_basis(source=S, tau=1e-4),
                 lambda: tapi.build_basis(source=S, tau=1e-4,
                                          strategy="block_greedy",
                                          block_p=4),
                 lambda: _rb_greedy_block_impl(S, 1e-4),
                 lambda: rb_greedy_block_stepwise(S, 1e-4),
                 lambda: rb_greedy(S, 1e-4),
                 lambda: rb_greedy_stepwise(S, 1e-4),
                 lambda: materialize_source(S),
                 lambda: build_snapshot_matrix([20.0, 30.0], [9.0], [8.0]),
                 lambda: tapi.ReducedBasis.from_arrays(S, [], [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    b = tapi.build_basis(source=S, tau=1e-4, device="cpu")
    b.save(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.ReducedBasis.load(str(tmp_path))


def test_chip_smoke_fails_without_cuda(no_cuda):
    """chip_smoke.py exits non-zero and prints no result line without a
    card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
