"""Plain versions of the port's kernels vs the JAX reference, the CPU rule
of the wrappers and the kernel build.  The hand-written kernels themselves
are held against these plain versions on the card by test_torch_cuda.py.

Inputs are made with numpy from a seed and handed to both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import dtype_tol

from repro.kernels.block_sweep.ops import block_sweep as pallas_block
from repro.kernels.block_sweep.ref import block_sweep_ref as jax_block
from repro.kernels.greedy_update.ops import greedy_update as pallas_update
from repro.kernels.greedy_update.ref import greedy_update_ref as jax_update
from repro.kernels.imgs_panel.ops import imgs_panel as pallas_panel
from repro.kernels.imgs_panel.ref import imgs_panel_ref as jax_panel
from repro.kernels.imgs_project.ops import imgs_project as pallas_project
from repro.kernels.imgs_project.ref import imgs_project_ref as jax_project
from repro_torch.core import backend
from repro_torch.kernels import _build
from repro_torch.kernels.block_sweep import ops as bs_ops
from repro_torch.kernels.block_sweep.ref import block_sweep_ref
from repro_torch.kernels.greedy_update import ops as gu_ops
from repro_torch.kernels.greedy_update.ref import greedy_update_ref
from repro_torch.kernels.greedy_update_lanes import ops as gl_ops
from repro_torch.kernels.greedy_update_lanes.ref import (
    greedy_update_lanes_ref,
)
from repro_torch.kernels.imgs_panel import ops as pp_ops
from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref
from repro_torch.kernels.imgs_project import ops as ip_ops
from repro_torch.kernels.imgs_project.ref import imgs_project_ref
from repro_torch.kernels.roq_apply import ops as ra_ops
from repro_torch.kernels.taylorf2 import ops as tf_ops
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOW = [np.float32, np.complex64]
HIGH = [np.float64, np.complex128]
UPDATE_SHAPES = [(64, 96), (300, 700), (1024, 256), (17, 33)]
PROJECT_SHAPES = [(128, 16), (513, 37), (1000, 100), (17, 33)]
# (N, M, p) of the blocked sweep and (N, K, p) of the panel pass: ragged
# edges, p below, at and above the kernels' widest panel of 32
BLOCK_SHAPES = [(64, 96, 1), (300, 700, 3), (257, 130, 8), (40, 50, 33)]
PANEL_SHAPES = [(128, 16, 1), (513, 37, 3), (1000, 108, 8), (70, 20, 33)]


def _mk(rng, shape, dtype):
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _update_inputs(rng, shape, dtype):
    N, M = shape
    rdt = np.finfo(dtype).dtype
    S = _mk(rng, (N, M), dtype)
    q = _mk(rng, (N,), dtype)
    q = (q / np.linalg.norm(q)).astype(dtype)
    acc = np.abs(rng.standard_normal(M)).astype(rdt)
    norms = np.sum(np.abs(S) ** 2, axis=0).astype(rdt)
    return q, S, acc, norms


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _check_update(got, want, dtype, N):
    """c within dtype_tol of |c|'s scale (N-term sums: eps*sqrt(N) growth);
    acc within the same relative tolerance of |c|^2; max_res alike; the
    argmax exact (the random residuals have no near-ties)."""
    c, a, mx, am = (np.asarray(x) for x in got)
    cr, ar, mxr, amr = (np.asarray(x) for x in want)
    tol = dtype_tol(dtype, N)
    scale = float(np.abs(cr).max())
    np.testing.assert_allclose(c, cr, rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(a, ar, rtol=tol, atol=tol * scale ** 2)
    assert abs(float(mx) - float(mxr)) <= tol * (abs(float(mxr)) + scale ** 2)
    assert int(am) == int(amr)


# ------------------------------------------------------------- greedy_update
@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("shape", UPDATE_SHAPES)
def test_greedy_update_ref_matches_jax_and_pallas(rng, dtype, shape):
    """f32/c64: against the JAX oracle and the Pallas kernel (interpret
    mode; it accumulates in f32 like the port)."""
    q, S, acc, norms = _update_inputs(rng, shape, dtype)
    got = greedy_update_ref(*_torch(q, S, acc, norms))
    jargs = [jnp.asarray(x) for x in (q, S, acc, norms)]
    _check_update(got, jax_update(*jargs), dtype, shape[0])
    _check_update(got, pallas_update(*jargs, interpret=True), dtype,
                  shape[0])


@pytest.mark.parametrize("dtype", HIGH)
@pytest.mark.parametrize("shape", UPDATE_SHAPES)
def test_greedy_update_ref_matches_jax_f64(rng, dtype, shape):
    """f64/c128: against the JAX oracle (xla_ref) only — the Pallas kernel
    sums these in f32."""
    q, S, acc, norms = _update_inputs(rng, shape, dtype)
    got = greedy_update_ref(*_torch(q, S, acc, norms))
    _check_update(got, jax_update(*(jnp.asarray(x)
                                    for x in (q, S, acc, norms))),
                  dtype, shape[0])


def test_greedy_update_first_index_on_ties():
    """Equal residuals: the first index wins, as jnp.argmax picks it."""
    S = np.zeros((4, 6), np.float32)
    q = np.array([1, 0, 0, 0], np.float32)
    norms = np.array([0, 3, 1, 3, 3, 0], np.float32)
    acc = np.zeros(6, np.float32)
    _, _, mx, am = greedy_update_ref(*_torch(q, S, acc, norms))
    assert float(mx) == 3.0 and int(am) == 1
    assert int(jax_update(*(jnp.asarray(x) for x in (q, S, acc, norms)))[3]) \
        == 1


# -------------------------------------------------------------- imgs_project
def _project_inputs(rng, shape, dtype):
    N, K = shape
    Q, _ = np.linalg.qr(_mk(rng, (N, K), dtype))
    return _mk(rng, (N,), dtype), np.ascontiguousarray(Q.astype(dtype))


def _check_project(got, want, dtype, N):
    """v' and c within dtype_tol (unit-norm Q columns, O(1) entries)."""
    tol = dtype_tol(dtype, N)
    for x, y in zip(got, want):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("shape", PROJECT_SHAPES)
def test_imgs_project_ref_matches_jax_and_pallas(rng, dtype, shape):
    v, Q = _project_inputs(rng, shape, dtype)
    got = imgs_project_ref(*_torch(v, Q))
    jargs = (jnp.asarray(v), jnp.asarray(Q))
    _check_project(got, jax_project(*jargs), dtype, shape[0])
    _check_project(got, pallas_project(*jargs, interpret=True), dtype,
                   shape[0])


@pytest.mark.parametrize("dtype", HIGH)
@pytest.mark.parametrize("shape", PROJECT_SHAPES)
def test_imgs_project_ref_matches_jax_f64(rng, dtype, shape):
    v, Q = _project_inputs(rng, shape, dtype)
    _check_project(imgs_project_ref(*_torch(v, Q)),
                   jax_project(jnp.asarray(v), jnp.asarray(Q)), dtype,
                   shape[0])


# --------------------------------------------------------------- block_sweep
def _block_inputs(rng, shape, dtype):
    N, M, p = shape
    S = _mk(rng, (N, M), dtype)
    Qnew = np.linalg.qr(_mk(rng, (N, p), dtype))[0].astype(dtype)
    Qnew[:, p // 2] = 0  # a rejected candidate: an exact no-op
    acc = np.abs(rng.standard_normal(M)).astype(np.finfo(dtype).dtype)
    return np.ascontiguousarray(Qnew), S, acc


def _check_block(got, want, dtype, N):
    """C within dtype_tol of its scale (N-term sums), acc_out within the
    same relative tolerance of |C|^2; the zero column's row of C is
    exactly zero."""
    C, a = (np.asarray(x) for x in got)
    Cr, ar = (np.asarray(x) for x in want)
    tol = dtype_tol(dtype, N)
    scale = float(np.abs(Cr).max())
    np.testing.assert_allclose(C, Cr, rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(a, ar, rtol=tol, atol=tol * scale ** 2)
    assert np.all(C[C.shape[0] // 2] == 0)


@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_block_sweep_ref_matches_jax_and_pallas(rng, dtype, shape):
    """f32/c64: against the JAX oracle and the Pallas kernel (interpret
    mode; it accumulates in f32 like the port)."""
    args = _block_inputs(rng, shape, dtype)
    got = block_sweep_ref(*_torch(*args))
    jargs = [jnp.asarray(x) for x in args]
    _check_block(got, jax_block(*jargs), dtype, shape[0])
    _check_block(got, pallas_block(*jargs, interpret=True), dtype, shape[0])


@pytest.mark.parametrize("dtype", HIGH)
@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_block_sweep_ref_matches_jax_f64(rng, dtype, shape):
    """f64/c128: against the JAX oracle only — the Pallas kernel sums
    these in f32."""
    args = _block_inputs(rng, shape, dtype)
    _check_block(block_sweep_ref(*_torch(*args)),
                 jax_block(*(jnp.asarray(x) for x in args)), dtype, shape[0])


# ---------------------------------------------------------------- imgs_panel
def _panel_inputs(rng, shape, dtype):
    N, K, p = shape
    Q = np.linalg.qr(_mk(rng, (N, K), dtype))[0].astype(dtype)
    Q[:, K // 2] = 0  # an empty slot of the basis: an exact no-op
    return _mk(rng, (N, p), dtype), np.ascontiguousarray(Q)


@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("shape", PANEL_SHAPES)
def test_imgs_panel_ref_matches_jax_and_pallas(rng, dtype, shape):
    V, Q = _panel_inputs(rng, shape, dtype)
    got = imgs_panel_ref(*_torch(V, Q))
    jargs = (jnp.asarray(V), jnp.asarray(Q))
    _check_project(got, jax_panel(*jargs), dtype, shape[0])
    _check_project(got, pallas_panel(*jargs, interpret=True), dtype,
                   shape[0])


@pytest.mark.parametrize("dtype", HIGH)
@pytest.mark.parametrize("shape", PANEL_SHAPES)
def test_imgs_panel_ref_matches_jax_f64(rng, dtype, shape):
    V, Q = _panel_inputs(rng, shape, dtype)
    _check_project(imgs_panel_ref(*_torch(V, Q)),
                   jax_panel(jnp.asarray(V), jnp.asarray(Q)), dtype,
                   shape[0])


# ------------------------------------------------ wrappers and dispatch ----
def test_wrappers_take_plain_version_on_cpu(rng):
    """On CPU tensors the wrappers are the plain versions, bit for bit,
    and launch nothing."""
    n0, p0 = gu_ops.launches, ip_ops.launches
    q, S, acc, norms = _torch(*_update_inputs(rng, (40, 50), np.complex64))
    for x, y in zip(gu_ops.greedy_update(q, S, acc, norms),
                    greedy_update_ref(q, S, acc, norms)):
        assert torch.equal(x, y)
    v, Q = _torch(*_project_inputs(rng, (40, 7), np.complex64))
    for x, y in zip(ip_ops.imgs_project(v, Q), imgs_project_ref(v, Q)):
        assert torch.equal(x, y)
    assert (gu_ops.launches, ip_ops.launches) == (n0, p0)


def test_blocked_wrappers_take_plain_version_on_cpu(rng):
    """The blocked path's wrappers and backend slots, on CPU tensors, are
    the plain versions bit for bit, and launch nothing."""
    n0, p0 = bs_ops.launches, pp_ops.launches
    Qnew, S, acc = _torch(*_block_inputs(rng, (40, 50, 3), np.complex64))
    want = block_sweep_ref(Qnew, S, acc)
    for got in (bs_ops.block_sweep(Qnew, S, acc),
                backend.block_sweep(Qnew, S, acc),
                backend.block_sweep(Qnew, S, acc, backend="ref")):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    V, Q = _torch(*_panel_inputs(rng, (40, 7, 3), np.complex64))
    want = imgs_panel_ref(V, Q)
    for got in (pp_ops.imgs_panel(V, Q), backend.panel_project(V, Q),
                backend.panel_project(V, Q, backend="ref")):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (bs_ops.launches, pp_ops.launches) == (n0, p0)


def test_resolve_backend(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_GREEDY_BACKEND", raising=False)
    assert backend.resolve_backend() == "auto"
    assert backend.resolve_backend("ref") == "ref"
    monkeypatch.setenv("REPRO_TORCH_GREEDY_BACKEND", "ref")
    assert backend.resolve_backend() == "ref"
    assert backend.resolve_backend("auto") == "auto"  # explicit wins
    with pytest.raises(ValueError, match="unknown greedy backend"):
        backend.resolve_backend("pallas")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing toolchain is an error, not a quiet fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_library_name_tracks_sources():
    """The built library's name carries a hash of csrc/, so an edited
    source is never served by a stale library."""
    p = _build.library_path("greedy_update")
    assert p.parent == _build.BUILD_DIR
    assert p.name.startswith("libgreedy_update-") and p.suffix == ".so"
    assert {s + ".cu" for s in _build.SOURCES} <= set(
        os.listdir(_build.CSRC))


# ------------------------------------------------------- kernel routes ----
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64, torch.complex128])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 33, 700, 4099, 131072])
@pytest.mark.parametrize("aligned", [True, False])
def test_greedy_update_kernel_route_rule(dtype, M, aligned):
    """The sm90 kernel takes S whose rows are a multiple of 16 bytes, with S
    and q on 16-byte boundaries (what TMA needs); the general one the
    rest: odd M in complex64 / float64, M % 4 != 0 in float32."""
    want = ("sm90" if aligned and M * dtype.itemsize % 16 == 0
            else "general")
    assert gu_ops.kernel_route(dtype, M, aligned) == want


def test_greedy_update_routes_of_the_paths():
    """The GW path's M = 131072 in complex64 takes the sm90 kernel; the
    card test's odd M = 4099 the general one (but in complex128)."""
    assert gu_ops.kernel_route(torch.complex64, 131072, True) == "sm90"
    assert gu_ops.kernel_route(torch.float32, 131072, True) == "sm90"
    assert gu_ops.kernel_route(torch.complex64, 4099, True) == "general"
    assert gu_ops.kernel_route(torch.complex128, 4099, True) == "sm90"


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64, torch.complex128])
@pytest.mark.parametrize("K", [1, 9, 108, 500, 1500, 4000])
@pytest.mark.parametrize("p", [1, 8, 33])
def test_imgs_panel_kernel_route_rule(dtype, K, p):
    """The sm90 kernel takes every K whose slab of 8 rows fits in its
    shared memory, with the projection's and the update's footprints;
    slab_rows never leaves that room, and gives one slab per SM."""
    itemsize = dtype.itemsize
    Kp, P = K | 1, min(p + p % 2, pp_ops.PMAX)

    def fits(T):
        return max(T * (Kp + P), T * Kp + K * P) * itemsize \
            <= pp_ops.SMEM_BUDGET

    want = "sm90" if fits(8) else "general"
    assert pp_ops.kernel_route(dtype, K, p) == want
    if want == "sm90":
        T = pp_ops.slab_rows(10_000, K, p, itemsize, 132)
        assert 8 <= T <= pp_ops.SLAB_ROWS and fits(T)
        assert T == min(76, pp_ops.fit_rows(K, p, itemsize))


def test_imgs_panel_slabs_of_the_blocked_path():
    """At the blocked path's (10000, 108, 8) complex64, 132 slabs of 76
    rows on 132 SMs: at least one CTA per SM."""
    T = pp_ops.slab_rows(10_000, 108, 8, 8, 132)
    assert T == 76 and -(-10_000 // T) == 132
    assert pp_ops.kernel_route(torch.complex64, 108, 8) == "sm90"
    assert pp_ops.slab_rows(100, 108, 8, 8, 132) == 8


def _exported(name: str) -> set:
    """The C entries ``csrc/<name>.cu`` exports: each ``extern "C"``
    function and each name handed to an ``*_ENTRY`` macro."""
    import re
    src = (_build.CSRC / f"{name}.cu").read_text()
    return (set(re.findall(r'extern "C"[^(;]*?\b(\w+)\s*\(', src))
            | set(re.findall(r"^\w+_ENTRY\((\w+),", src, re.M)))


@pytest.mark.parametrize("module", ["greedy_update", "greedy_update_lanes",
                                    "imgs_panel",
                                    "imgs_project", "block_sweep",
                                    "flash_attention", "roq_apply",
                                    "taylorf2", "column_norms",
                                    "llc_probe"])
def test_bound_entries_are_exported(module):
    """Every C entry a wrapper binds through ctypes is exported by the
    source it loads: a renamed entry fails here, not at first use on the
    card."""
    import importlib
    ops = importlib.import_module(f"repro_torch.kernels.{module}.ops")
    libs = getattr(ops, "_LIBS", None) or {
        "": (module, ops._SIGNATURES)}
    assert libs
    for lib_name, signatures in libs.values():
        assert lib_name in _build.SOURCES
        missing = set(signatures) - _exported(lib_name)
        assert not missing, (lib_name, missing)


def test_general_entries_take_plain_version_on_cpu(rng):
    """The general-route entries, on CPU tensors, are the plain versions
    bit for bit too, and launch nothing."""
    counts = (gu_ops.launches, pp_ops.launches)
    q, S, acc, norms = _torch(*_update_inputs(rng, (40, 50), np.complex64))
    for x, y in zip(gu_ops._greedy_update_general(q, S, acc, norms),
                    greedy_update_ref(q, S, acc, norms)):
        assert torch.equal(x, y)
    V, Q = _torch(*_panel_inputs(rng, (40, 7, 3), np.complex64))
    for x, y in zip(pp_ops._imgs_panel_general(V, Q), imgs_panel_ref(V, Q)):
        assert torch.equal(x, y)
    assert (gu_ops.launches, pp_ops.launches) == counts


# ------------------------------------------------------ the active flag ----
DTYPES = [np.float32, np.complex64, np.float64, np.complex128]


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_update_ref_flag(rng, dtype):
    """A false flag gives what q = 0 gives (c = 0, acc_out = acc, the
    first-index argmax of norms - acc), bit for bit; a true flag gives the
    call without one, bit for bit."""
    q, S, acc, norms = _torch(*_update_inputs(rng, (40, 50), dtype))
    acc[3] = acc[7] = 0.5  # a tie of the largest residual: 3 wins
    norms[3] = norms[7] = (norms - acc).max() + 1.5
    off = greedy_update_ref(q, S, acc, norms, torch.tensor(False))
    zero = greedy_update_ref(torch.zeros_like(q), S, acc, norms)
    assert all(torch.equal(x, y) for x, y in zip(off, zero))
    assert torch.equal(off[0], torch.zeros_like(off[0]))
    assert torch.equal(off[1], acc) and int(off[3]) == 3
    on = greedy_update_ref(q, S, acc, norms, torch.tensor(True))
    assert all(torch.equal(x, y) for x, y in
               zip(on, greedy_update_ref(q, S, acc, norms)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_imgs_project_ref_flag(rng, dtype):
    """A false flag gives what Q = 0 gives, ``(v, 0)``, bit for bit, even
    with Q full of NaN; a true flag gives the call without one."""
    v, Q = _torch(*_project_inputs(rng, (40, 7), dtype))
    vo, c = imgs_project_ref(v, Q, torch.tensor(False))
    vz, cz = imgs_project_ref(v, torch.zeros_like(Q))
    assert torch.equal(vo, vz) and torch.equal(c, cz)
    assert torch.equal(vo, v) and torch.equal(c, torch.zeros_like(c))
    vn, cn = imgs_project_ref(v, torch.full_like(Q, float("nan")),
                              torch.tensor(False))
    assert torch.equal(vn, v) and torch.equal(cn, torch.zeros_like(c))
    on = imgs_project_ref(v, Q, torch.tensor(True))
    assert all(torch.equal(x, y) for x, y in
               zip(on, imgs_project_ref(v, Q)))


def test_flag_passes_through_wrappers_and_backend(rng):
    """On CPU tensors the wrappers and the backend's slots hand the flag to
    the plain versions (both routes' entries), and launch nothing."""
    counts = (gu_ops.launches, ip_ops.launches)
    off = torch.tensor(False)
    q, S, acc, norms = _torch(*_update_inputs(rng, (40, 50), np.complex64))
    want = greedy_update_ref(q, S, acc, norms, off)
    for got in (gu_ops.greedy_update(q, S, acc, norms, off),
                gu_ops._greedy_update_general(q, S, acc, norms, off),
                backend.pivot_update(q, S, acc, norms, active=off),
                backend.pivot_update(q, S, acc, norms, backend="ref",
                                     active=off)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    v, Q = _torch(*_project_inputs(rng, (40, 7), np.complex64))
    want = imgs_project_ref(v, Q, off)
    for got in (ip_ops.imgs_project(v, Q, off),
                ip_ops._imgs_project_general(v, Q, off),
                backend.project_pass(v, Q, active=off),
                backend.project_pass(v, Q, backend="ref", active=off)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (gu_ops.launches, ip_ops.launches) == counts


def test_imgs_project_general_takes_plain_version_on_cpu(rng):
    """The general-route entry, on CPU tensors, is the plain version bit
    for bit, and launches nothing."""
    counts = (ip_ops.launches, ip_ops.launches_sm90,
              ip_ops.launches_general)
    v, Q = _torch(*_project_inputs(rng, (40, 7), np.complex128))
    for x, y in zip(ip_ops._imgs_project_general(v, Q),
                    imgs_project_ref(v, Q)):
        assert torch.equal(x, y)
    assert (ip_ops.launches, ip_ops.launches_sm90,
            ip_ops.launches_general) == counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64, torch.complex128])
@pytest.mark.parametrize("K", [1, 8, 100, 500, 1500, 4000])
def test_imgs_project_kernel_route_rule(dtype, K):
    """The sm90 kernel takes every K whose slab of 8 rows fits in its
    shared memory; its plan never leaves that room, gives each SM one CTA
    and leaves no CTA empty."""
    itemsize = dtype.itemsize
    fits = ip_ops.smem_bytes(K, 8, itemsize) <= ip_ops.SMEM_BUDGET
    assert ip_ops.kernel_route(dtype, K) == ("sm90" if fits else "general")
    T = ip_ops.fit_rows(K, itemsize)
    assert ip_ops.smem_bytes(K, T, itemsize) <= ip_ops.SMEM_BUDGET
    assert ip_ops.smem_bytes(K, T + 1, itemsize) > ip_ops.SMEM_BUDGET - 32
    if fits:
        for N in (1, 33, 10_000, 40_001):
            rows, ctas, t = ip_ops.plan(N, K, itemsize, 132)
            assert ctas <= 132 and (ctas - 1) * rows < N <= ctas * rows
            assert 1 <= t <= min(rows, T)


def test_imgs_project_plan_of_the_greedy_path():
    """At the greedy path's (10000, 100) complex64: 132 CTAs of 76 rows on
    132 SMs, each slab resident in one chunk (60.8 KB of Q)."""
    assert ip_ops.kernel_route(torch.complex64, 100) == "sm90"
    assert ip_ops.plan(10_000, 100, 8, 132) == (76, 132, 76)
    assert ip_ops.smem_bytes(100, 76, 8) < 72 * 1024
    # N past what 132 slabs hold: two chunks a CTA
    rows, ctas, T = ip_ops.plan(40_001, 100, 8, 132)
    assert ctas == 132 and T < rows <= 2 * T


# ------------------------------- roq_apply and taylorf2_tile routes ----
def _roq_tiles() -> set:
    """The (rr, cc) register tiles csrc/roq_apply_sm90.cu is built for."""
    import re
    src = (_build.CSRC / "roq_apply_sm90.cu").read_text()
    return {(int(a), int(b))
            for a, b in re.findall(r"^  ROQ_TILE\((\d+), (\d+)\)$", src, re.M)}


ROQ_TILES = _roq_tiles()


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64, torch.complex128])
@pytest.mark.parametrize("k", [1, 8, 83, 500, 908, 4000])
@pytest.mark.parametrize("nb", [1, 2, 7, 62, 64, 128])
def test_roq_apply_kernel_route_rule(dtype, k, nb):
    """The sm90 kernel takes every (k, nb) whose F and one row of B fit in
    its shared memory, whatever N; its plan stays within that room and
    MAX_THREADS, its register tile is one the kernel is built for, and its
    tiles cover every column of out.  k 908 puts nb 62 a row or two from
    the room's edge."""
    isz = dtype.itemsize
    fits = ra_ops.smem_bytes(k, nb, 1, isz) <= ra_ops.SMEM_BUDGET
    assert ra_ops.kernel_route(dtype, k, nb) == ("sm90" if fits
                                                 else "general")
    for N in (1, 17, 10_000, 100_001):
        p = ra_ops.plan(N, k, nb, isz, 132)
        assert (p is not None) == fits
        if p is None:
            continue
        rr, cc, tx, ty = p
        assert (rr, cc) in ROQ_TILES
        assert tx * cc >= nb > (tx - 1) * cc
        assert 1 <= tx * ty <= ra_ops.MAX_THREADS
        assert ra_ops.smem_bytes(k, nb, rr * ty, isz) <= ra_ops.SMEM_BUDGET


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64, torch.complex128])
def test_roq_apply_plans_near_the_room_edge(dtype):
    """With k such that F overflows shared memory near width 64 (the card
    test's route switch), every width the sm90 kernel takes gets a tile it
    is built for, within the room, however few rows of B still fit."""
    isz = dtype.itemsize
    k = -(-ra_ops.SMEM_BUDGET // (64 * isz))
    widths = [nb for nb in range(1, 129)
              if ra_ops.kernel_route(dtype, k, nb) == "sm90"]
    assert widths == list(range(1, widths[-1] + 1)) and widths[-1] < 128
    for nb in widths:
        rr, cc, tx, ty = ra_ops.plan(301, k, nb, isz, 132)
        assert (rr, cc) in ROQ_TILES, (nb, rr, cc)
        assert ra_ops.smem_bytes(k, nb, rr * ty, isz) <= ra_ops.SMEM_BUDGET


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_roq_apply_plan_of_the_serving_path(dtype):
    """At the GW basis (N 10,000, k 83) every bucket spreads over the 132
    SMs, one CTA of 76 rows each up to bucket 16, at most two a SM above;
    F overflows shared
    memory only past width 174 in complex128 and 349 in complex64."""
    for nb in (1, 2, 4, 8, 16, 32, 64, 128):
        assert ra_ops.kernel_route(dtype, 83, nb) == "sm90"
        rr, cc, tx, ty = ra_ops.plan(10_000, 83, nb, dtype.itemsize, 132)
        ctas = -(-10_000 // (rr * ty))
        assert 132 <= ctas <= 2 * 132
        if nb <= 16:
            assert rr * ty == 76 and ctas == 132
    limit = {torch.complex64: 349, torch.complex128: 174}[dtype]
    assert ra_ops.kernel_route(dtype, 83, limit) == "sm90"
    assert ra_ops.kernel_route(dtype, 83, limit + 1) == "general"


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("N", [1, 17, 1000, 10_000, 14_000, 20_000, 40_000,
                               100_000])
def test_taylorf2_kernel_route_rule(dtype, N):
    """The generator's route and plan are functions of (N, dtype) alone:
    the sm90 kernel wherever its slab of ceil(N / G) rows x C columns fits
    in a CTA's shared memory, the general one elsewhere; the plan's CTAs
    cover N and its columns divide a CTA's threads."""
    import inspect

    for fn in (tf_ops.kernel_route, tf_ops.plan):
        assert list(inspect.signature(fn).parameters) == ["N", "dtype"]
    fits = tf_ops.smem_bytes(N, dtype) <= tf_ops.SMEM_BUDGET
    assert tf_ops.kernel_route(N, dtype) == ("sm90" if fits else "general")
    p = tf_ops.plan(N, dtype)
    assert (p is not None) == fits
    if p is not None:
        G, rows_cta = p
        assert G == tf_ops.CLUSTER == 8
        assert (rows_cta - 1) * G < max(N, 1) <= rows_cta * G
        for normalize in (True, False):
            C, unroll = tf_ops.LAUNCH[dtype, normalize]
            assert C <= 32 and tf_ops.THREADS % C == 0 and unroll in (1, 2)


def test_taylorf2_routes_of_the_gw_paths():
    """The paper's N = 10,000 takes the sm90 generator in both output
    types; a much longer frequency grid overflows its slab."""
    for dtype in (torch.complex64, torch.complex128):
        assert tf_ops.kernel_route(10_000, dtype) == "sm90"
        assert tf_ops.kernel_route(1_000_000, dtype) == "general"


def test_new_routes_take_plain_version_on_cpu(rng):
    """On CPU tensors both entries of roq_apply and of taylorf2_tile are
    the plain versions bit for bit, and launch nothing."""
    from repro_torch.gw import WaveformGrid, chirp_grid, frequency_grid
    from repro_torch.gw.waveform import taylorf2_from_terms
    from repro_torch.kernels.roq_apply.ref import roq_apply_ref

    counts = (ra_ops.launches, ra_ops.launches_sm90,
              ra_ops.launches_general, tf_ops.launches,
              tf_ops.launches_sm90, tf_ops.launches_general)
    for dtype in (np.float32, np.complex64, np.float64, np.complex128):
        B, F = _torch(_mk(rng, (30, 7), dtype), _mk(rng, (7, 5), dtype))
        for fn in (ra_ops.roq_apply, ra_ops._roq_apply_general):
            assert torch.equal(fn(B, F), roq_apply_ref(B, F))
            assert torch.equal(fn(B, F), B @ F)
    g = WaveformGrid(frequency_grid(40.0, 1024.0, 50),
                     *chirp_grid(n_mc=4, n_eta=3), device="cpu")
    for normalize in (True, False):
        for dtype in (torch.complex64, torch.complex128):
            want = taylorf2_from_terms(g.rows, g.cols[:, 2:9], normalize,
                                       dtype)
            for fn in (tf_ops.taylorf2_tile, tf_ops._taylorf2_tile_general):
                assert torch.equal(
                    fn(g.rows, g.cols, 2, 9, normalize, dtype), want)
    assert (ra_ops.launches, ra_ops.launches_sm90,
            ra_ops.launches_general, tf_ops.launches,
            tf_ops.launches_sm90, tf_ops.launches_general) == counts


# ------------------------------------------------------- column norms ----
def _kernel_order_norms(X: torch.Tensor) -> torch.Tensor:
    """The order in which csrc/column_norms.cu sums, on the CPU: for each
    launch of ``plan``, every row of level L as a full binary tree of 2^L
    leaves (a missing child below a carried row summed as +0), then the
    remaining levels folded as the kernel folds them in shared memory."""
    from repro_torch.kernels.column_norms import ops as cn_ops

    vals, square = X, True
    for level, final, rows in cn_ops.plan(X.shape[0]):
        h, n = [], rows
        for _ in range(level):
            h.append(n >> 1)
            n -= n >> 1

        def node(d, j):
            if d == 0:
                if j < 0:
                    return torch.zeros(X.shape[1], dtype=X.dtype.to_real())
                v = vals[j]
                if not square:
                    return v
                return v.real * v.real + v.imag * v.imag \
                    if v.is_complex() else v * v
            hh = h[d - 1]
            a, b = (-1, -1) if j < 0 else (j, j + hh) if j < hh \
                else (2 * hh, -1)
            return node(d - 1, a) + node(d - 1, b)

        s = torch.stack([node(level, j) for j in range(n)])
        if not final:
            vals, square = s, False
            continue
        while s.shape[0] > 1:
            hh, odd = s.shape[0] >> 1, s.shape[0] & 1
            top = s[:hh] + s[hh:2 * hh]
            s = torch.cat([top, s[2 * hh:2 * hh + 1]]) if odd else top
        return s[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 313, 801, 1601, 10_000, 10_001,
                               30_000])
def test_column_norm_kernel_order_is_the_tree(dtype, n):
    """The kernel's order of operations (emulated on the CPU, launch by
    launch of ``plan``) gives the plain tree's bits: the +0 of a missing
    child never changes a sum, and the partial stages continue the same
    tree."""
    from repro_torch.kernels.column_norms.ref import column_norms_sq_ref

    gen = torch.Generator().manual_seed(n)
    X = torch.randn((n, 3), generator=gen, dtype=torch.float64)
    if dtype.is_complex:
        X = torch.complex(X, torch.randn((n, 3), generator=gen,
                                         dtype=torch.float64))
    X = X.to(dtype)
    assert torch.equal(_kernel_order_norms(X), column_norms_sq_ref(X))


@pytest.mark.parametrize("n", [1, 2, 3, 800, 801, 1600, 1601, 10_000,
                               12_800, 12_801, 25_600, 25_601, 10 ** 6])
def test_column_norm_plan(n):
    """One launch up to CAP * 2^MAX_LEVEL rows, its level the smallest
    whose rows fit in shared memory; taller X first in partial stages of
    level PARTIAL_LEVEL.  The path's N = 10,000 folds level 4 (625 rows,
    80 KB a CTA)."""
    from repro_torch.kernels.column_norms import ops as cn_ops

    stages = cn_ops.plan(n)
    level, final, rows = stages[-1]
    assert final and all(not f for _, f, _ in stages[:-1])
    assert cn_ops.level_rows(rows, level) <= cn_ops.CAP
    assert level == 0 or cn_ops.level_rows(rows, level - 1) > cn_ops.CAP
    assert (len(stages) == 1) == (n <= cn_ops.CAP * 2 ** cn_ops.MAX_LEVEL)
    for (lv, _, r), (_, _, r_next) in zip(stages, stages[1:]):
        assert lv == cn_ops.PARTIAL_LEVEL
        assert r_next == cn_ops.level_rows(r, lv)
    if n == 10_000:
        assert stages == [(4, True, 10_000)]
        assert cn_ops.level_rows(n, 4) * 32 * 4 == 80_000


@pytest.mark.parametrize("dtype", LOW + HIGH)
@pytest.mark.parametrize("shape", [(1, 5), (17, 33), (300, 700),
                                   (1000, 100)])
def test_column_norms_cpu_route_is_the_tree(rng, dtype, shape):
    """On a CPU tensor the wrapper (and sums.column_norms_sq, which every
    caller uses) is the plain tree bit for bit, launches nothing, and is
    the reference's jnp.sum(jnp.abs(S)**2, 0) within dtype_tol; a column
    slice of a wider matrix gives its columns' bits."""
    from repro_torch.kernels.column_norms import ops as cn_ops
    from repro_torch.kernels.column_norms.ref import column_norms_sq_ref
    from repro_torch.sums import column_norms_sq

    S = _mk(rng, shape, dtype)
    X = torch.from_numpy(S)
    n0 = cn_ops.launches
    got = column_norms_sq(X)
    assert cn_ops.launches == n0
    assert torch.equal(got, column_norms_sq_ref(X))
    assert torch.equal(cn_ops.column_norms_sq(X), got)
    want = np.asarray(jnp.sum(jnp.abs(jnp.asarray(S)) ** 2, 0))
    scale = float(np.max(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=dtype_tol(dtype, shape[0]) * scale)
    lo = shape[1] // 3
    assert torch.equal(column_norms_sq(X[:, lo:]), got[lo:])


def test_column_norms_rejects_bad_input():
    from repro_torch.kernels.column_norms import ops as cn_ops

    with pytest.raises(ValueError, match="2-D"):
        cn_ops.column_norms_sq(torch.zeros(4))
    with pytest.raises(ValueError, match="no kernel for dtype"):
        cn_ops.column_norms_sq(torch.zeros((4, 4), dtype=torch.int32))


def test_llc_probe_cpu_route():
    """On a CPU tensor the cache probe is its plain loop of torch.dot:
    reps * (x . x), nothing launched; bad arguments raise."""
    from repro_torch.kernels.llc_probe import ops as lp_ops

    x = torch.arange(8, dtype=torch.float32)
    n0 = lp_ops.launches
    out = lp_ops.llc_probe(x, 3)
    assert lp_ops.launches == n0
    assert out.shape == (1,) and float(out.sum()) == 3 * 140.0
    with pytest.raises(ValueError, match="float32"):
        lp_ops.llc_probe(x.double(), 3)
    with pytest.raises(ValueError, match="reps"):
        lp_ops.llc_probe(x, 0)


# ------------------------------------------------- the B-lane sweep ----
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_update_lanes_ref_is_the_scalar_plain_version(rng, dtype,
                                                            shared):
    """The B-lane plain version is greedy_update_ref lane by lane, bit for
    bit, masked lanes (what q = 0 gives) included; on CPU tensors the
    wrapper and the backend primitive are that plain version and launch
    nothing."""
    B, N, M = 5, 40, 50
    lanes = [_update_inputs(rng, (N, M), dtype) for _ in range(B)]
    q, acc, norms = (torch.from_numpy(np.stack([x[i] for x in lanes]))
                     for i in (0, 2, 3))
    S = torch.from_numpy(lanes[0][1] if shared
                         else np.stack([x[1] for x in lanes]))
    active = torch.tensor([True, False, True, True, False])
    counts = (gl_ops.launches, gu_ops.launches)
    for flag in (None, active):
        got = greedy_update_lanes_ref(q, S, acc, norms, flag)
        for b in range(B):
            one = greedy_update_ref(q[b], S if shared else S[b], acc[b],
                                    norms[b], None if flag is None
                                    else flag[b])
            assert all(torch.equal(x[b], y) for x, y in zip(got, one))
        for other in (gl_ops.greedy_update_lanes(q, S, acc, norms, flag),
                      backend.batched_pivot_update(q, S, acc, norms,
                                                   active=flag)):
            assert all(torch.equal(x, y) for x, y in zip(got, other))
    assert torch.equal(got[0][1], torch.zeros_like(got[0][1]))
    assert torch.equal(got[1][4], acc[4])
    assert (gl_ops.launches, gu_ops.launches) == counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64, torch.complex128])
@pytest.mark.parametrize("M", [1, 3, 4, 33, 131072])
@pytest.mark.parametrize("aligned", [True, False])
def test_greedy_update_lanes_route_rule(dtype, M, aligned):
    """The B-lane kernel takes the scalar sm90 route's shapes (rows of S a
    multiple of 16 bytes, aligned S and q lanes); the rest goes per lane,
    to the scalar wrapper's own rule."""
    want = ("lanes" if aligned and M * dtype.itemsize % 16 == 0
            else "per_lane")
    assert gl_ops.kernel_route(dtype, M, aligned) == want
    assert (want == "lanes") == (
        gu_ops.kernel_route(dtype, M, aligned) == "sm90")


def test_lane_rows_place_each_lane_as_a_fresh_tensor():
    """The lockstep driver's lane stacks: each lane a contiguous tensor
    starting LANE_ALIGN bytes past the previous one at least, so its
    16-byte TMA boxes and the card's reductions see what a fresh tensor
    gives them."""
    for dtype, shape in ((torch.complex64, (17,)), (torch.float32, (3, 5)),
                         (torch.complex128, (1,))):
        x = backend.lane_rows(4, shape, dtype, torch.device("cpu"))
        assert tuple(x.shape) == (4, *shape) and not x.any()
        step = x.stride(0) * x.element_size()
        assert step % backend.LANE_ALIGN == 0 and x.stride(0) >= x[0].numel()
        assert all(x[b].is_contiguous() for b in range(4))
        y = backend.stack_lanes(torch.arange(4 * x[0].numel()).reshape(
            4, *shape).to(dtype))
        assert y.stride() == x.stride()
        assert torch.equal(y, torch.arange(4 * x[0].numel()).reshape(
            4, *shape).to(dtype))
