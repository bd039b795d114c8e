"""The hand-written CUDA kernels vs their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the test conftest, so that it runs on a
machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.block_sweep import ops as bs_ops
from repro_torch.kernels.block_sweep.ref import block_sweep_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.greedy_update import ops as gu_ops
from repro_torch.kernels.greedy_update.ref import greedy_update_ref
from repro_torch.kernels.imgs_panel import ops as pp_ops
from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref
from repro_torch.kernels.imgs_project import ops as ip_ops
from repro_torch.kernels.imgs_project.ref import imgs_project_ref
from repro_torch.kernels.roq_apply import ops as ra_ops
from repro_torch.kernels.roq_apply.ref import roq_apply_ref

DTYPES = [torch.float32, torch.complex64, torch.float64, torch.complex128]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels)")
    return torch.device("cuda")


def _tol(dtype, n):
    """Rounding of an n-term sum in the working precision: the kernel and
    the plain version sum in different orders, each off by ~eps*sqrt(n)
    of the terms' scale; 10x margin."""
    return 10.0 * torch.finfo(dtype.to_real()).eps * n ** 0.5


def _rand(gen, shape, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(shape, generator=gen,
                                         dtype=torch.float64))
    return x.to(dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(17, 33), (300, 700), (1025, 4099)])
def test_greedy_update_kernel_matches_plain(cuda, dtype, shape):
    """c, acc_out and max_res within _tol; the argmax exact: the residuals
    are separated by design (a distinct offset per column, far above the
    tolerance), so no near-tie can make it legitimately differ."""
    gen = torch.Generator().manual_seed(0)
    N, M = shape
    S = _rand(gen, (N, M), dtype, cuda)
    q = _rand(gen, (N,), dtype, cuda)
    q = q / torch.linalg.vector_norm(q)
    rdt = dtype.to_real()
    acc = torch.rand(M, generator=gen, dtype=torch.float64).to(rdt).to(cuda)
    perm = torch.randperm(M, generator=gen).to(cuda)
    norms = (S.abs() ** 2).sum(0) + perm.to(rdt)
    n0 = gu_ops.launches
    c, a, mx, am = gu_ops.greedy_update(q, S, acc, norms)
    torch.cuda.synchronize()
    assert gu_ops.launches == n0 + 1
    cr, ar, mxr, amr = greedy_update_ref(q, S, acc, norms)
    scale = float(torch.linalg.vector_norm(S, dim=0).max())
    tol = _tol(dtype, N) * scale
    assert float((c - cr).abs().max()) <= tol
    assert float((a - ar).abs().max()) <= 2 * float(cr.abs().max()) * tol \
        + 4 * torch.finfo(rdt).eps * float(ar.abs().max())
    assert int(am) == int(amr)
    assert float(norms[am] - a[am]) == float(mx)
    assert abs(float(mx) - float(mxr)) <= 2 * scale * tol \
        + 4 * torch.finfo(rdt).eps * float(norms.abs().max())


def _check_greedy_route(cuda, dtype, shape, general, seed=0):
    """One call on the route kernel_route gives (or, with ``general``, the
    general kernel): one launch on that route; c, acc_out and max_res within
    _tol of the plain version, the argmax exact (residuals separated by a
    distinct offset per column).  Returns the inputs for reuse."""
    gen = torch.Generator().manual_seed(seed)
    N, M = shape
    S = _rand(gen, (N, M), dtype, cuda)
    q = _rand(gen, (N,), dtype, cuda)
    q = q / torch.linalg.vector_norm(q)
    rdt = dtype.to_real()
    acc = torch.rand(M, generator=gen, dtype=torch.float64).to(rdt).to(cuda)
    perm = torch.randperm(M, generator=gen).to(cuda)
    norms = (S.abs() ** 2).sum(0) + perm.to(rdt)
    route = "general" if general else gu_ops.kernel_route(
        dtype, M, S.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    fn = gu_ops._greedy_update_general if general else gu_ops.greedy_update
    n0 = getattr(gu_ops, f"launches_{route}")
    c, a, mx, am = fn(q, S, acc, norms)
    torch.cuda.synchronize()
    assert getattr(gu_ops, f"launches_{route}") == n0 + 1, route
    cr, ar, mxr, amr = greedy_update_ref(q, S, acc, norms)
    scale = float(torch.linalg.vector_norm(S, dim=0).max())
    tol = _tol(dtype, N) * scale
    assert float((c - cr).abs().max()) <= tol
    assert float((a - ar).abs().max()) <= 2 * float(cr.abs().max()) * tol \
        + 4 * torch.finfo(rdt).eps * float(ar.abs().max())
    assert int(am) == int(amr)
    assert float(norms[am] - a[am]) == float(mx)
    return q, S, acc, norms


# (N, M): rows off the sm90 kernel's stages (64 / 32 / 16 rows) and a
# single stage; M off its 128-column tiles, in one tile and in several;
# odd M (the general route in every type but complex128)
GREEDY_ROUTE_SHAPES = [(17, 33), (300, 700), (129, 1000), (1000, 1030),
                       (1025, 4099), (33, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", GREEDY_ROUTE_SHAPES)
def test_greedy_update_routes_match_plain(cuda, dtype, shape, general):
    """Each route, at ragged stages and tiles, against the plain version;
    the call's launch lands on the route kernel_route names."""
    _check_greedy_route(cuda, dtype, shape, general)


@pytest.mark.cuda
@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_greedy_update_wide_matches_plain(cuda, dtype, general):
    """At the GW path's width, M = 131072 (1024 CTAs of the sm90 kernel,
    the last-ticket fold over all of them)."""
    _check_greedy_route(cuda, dtype, (2000, 131072), general)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_update_is_deterministic(cuda, dtype):
    """No floating-point atomics: two launches of each kernel on the same
    inputs give the same bits."""
    args = _check_greedy_route(cuda, dtype, (1000, 8200), False, seed=5)
    for fn in (gu_ops.greedy_update, gu_ops._greedy_update_general):
        a, b = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_greedy_update_unaligned_view_takes_general_route(cuda):
    """Rows of 16-byte multiples (M = 34 in complex64) but a base 8 bytes
    into its storage: TMA cannot take it, the general kernel does."""
    gen = torch.Generator().manual_seed(6)
    buf = _rand(gen, (8 * 34 + 1,), torch.complex64, cuda)
    S = buf[1:].view(8, 34)
    q = _rand(gen, (8,), torch.complex64, cuda)
    acc = torch.zeros(34, device=cuda)
    norms = (S.abs() ** 2).sum(0) + torch.arange(34, device=cuda)
    n0 = gu_ops.launches_general
    c, _, _, am = gu_ops.greedy_update(q, S, acc, norms)
    torch.cuda.synchronize()
    assert gu_ops.launches_general == n0 + 1
    cr, _, _, amr = greedy_update_ref(q, S, acc, norms)
    assert float((c - cr).abs().max()) <= _tol(torch.complex64, 8) * float(
        torch.linalg.vector_norm(S, dim=0).max())
    assert int(am) == int(amr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(17, 33), (513, 37), (1000, 100)])
def test_imgs_project_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator().manual_seed(1)
    N, K = shape
    Q = torch.linalg.qr(_rand(gen, (N, K), dtype, cuda))[0].contiguous()
    v = _rand(gen, (N,), dtype, cuda)
    n0 = ip_ops.launches
    vo, c = ip_ops.imgs_project(v, Q)
    torch.cuda.synchronize()
    assert ip_ops.launches == n0 + 1
    vr, cr = imgs_project_ref(v, Q)
    tol = _tol(dtype, N) * float(torch.linalg.vector_norm(v))
    assert float((c - cr).abs().max()) <= tol
    assert float((vo - vr).abs().max()) <= tol


def _check_project_route(cuda, dtype, shape, general, seed=1, offset=0):
    """One call on the route kernel_route gives (or, with ``general``, the
    general kernel), with a zero column in Q (an empty slot) unless K = 1
    and Q ``offset`` elements into its storage: one launch on that route,
    c and v' within _tol of the plain version.  Returns the inputs."""
    gen = torch.Generator().manual_seed(seed)
    N, K = shape
    buf = torch.empty((N * K + offset,), dtype=dtype, device=cuda)
    Q = buf[offset:].view(N, K)
    Q.copy_(torch.linalg.qr(_rand(gen, (N, K), dtype, cuda))[0])
    if K > 1:
        Q[:, K // 2] = 0
    v = _rand(gen, (N,), dtype, cuda)
    route = "general" if general else ip_ops.kernel_route(dtype, K)
    fn = ip_ops._imgs_project_general if general else ip_ops.imgs_project
    n0 = getattr(ip_ops, f"launches_{route}")
    vo, c = fn(v, Q)
    torch.cuda.synchronize()
    assert getattr(ip_ops, f"launches_{route}") == n0 + 1, route
    vr, cr = imgs_project_ref(v, Q)
    tol = _tol(dtype, N) * float(torch.linalg.vector_norm(v))
    assert float((c - cr).abs().max()) <= tol
    assert float((vo - vr).abs().max()) <= tol
    assert K == 1 or bool((c[K // 2] == 0).all())
    return v, Q


# (N, K): N within one CTA's 8 rows, ragged last slabs (N off a multiple of
# the rows a CTA takes), K 1, 8 and 100 (the greedy path's max_k), odd K
# whose slabs start off 16-byte boundaries, N = 10,000 (132 CTAs of 76
# rows) and N = 40,001 (every SM, rows past what fits: two chunks a CTA)
PROJECT_ROUTE_SHAPES = [(5, 3), (33, 17), (513, 37), (1000, 100), (2113, 1),
                        (3001, 8), (10000, 100), (40001, 100), (20011, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", PROJECT_ROUTE_SHAPES)
def test_imgs_project_routes_match_plain(cuda, dtype, shape, general):
    _check_project_route(cuda, dtype, shape, general)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_imgs_project_unaligned_q(cuda, dtype):
    """Q one element into its storage (4 or 8 bytes off 16 for the
    single-precision and float64 types): the sm90 kernel copies the ragged
    head and tail of each slab in 4-byte words."""
    _check_project_route(cuda, dtype, (1111, 37), False, offset=1)


@pytest.mark.cuda
def test_imgs_project_wide_k_takes_general_route(cuda):
    """A K whose slab of 8 rows does not fit in shared memory takes the
    general kernel."""
    assert ip_ops.kernel_route(torch.complex128, 2000) == "general"
    _check_project_route(cuda, torch.complex128, (2100, 2000), False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_imgs_project_is_deterministic(cuda, dtype):
    """No floating-point atomics: every CTA folds the partials in one fixed
    order, so two launches of each kernel give the same bits."""
    v, Q = _check_project_route(cuda, dtype, (10000, 100), False, seed=7)
    for fn in (ip_ops.imgs_project, ip_ops._imgs_project_general):
        a, b = fn(v, Q), fn(v, Q)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_imgs_project_smem_matches_the_wrapper(cuda):
    """The wrapper sizes its chunks by the kernel's own shared-memory sum."""
    from repro_torch.kernels import _build
    lib = _build.load(*ip_ops._LIBS["sm90"])
    for K, T, itemsize in ((100, 76, 8), (1, 8, 4), (37, 272, 16)):
        assert lib.imgs_project_sm90_smem(K, T, itemsize) == \
            ip_ops.smem_bytes(K, T, itemsize)


@pytest.mark.cuda
@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_false_flag_skips_project_and_sweep_reads(cuda, dtype, general):
    """With a false flag each kernel returns exactly what a zero vector
    gives, with Q and S full of NaN (so it never read them); a true flag is
    bitwise the call without one.  The counters the kernels take are left
    at 0 (the next launch is right)."""
    off = torch.zeros((), dtype=torch.bool, device=cuda)
    on = torch.ones((), dtype=torch.bool, device=cuda)
    # imgs_project: (v, 0)
    v, Q = _check_project_route(cuda, dtype, (10000, 100), general, seed=9)
    fn = ip_ops._imgs_project_general if general else ip_ops.imgs_project
    vo, c = fn(v, torch.full_like(Q, float("nan")), off)
    assert torch.equal(vo, v) and torch.equal(c, torch.zeros_like(c))
    assert all(torch.equal(x, y) for x, y in zip(fn(v, Q, on), fn(v, Q)))
    _check_project_route(cuda, dtype, (10000, 100), general, seed=9)
    # greedy_update: c = 0, acc_out = acc, argmax of norms - acc (a tie of
    # the largest residual at columns 5 and 900: the first wins)
    q, S, acc, norms = _check_greedy_route(cuda, dtype, (300, 1024),
                                           general, seed=9)
    acc[5] = acc[900] = 0.5
    norms[5] = norms[900] = (norms - acc).max() + 1.5
    fn = gu_ops._greedy_update_general if general else gu_ops.greedy_update
    c, a, mx, am = fn(q, torch.full_like(S, float("nan")), acc, norms, off)
    torch.cuda.synchronize()
    assert torch.equal(c, torch.zeros_like(c)) and torch.equal(a, acc)
    assert int(am) == 5 and float(mx) == float((norms - acc).max())
    assert all(torch.equal(x, y) for x, y in
               zip(fn(q, S, acc, norms, on), fn(q, S, acc, norms)))
    _check_greedy_route(cuda, dtype, (300, 1024), general, seed=9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.float64])
def test_greedy_driver_latched_mid_chunk_on_card(cuda, dtype):
    """A stop that latches inside the first chunk: the card's build (its
    masked steps' kernels told so by the flag, every imgs_project launch on
    the sm90 route) equals the CPU build's k, stop and pivots."""
    from repro_torch.core.greedy import STOP_TAU, rb_greedy

    x = np.linspace(0, 1, 150)
    nu = np.linspace(0.5, 2.0, 90)
    S = np.stack([np.sin(2 * np.pi * v * x) * np.exp(-v * x) for v in nu],
                 axis=1)
    if dtype.is_complex:
        S = S * np.exp(1j * np.outer(x, nu))
    S = torch.from_numpy(S).to(dtype)
    tau = 1e-2 * float(torch.linalg.vector_norm(S, dim=0).max())
    n0 = (ip_ops.launches, ip_ops.launches_sm90)
    gpu = rb_greedy(S, tau, max_k=24, chunk=16, device=cuda)
    cpu = rb_greedy(S, tau, max_k=24, chunk=16, device="cpu")
    assert ip_ops.launches - n0[0] == ip_ops.launches_sm90 - n0[1] == 48
    assert gpu.stop == cpu.stop == STOP_TAU and gpu.k == cpu.k < 15
    assert torch.equal(gpu.pivots.cpu(), cpu.pivots)


@pytest.mark.cuda
def test_wrappers_reject_bad_arguments(cuda):
    S = torch.zeros((8, 5), dtype=torch.complex64, device=cuda)
    q = torch.zeros(8, dtype=torch.complex64, device=cuda)
    acc = torch.zeros(5, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        gu_ops.greedy_update(q.to(torch.complex128), S, acc, acc)
    with pytest.raises(ValueError, match="contiguous"):
        ip_ops.imgs_project(q, torch.zeros((5, 8), dtype=S.dtype,
                                           device=cuda).mT)
    with pytest.raises(ValueError, match="no kernel for dtype"):
        gu_ops.greedy_update(q.real.half(), S.real.half(), acc.half(),
                             acc.half())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.float64])
def test_greedy_driver_on_card_matches_cpu(cuda, dtype):
    """The whole driver on the card (through both kernels) picks the CPU
    build's pivots on a smooth family, above the cancellation floor."""
    from repro_torch.core.greedy import rb_greedy

    x = np.linspace(0, 1, 200)
    nu = np.linspace(0.5, 2.0, 120)
    S = np.stack([np.sin(2 * np.pi * v * x) * np.exp(-v * x) for v in nu],
                 axis=1)
    if dtype.is_complex:
        S = S * np.exp(1j * np.outer(x, nu))
    S = torch.from_numpy(S).to(dtype)
    tau = 1e-2 * float(torch.linalg.vector_norm(S, dim=0).max())
    n0, p0 = gu_ops.launches, ip_ops.launches
    gpu = rb_greedy(S, tau, device=cuda)
    cpu = rb_greedy(S, tau, device="cpu")
    assert gu_ops.launches > n0 and ip_ops.launches > p0
    assert gpu.k == cpu.k >= 4 and gpu.stop == cpu.stop
    assert torch.equal(gpu.pivots.cpu(), cpu.pivots)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(17, 33, 1), (300, 700, 3),
                                   (1025, 4099, 8), (129, 257, 33)])
def test_block_sweep_kernel_matches_plain(cuda, dtype, shape):
    """C within _tol of the columns' scale (unit Qnew columns), acc_out
    within the same relative tolerance of |C|^2; a zero column of Qnew
    gives an exactly zero row of C."""
    gen = torch.Generator().manual_seed(2)
    N, M, p = shape
    S = _rand(gen, (N, M), dtype, cuda)
    Qnew = torch.linalg.qr(_rand(gen, (N, p), dtype, cuda))[0].contiguous()
    Qnew[:, p // 2] = 0
    acc = torch.rand(M, generator=gen, dtype=torch.float64).to(
        dtype.to_real()).to(cuda)
    n0 = bs_ops.launches
    C, a = bs_ops.block_sweep(Qnew, S, acc)
    torch.cuda.synchronize()
    assert bs_ops.launches == n0 + 1
    Cr, ar = block_sweep_ref(Qnew, S, acc)
    tol = _tol(dtype, N) * float(torch.linalg.vector_norm(S, dim=0).max())
    assert float((C - Cr).abs().max()) <= tol
    assert float((a - ar).abs().max()) <= 2 * p * float(Cr.abs().max()) \
        * tol + 4 * torch.finfo(dtype.to_real()).eps * float(ar.abs().max())
    assert bool((C[p // 2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(17, 33, 1), (513, 37, 3),
                                   (1000, 108, 8), (300, 40, 33)])
def test_imgs_panel_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator().manual_seed(3)
    N, K, p = shape
    Q = torch.linalg.qr(_rand(gen, (N, K), dtype, cuda))[0].contiguous()
    V = _rand(gen, (N, p), dtype, cuda)
    n0 = pp_ops.launches
    Vo, C = pp_ops.imgs_panel(V, Q)
    torch.cuda.synchronize()
    assert pp_ops.launches == n0 + 1
    Vr, Cr = imgs_panel_ref(V, Q)
    tol = _tol(dtype, N) * float(torch.linalg.vector_norm(V, dim=0).max())
    assert float((C - Cr).abs().max()) <= tol
    assert float((Vo - Vr).abs().max()) <= tol


def _check_panel_route(cuda, dtype, shape, general, seed=3):
    """One call on the route kernel_route gives (or, with ``general``, the
    general kernel), with a zero column in Q (an empty slot): one launch
    on that route, C and V' within _tol of the plain version.  Returns the
    inputs."""
    gen = torch.Generator().manual_seed(seed)
    N, K, p = shape
    Q = torch.linalg.qr(_rand(gen, (N, K), dtype, cuda))[0]
    Q[:, K // 2] = 0
    Q = Q.contiguous()
    V = _rand(gen, (N, p), dtype, cuda)
    route = "general" if general else pp_ops.kernel_route(dtype, K, p)
    fn = pp_ops._imgs_panel_general if general else pp_ops.imgs_panel
    n0 = getattr(pp_ops, f"launches_{route}")
    Vo, C = fn(V, Q)
    torch.cuda.synchronize()
    assert getattr(pp_ops, f"launches_{route}") == n0 + 1, route
    Vr, Cr = imgs_panel_ref(V, Q)
    tol = _tol(dtype, N) * float(torch.linalg.vector_norm(V, dim=0).max())
    assert float((C - Cr).abs().max()) <= tol
    assert float((Vo - Vr).abs().max()) <= tol
    assert bool((C[K // 2] == 0).all())
    return V, Q


# (N, K, p): N within one slab, ragged last slabs, a ticket tree of one,
# two and three levels (slabs of at most 128 rows, 16 partials per fold);
# odd and even K and p; p 1, 3, 8 and 33 (two column panels); the blocked
# path's (10000, 108, 8)
PANEL_ROUTE_SHAPES = [(17, 33, 1), (513, 37, 3), (1000, 108, 8),
                      (1100, 40, 33), (2113, 20, 7), (10000, 108, 8),
                      (40001, 9, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", PANEL_ROUTE_SHAPES)
def test_imgs_panel_routes_match_plain(cuda, dtype, shape, general):
    _check_panel_route(cuda, dtype, shape, general)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_imgs_panel_is_deterministic(cuda, dtype):
    """No floating-point atomics: the fold's order is fixed, so two launches
    of each kernel on the same inputs give the same bits."""
    V, Q = _check_panel_route(cuda, dtype, (5000, 108, 8), False, seed=7)
    for fn in (pp_ops.imgs_panel, pp_ops._imgs_panel_general):
        a, b = fn(V, Q), fn(V, Q)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_imgs_panel_routes_of_unaligned_and_wide_q(cuda):
    """Q 8 bytes into its storage takes the sm90 kernel (its copies are of
    single elements); a K whose slab of 8 rows does not fit in shared
    memory takes the general one.  Both within _tol of the plain version."""
    gen = torch.Generator().manual_seed(8)
    for N, K, off, dt, want in ((300, 37, 1, torch.complex64, "sm90"),
                                (2100, 2000, 0, torch.complex128, "general")):
        buf = torch.empty((N * K + off,), dtype=dt, device=cuda)
        Q = buf[off:].view(N, K)
        Q.copy_(torch.linalg.qr(_rand(gen, (N, K), dt, cuda))[0])
        V = _rand(gen, (N, 3), dt, cuda)
        assert pp_ops.kernel_route(dt, K, 3) == want
        n0 = getattr(pp_ops, f"launches_{want}")
        Vo, C = pp_ops.imgs_panel(V, Q)
        torch.cuda.synchronize()
        assert getattr(pp_ops, f"launches_{want}") == n0 + 1
        Vr, Cr = imgs_panel_ref(V, Q)
        tol = _tol(dt, N) * float(torch.linalg.vector_norm(V, dim=0).max())
        assert float((C - Cr).abs().max()) <= tol
        assert float((Vo - Vr).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.float64])
def test_block_driver_on_card_matches_cpu(cuda, dtype):
    """The blocked driver on the card (through block_sweep, imgs_panel and
    imgs_project) picks the CPU build's pivots on a rank-40 family with a
    decaying spectrum and generic columns, above the cancellation floor
    (the parity family of test_torch_block_greedy.py)."""
    from repro_torch.core.block_greedy import _rb_greedy_block_impl

    rng = np.random.default_rng(3)
    U = np.linalg.qr(rng.standard_normal((160, 40)))[0]
    V = rng.standard_normal((40, 120))
    if dtype.is_complex:
        U = U * np.exp(1j * rng.uniform(0, 2 * np.pi, (1, 40)))
        V = V + 1j * rng.standard_normal((40, 120))
    S = torch.from_numpy((U * np.logspace(0, -4, 40)) @ V).to(dtype)
    tau = 1e-2 * float(torch.linalg.vector_norm(S, dim=0).max())
    n0 = (bs_ops.launches, pp_ops.launches, ip_ops.launches)
    gpu = _rb_greedy_block_impl(S, tau, p=8, device=cuda)
    cpu = _rb_greedy_block_impl(S, tau, p=8, device="cpu")
    assert bs_ops.launches > n0[0] and pp_ops.launches > n0[1] \
        and ip_ops.launches > n0[2]
    assert gpu.k == cpu.k >= 8 and gpu.stop == cpu.stop
    assert torch.equal(gpu.pivots.cpu(), cpu.pivots)
    assert torch.equal(gpu.n_ortho_passes.cpu(), cpu.n_ortho_passes)


# ----------------------------------------------------------- flash attention
# (B, Hq, Hkv, Sq, Skv, D, causal, window): groups 1, 4 and 8; ragged S; a
# window of 48 against key tiles of 64 (whole rows of a tile masked);
# Sq < Skv end-aligned; non-causal, with Sq > Skv too; D from 16 to 256
# (stablelm's 80 included, and MHA at D 80 over several query and key
# tiles); a single query row.
FA_CASES = [
    (2, 4, 4, 200, 200, 64, True, None),
    (1, 8, 2, 256, 256, 128, True, None),
    (1, 8, 1, 130, 130, 16, True, 48),
    (2, 4, 1, 64, 300, 80, True, 48),
    (1, 4, 4, 300, 300, 80, True, None),
    (1, 4, 2, 150, 200, 96, False, None),
    (1, 4, 2, 100, 100, 256, False, None),
    (1, 2, 2, 80, 48, 32, False, None),
    (1, 4, 4, 1, 77, 64, True, None),
]
FA_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


# q and k scales: 0.3 gives logits of std 0.09 (a near-uniform softmax);
# 2.0 gives logits of std 4, peaked, so that a row's running max moves
# across key tiles and the output's rescale by alpha is far from 1.
FA_QK_SCALES = (0.3, 2.0)


def _fa_ref_and_tol(q, k, v, causal, window):
    """The plain version r (f32, from the same rounded inputs) and the
    elementwise tolerance of the kernel's output.

    16-bit: the kernel rounds P to the input type for the second product
    (each p_j off by at most u = eps / 2 of itself, or half the smallest
    subnormal for f16), moving o_i by at most u * attention(q, k, |v|)_i,
    and rounds the output, u |o_i|; its f32 sums differ by ~1e-6
    relative.  The tolerance is twice that bound: eps (|r| +
    attention(q, k, |v|)) plus Skv subnormal steps of max|v|.  f32: both
    sum in f32 in different orders, ~eps * sqrt(D) of the logits' scale
    (~1e-5 relative here); 1e-4 of max|v|."""
    qf, kf, vf = q.float(), k.float(), v.float()
    r = attention_ref(qf, kf, vf, causal=causal, window=window)
    vmax = float(vf.abs().max())
    if q.dtype == torch.float32:
        return r, torch.full_like(r, 1e-4 * vmax)
    a = attention_ref(qf, kf, vf.abs(), causal=causal, window=window)
    fi = torch.finfo(q.dtype)
    return r, fi.eps * (r.abs() + a) + (
        k.shape[2] * fi.smallest_normal * fi.eps * vmax)


def _fa_inputs(gen, case, dtype, device, bshd=False, qk_scale=0.3):
    """q, k, v from a seeded CPU generator; with ``bshd`` as transposed
    views of (B, S, H, D) tensors, the layout the model hands over."""
    B, hq, hkv, sq, skv, D = case[:6]
    out = []
    for h, s, scale in ((hq, sq, qk_scale), (hkv, skv, qk_scale),
                        (hkv, skv, 1.0)):
        x = (torch.randn((B, s, h, D), generator=gen) * scale).to(dtype)
        x = x.to(device)
        out.append(x.transpose(1, 2) if bshd else
                   x.transpose(1, 2).contiguous())
    return out


def _fa_run_cases(cuda, dtype, case, fn, counter):
    """fn on the case with contiguous and with (B, S, H, D) inputs, at both
    q/k scales; each call launches once, on the route ``counter`` names
    (None: the route fa_ops.kernel_route gives the inputs).  The output is
    held elementwise within _fa_ref_and_tol; bf16/f16 also within eps in
    relative L2 (the two roundings are unbiased, ~u / sqrt(3) of |o| each
    in rms, ~0.4 eps together)."""
    causal, window = case[6], case[7]
    gen = torch.Generator().manual_seed(2)
    for bshd in (False, True):
        for qk_scale in FA_QK_SCALES:
            q, k, v = _fa_inputs(gen, case, dtype, cuda, bshd, qk_scale)
            name = counter or "launches_" + fa_ops.kernel_route(
                dtype, case[5], fa_ops.aligned16(q, k, v))
            n0, r0 = fa_ops.launches, getattr(fa_ops, name)
            o = fn(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            assert fa_ops.launches == n0 + 1
            assert getattr(fa_ops, name) == r0 + 1, name
            assert o.dtype == dtype and o.shape == q.shape
            r, tol = _fa_ref_and_tol(q, k, v, causal, window)
            d = o.float() - r
            worst = float((d.abs() / tol).max())
            assert worst <= 1.0, (bshd, qk_scale, worst)
            if dtype != torch.float32:
                rel = float(torch.linalg.vector_norm(d)
                            / torch.linalg.vector_norm(r))
                assert rel <= torch.finfo(dtype).eps, (bshd, qk_scale, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FA_DTYPES)
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, case):
    """The public entry, on the route kernel_route gives: bf16/f16 at D 64,
    128 and 256 on the sm90 kernel, the rest on the general one.  bf16/f16
    are compared in f32 with the plain version computed in f32 from the
    same rounded inputs."""
    _fa_run_cases(cuda, dtype, case, fa_ops.flash_attention, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_general_kernel_matches_plain(cuda, dtype, case):
    """The general kernel's 16-bit (WMMA) branch at every head dim, the
    ones the sm90 kernel now takes included."""
    _fa_run_cases(cuda, dtype, case, fa_ops._flash_attention_general,
                  "launches_general")


# The sm90 kernel's cases: D 64 and 128 (and 256); groups 1, 4 and 8; Sq
# and Skv off the 128-row query and key tiles; Sq < Skv end-aligned; a
# window of 48 inside one key tile; non-causal with Sq > Skv; one query;
# non-causal MHA at D 64 on whole query and key tiles (the encoder's mode,
# every tile unmasked).
SM90_CASES = [
    (2, 4, 4, 200, 200, 64, True, None),
    (1, 8, 2, 333, 333, 128, True, None),
    (1, 8, 1, 300, 300, 128, True, 48),
    (2, 4, 1, 70, 390, 64, True, 48),
    (1, 4, 4, 190, 130, 128, False, None),
    (1, 8, 2, 129, 257, 128, False, 100),
    (1, 4, 2, 150, 200, 256, True, None),
    (1, 4, 4, 1, 77, 64, True, None),
    # recurrentgemma's MQA at D 256, a window inside one key tile and one
    # across several; mixtral's GQA 32/8 at D 128, a window below Sq
    (1, 16, 1, 300, 300, 256, True, 40),
    (2, 16, 1, 530, 530, 256, True, 200),
    (1, 32, 8, 700, 700, 128, True, 256),
    (2, 16, 16, 384, 512, 64, False, None),
    # D 80 and 96 (the D 128 kernel on zero-filled columns): stablelm's MHA
    # causal, windows inside and across key tiles, non-causal with Sq >
    # Skv and with Sq < Skv, GQA 8/2 end-aligned
    (1, 4, 4, 333, 333, 80, True, None),
    (1, 8, 2, 300, 300, 80, True, 48),
    (2, 4, 4, 190, 130, 80, False, None),
    (1, 8, 2, 70, 390, 96, True, 200),
    (1, 4, 4, 129, 257, 96, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", SM90_CASES)
def test_flash_attention_sm90_kernel_matches_plain(cuda, dtype, case):
    """Every case takes the sm90 route and holds to the same tolerance."""
    _fa_run_cases(cuda, dtype, case, fa_ops.flash_attention, "launches_sm90")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [80, 96])
def test_flash_attention_head_dims_80_96_take_sm90(cuda, D):
    """A bf16 call at D 80 / 96 on stablelm's (B, S, H, D) views launches
    the sm90 kernel (never the general one), and its output is the D 128
    call's on the same inputs zero-padded, sliced back, with the true D's
    scale: the same bits."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = _fa_inputs(gen, (2, 8, 8, 260, 260, D), torch.bfloat16, cuda,
                         True, 2.0)
    assert fa_ops.kernel_route(q.dtype, D, fa_ops.aligned16(q, k, v)) \
        == "sm90"
    n0 = (fa_ops.launches_sm90, fa_ops.launches_general)
    o = fa_ops.flash_attention(q, k, v)
    pad = [torch.nn.functional.pad(t, (0, 128 - D)) for t in (q, k, v)]
    o_pad = fa_ops.flash_attention(*pad, sm_scale=1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert (fa_ops.launches_sm90, fa_ops.launches_general) == (n0[0] + 2,
                                                               n0[1])
    assert torch.equal(o, o_pad[..., :D])


@pytest.mark.cuda
@pytest.mark.parametrize("sm_scale", [-0.2, 0.0])
def test_flash_attention_sm90_kernel_sign_of_scale(cuda, sm_scale):
    """The sm90 kernel folds the scale into its exponent with a positive
    factor: a negative scale goes into the product's sign, a zero one gives
    uniform weights over the visible keys, as in the plain version."""
    gen = torch.Generator().manual_seed(4)
    case = (1, 8, 2, 200, 200, 128, True, 48)
    q, k, v = _fa_inputs(gen, case, torch.bfloat16, cuda, True, 2.0)
    n0 = fa_ops.launches_sm90
    o = fa_ops.flash_attention(q, k, v, causal=True, window=48,
                               sm_scale=sm_scale)
    torch.cuda.synchronize()
    assert fa_ops.launches_sm90 == n0 + 1
    qf, kf, vf = q.float(), k.float(), v.float()
    r = attention_ref(qf, kf, vf, causal=True, window=48, sm_scale=sm_scale)
    a = attention_ref(qf, kf, vf.abs(), causal=True, window=48,
                      sm_scale=sm_scale)
    eps = torch.finfo(torch.bfloat16).eps
    assert float(((o.float() - r).abs() / (eps * (r.abs() + a))).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FA_DTYPES)
def test_flash_attention_kernel_is_deterministic(cuda, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = _fa_inputs(gen, (2, 8, 2, 300, 300, 128), dtype, cuda, True)
    for fn in (fa_ops.flash_attention, fa_ops._flash_attention_general):
        a = fn(q, k, v, causal=True, window=100)
        b = fn(q, k, v, causal=True, window=100)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_wrapper_rejects_bad_arguments(cuda):
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="no kernel for dtype"):
        fa_ops.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="unit stride"):
        t = torch.zeros((1, 2, 16, 8), device=cuda).transpose(2, 3)
        fa_ops.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="dtype"):
        fa_ops.flash_attention(q, q.half(), q.half())


# ------------------------------------------------------------ roq_apply --
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(10000, 83, 64), (120, 8, 33),
                                   (81, 6, 1), (7, 1, 5)])
def test_roq_apply_kernel_matches_plain(cuda, dtype, shape):
    """``B @ F`` within _tol of the plain version (a k-term sum); one
    launch a call; the same bits twice."""
    gen = torch.Generator().manual_seed(7)
    N, k, nb = shape
    B = _rand(gen, (N, k), dtype, cuda)
    F = _rand(gen, (k, nb), dtype, cuda)
    n0 = ra_ops.launches
    out = ra_ops.roq_apply(B, F)
    again = ra_ops.roq_apply(B, F)
    torch.cuda.synchronize()
    assert ra_ops.launches == n0 + 2
    assert torch.equal(out, again)
    ref = roq_apply_ref(B, F)
    scale = float(B.abs().max()) * float(F.abs().max()) * k
    assert float((out - ref).abs().max()) <= _tol(dtype, k) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,k", [(10000, 83), (120, 8)])
def test_roq_apply_bucket_contract(cuda, dtype, N, k):
    """The serving contract on the card: a column's bits do not depend on
    the batch width, for every width 1..128 (the buckets 2..128 and every
    unpadded direct width), on either route, and the engine's padded cache
    evaluation is bitwise the direct one."""
    from repro_torch.core.eim import EIMResult
    from repro_torch.serving import InterpolantCache, direct_interpolate

    gen = torch.Generator().manual_seed(8)
    B = _rand(gen, (N, k), dtype, cuda)
    F = _rand(gen, (k, 128), dtype, cuda)
    full = ra_ops.roq_apply(B, F)
    for fn in (ra_ops.roq_apply, ra_ops._roq_apply_general):
        for b in range(1, 129):
            out = fn(B, F[:, :b].contiguous())
            assert torch.equal(out, full[:, :b]), (fn.__name__, b)
    eim = EIMResult(nodes=torch.arange(k, device=cuda), B=B)
    cache = InterpolantCache()
    for width in (1, 2, 3, 7, 31, 64, 100):
        Fw = F[:, :width].contiguous()
        got, _, _ = cache.evaluate("b", eim, Fw)
        assert torch.equal(got, direct_interpolate(eim, Fw))
        assert torch.equal(got, full[:, :width].cpu())


@pytest.mark.cuda
def test_roq_apply_wrapper_rejects_bad_arguments(cuda):
    B = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ra_ops.roq_apply(B, torch.zeros((3, 2), device=cuda,
                                        dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        ra_ops.roq_apply(B, torch.zeros((4, 2), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ra_ops.roq_apply(B, torch.zeros((2, 3), device=cuda).mT)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,k", [(10000, 83), (120, 8)])
def test_roq_apply_sm90_is_bitwise_the_general_kernel(cuda, dtype, N, k):
    """At every width 1..128 the sm90 kernel (panels in shared memory, a
    register tile a thread) gives the general kernel's bits: both sum an
    output over j in order with the same multiply-adds; each call on the
    route it names."""
    gen = torch.Generator().manual_seed(12)
    B = _rand(gen, (N, k), dtype, cuda)
    F = _rand(gen, (k, 128), dtype, cuda)
    for b in range(1, 129):
        Fb = F[:, :b].contiguous()
        assert ra_ops.kernel_route(dtype, k, b) == "sm90"
        n0 = (ra_ops.launches_sm90, ra_ops.launches_general)
        got = ra_ops.roq_apply(B, Fb)
        want = ra_ops._roq_apply_general(B, Fb)
        torch.cuda.synchronize()
        assert (ra_ops.launches_sm90, ra_ops.launches_general) == (
            n0[0] + 1, n0[1] + 1)
        assert torch.equal(got, want), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_roq_apply_contract_across_the_route_switch(cuda, dtype):
    """With k so large that F stops fitting in shared memory inside widths
    1..128, the route switches with the width, and a column keeps its bits
    across the switch; a B off 16-byte alignment (a view one element in:
    f32, c64, f64) gives the same bits on the sm90 kernel."""
    isz = dtype.itemsize
    k = -(-ra_ops.SMEM_BUDGET // (64 * isz))   # F overflows near width 64
    routes = [ra_ops.kernel_route(dtype, k, b) for b in range(1, 129)]
    assert routes[0] == "sm90" and routes[-1] == "general"
    gen = torch.Generator().manual_seed(13)
    Bx = _rand(gen, (301, k), dtype, cuda)
    F = _rand(gen, (k, 128), dtype, cuda)
    full = ra_ops._roq_apply_general(Bx, F)
    for b in range(1, 129):
        assert torch.equal(ra_ops.roq_apply(Bx, F[:, :b].contiguous()),
                           full[:, :b]), b
    B = Bx.view(-1)[1:1 + 300 * k].view(300, k)
    want = ra_ops._roq_apply_general(B, F[:, :3].contiguous())
    assert torch.equal(ra_ops.roq_apply(B, F[:, :3].contiguous()), want)


# --------------------------------------------- the paper's oracles ------
def _low_rank(gen, n, m, r, dtype):
    """A rank-r matrix plus 1e-9 noise on the CPU, made in double."""
    wide = torch.complex128 if dtype.is_complex else torch.float64
    S = _rand(gen, (n, r), wide, "cpu") @ _rand(gen, (r, m), wide, "cpu")
    return (S + 1e-9 * _rand(gen, (n, m), wide, "cpu")).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_pod_and_rrqr_on_cuda_match_cpu(cuda, dtype):
    """POD and the optimal RRQR on the card against the CPU port:
    singular values, k, the projector onto the basis (cuSOLVER and LAPACK
    may pick other phases), the errors of Thm 3.2 / 5.1."""
    from repro_torch.core.pod import pod, pod_error_2norm, pod_error_fro
    from repro_torch.core.rrqr import optimal_rrqr, rrqr_error_2norm

    gen = torch.Generator().manual_seed(9)
    S = _low_rank(gen, 300, 120, 9, dtype)
    s0 = float(torch.linalg.matrix_norm(S, ord=2))
    tau = 1e-3 * s0
    a, b = pod(S, tau, device="cpu"), pod(S, tau, device=cuda)
    assert a.k == b.k == 9
    assert float((a.sigmas - b.sigmas.cpu()).abs().max()) <= 1e-12 * s0
    Pa = a.basis[:, :9] @ a.basis[:, :9].mH
    Pb = (b.basis[:, :9] @ b.basis[:, :9].mH).cpu()
    assert float((Pa - Pb).abs().max()) <= 1e-10
    for fn in (pod_error_2norm, pod_error_fro):
        ea, eb = float(fn(S, 5, device="cpu")), float(fn(S, 5, device=cuda))
        assert abs(ea - eb) <= 1e-12 * s0
    ra, rb = optimal_rrqr(S, 5, device="cpu"), optimal_rrqr(S, 5, device=cuda)
    ea = float(rrqr_error_2norm(S, ra.Qk))
    eb = float(rrqr_error_2norm(S.to(cuda), rb.Qk))
    assert abs(ea - eb) <= 1e-12 * s0
    assert abs(eb - float(rb.sigmas[5])) <= 1e-10 * s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_mgs_and_scan_on_cuda_match_cpu(cuda, dtype):
    """Pivoted MGS and the fixed-length greedy driver on the card against
    the CPU port: k and pivots exact (the scan's -1 included), errors
    within _tol; the scan's sweeps and GS passes launch the kernels."""
    from repro_torch.api import build_basis
    from repro_torch.core.greedy import rb_greedy, rb_greedy_scan

    gen = torch.Generator().manual_seed(10)
    S = _low_rank(gen, 200, 90, 8, dtype)
    scale = float(torch.linalg.vector_norm(S, dim=0).max())
    tau = 1e-3 * scale
    ma = build_basis(source=S, strategy="mgs", tau=tau, device="cpu")
    mb = build_basis(source=S, strategy="mgs", tau=tau, device=cuda)
    assert ma.k == mb.k == 8
    np.testing.assert_array_equal(ma.pivots, mb.pivots)
    tol = 100 * _tol(dtype, 200) * scale
    assert np.abs(ma.errs - mb.errs).max() <= tol
    sa = rb_greedy_scan(S, tau, 12, device="cpu")
    n0 = (gu_ops.launches, ip_ops.launches)
    sb = rb_greedy_scan(S, tau, 12, device=cuda)
    torch.cuda.synchronize()
    assert gu_ops.launches - n0[0] == 12
    assert ip_ops.launches - n0[1] == 12 * 3
    assert int(sa.k) == int(sb.k) == 8
    assert torch.equal(sa.pivots, sb.pivots.cpu())
    assert int(sb.pivots[8]) == -1
    assert float((sa.errs - sb.errs.cpu()).abs()[:8].max()) <= tol
    g = rb_greedy(S, tau, device=cuda)
    assert torch.equal(g.pivots[:8], sb.pivots[:8])


# ------------------------------------------------- the TaylorF2 generator --
def _grid(n_freq, n_mc, n_eta):
    from repro_torch.gw import chirp_grid, frequency_grid

    return (frequency_grid(40.0, 1024.0, n_freq),
            *chirp_grid(n_mc=n_mc, n_eta=n_eta))


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(17, 3, 1), (1000, 40, 16)])
def test_taylorf2_tile_matches_plain(cuda, shape, dtype, normalize):
    """The kernel against taylorf2_from_terms on the same terms, within 10
    eps sqrt(N) of the column norm (the phase has the same float64
    operations in both; the normalized norms sum in other orders); one
    launch a call; a column's bits those of any tile holding it, alone,
    and written into a column slice of a wider matrix."""
    from repro_torch.gw import WaveformGrid
    from repro_torch.kernels.taylorf2 import ops as tf_ops
    from repro_torch.kernels.taylorf2.ref import taylorf2_tile_ref

    g = WaveformGrid(*_grid(*shape), dtype=dtype, normalize=normalize,
                     device=cuda)
    N, M = g.shape
    n0 = tf_ops.launches
    full = g.tile(0, M)
    torch.cuda.synchronize()
    assert tf_ops.launches == n0 + 1 and full.shape == (N, M)
    ref = taylorf2_tile_ref(g.rows, g.cols, normalize, dtype)
    tol = _tol(dtype, N) * float(torch.linalg.vector_norm(ref, dim=0).max())
    assert float((full - ref).abs().max()) <= tol
    for lo, hi in ((0, 1), (M // 3, M // 3 + 1), (1, M), (M - 2, M)):
        assert torch.equal(g.tile(lo, hi), full[:, lo:hi])
    wide = torch.zeros((N, M + 9), dtype=dtype, device=cuda)
    g.tile(1, M, out=wide[:, 5:4 + M])
    assert torch.equal(wide[:, 5:4 + M], full[:, 1:])
    assert bool((wide[:, :5] == 0).all()) and bool((wide[:, 4 + M:] == 0)
                                                    .all())


def _general_n(dtype):
    """The least multiple of 10,000 rows whose slab overflows the sm90
    generator's shared memory: the general kernel's N."""
    from repro_torch.kernels.taylorf2 import ops as tf_ops

    n = 10_000
    while tf_ops.kernel_route(n, dtype) == "sm90":
        n += 10_000
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("route", ["sm90", "general", "forced_general"])
def test_taylorf2_routes_match_plain(cuda, route, dtype, normalize):
    """Each kernel against the plain version within 10 eps sqrt(N) of the
    column norm: N 2,000 on the sm90 route, an N whose slab overflows it on
    the general route, and the general kernel forced at N 2,000; one launch
    on the route named; unnormalized, the sm90 kernel has the general
    kernel's bits (the same float64 operations an element)."""
    from repro_torch.gw import WaveformGrid
    from repro_torch.kernels.taylorf2 import ops as tf_ops
    from repro_torch.kernels.taylorf2.ref import taylorf2_tile_ref

    n = _general_n(dtype) if route == "general" else 2000
    g = WaveformGrid(*_grid(n, 10, 3), dtype=dtype, normalize=normalize,
                     device=cuda)
    N, M = g.shape
    forced = route == "forced_general"
    want = "general" if forced else route
    assert forced or tf_ops.kernel_route(N, dtype) == route
    fn = tf_ops._taylorf2_tile_general if forced else tf_ops.taylorf2_tile
    n0 = getattr(tf_ops, f"launches_{want}")
    got = fn(g.rows, g.cols, 0, M, normalize, dtype)
    torch.cuda.synchronize()
    assert getattr(tf_ops, f"launches_{want}") == n0 + 1
    ref = taylorf2_tile_ref(g.rows, g.cols, normalize, dtype)
    tol = _tol(dtype, N) * float(torch.linalg.vector_norm(ref, dim=0).max())
    assert float((got - ref).abs().max()) <= tol
    if not normalize and want == "sm90":
        assert torch.equal(got, tf_ops._taylorf2_tile_general(
            g.rows, g.cols, 0, M, False, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("big", [False, True])
def test_taylorf2_column_bits_independent_of_the_tile(cuda, big, dtype,
                                                      normalize):
    """On either route a column has the bits of any tile that holds it:
    ragged widths (1, 7, 13, 33, 100), first columns off a multiple of the
    cluster's columns (1, 5, 13), and tiles written into a column slice of
    a wider matrix (a row stride that is not the tile's width)."""
    from repro_torch.gw import WaveformGrid

    g = WaveformGrid(*_grid(_general_n(dtype) if big else 1000, 20, 6),
                     dtype=dtype, normalize=normalize, device=cuda)
    N, M = g.shape
    full = g.tile(0, M)
    for lo, w in ((1, 7), (5, 33), (13, 1), (13, 100), (M - 13, 13),
                  (0, M - 1)):
        assert torch.equal(g.tile(lo, lo + w), full[:, lo:lo + w]), (lo, w)
        wide = torch.zeros((N, M + 11), dtype=dtype, device=cuda)
        g.tile(lo, lo + w, out=wide[:, 3:3 + w])
        assert torch.equal(wide[:, 3:3 + w], full[:, lo:lo + w]), (lo, w)
        assert bool((wide[:, :3] == 0).all())
        assert bool((wide[:, 3 + w:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_streamed_equals_resident_on_cuda(cuda, dtype, p):
    """On the card the streamed build over a WaveformProvider is the
    resident build over build_snapshot_matrix's S of the same grid, bit for
    bit (k, stop, pivots, Q, errs, R), at one tile, M-divisible tiles and
    a ragged odd-width last tile (the general greedy_update route beside
    the sm90 one); tau above the refresh trigger."""
    from repro_torch.core.block_greedy import _rb_greedy_block_impl
    from repro_torch.core.greedy import rb_greedy
    from repro_torch.core.streaming import rb_greedy_streamed
    from repro_torch.data import WaveformProvider
    from repro_torch.gw import build_snapshot_matrix

    grid = _grid(600, 20, 6)  # M = 120
    prov = WaveformProvider(*grid, dtype=dtype, normalize=False,
                            device=cuda)
    S = build_snapshot_matrix(*grid, dtype=dtype, device=cuda,
                              normalize=False, chunk=50)
    assert torch.equal(S, prov.materialize())
    tau = 3e-2 * float(torch.linalg.vector_norm(S, dim=0).max())
    ref = rb_greedy(S, tau, device=cuda) if p == 1 else \
        _rb_greedy_block_impl(S, tau, p=p, device=cuda)
    k = ref.k
    assert k > 8
    for tile_m in (120, 40, 33):
        got = rb_greedy_streamed(prov, tau, tile_m=tile_m, block_p=p)
        assert got.k == k and got.stop == ref.stop
        assert torch.equal(got.pivots[:k], ref.pivots[:k].cpu())
        assert torch.equal(got.errs[:k], ref.errs[:k].cpu())
        assert torch.equal(got.Q, ref.Q)
        assert torch.equal(got.R[:k], ref.R[:k].cpu())


@pytest.mark.cuda
def test_host_provider_copies_through_pinned_buffers(cuda):
    """A host matrix (pinned or not) stays on the host; its tiles reach the
    card through the side stream with the values of a device slice, and
    the streamed build over it is the one over the device matrix."""
    from repro_torch.core.streaming import rb_greedy_streamed
    from repro_torch.data import ArrayProvider

    gen = torch.Generator().manual_seed(11)
    S = _rand(gen, (300, 257), torch.complex64, "cpu")
    for host in (S, S.pin_memory()):
        prov = ArrayProvider(host, device=cuda)
        for lo, hi in ((0, 64), (64, 257), (100, 101)):
            assert torch.equal(prov.tile(lo, hi).cpu(), S[:, lo:hi])
        assert prov.bytes_to_device == S.element_size() * 300 * (64 + 193
                                                                 + 1)
    dev = ArrayProvider(S.to(cuda), device=cuda)
    a = rb_greedy_streamed(ArrayProvider(S.pin_memory(), device=cuda), 1e-2,
                           max_k=20, tile_m=64)
    b = rb_greedy_streamed(dev, 1e-2, max_k=20, tile_m=64)
    assert a.k == b.k and torch.equal(a.Q, b.Q)
    assert torch.equal(a.pivots, b.pivots)


# relative tolerance of a gaussian block, kernel against plain version:
# only erfinv differs (CUDA's erfinvf / erfinv against PyTorch's)
_GAUSS_TOL = {torch.float32: 1e-5, torch.complex64: 1e-5,
              torch.float64: 1e-10, torch.complex128: 1e-10}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "rademacher"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (7, 25), (4097, 1), (4097, 25),
                                   (65536, 110)])
def test_sketch_omega_kernel_matches_plain(cuda, shape, dtype, kind):
    """The generator kernel against its plain version (on the card) at
    seeds past 2^32 and tiles 0 / 49: rademacher bitwise, gaussian within
    _GAUSS_TOL of max(1, |omega|); one launch counted a call; two launches
    bitwise."""
    from repro_torch.kernels.sketch_omega import ops as so_ops
    from repro_torch.kernels.sketch_omega.ref import sketch_omega_ref

    for seed, tile in ((0, 0), (7, 49), (2 ** 40 + 3, 49)):
        n0 = so_ops.launches
        out = so_ops.sketch_omega(seed, tile,
                                  torch.empty(shape, dtype=dtype,
                                              device=cuda), kind)
        again = so_ops.sketch_omega(seed, tile, torch.empty_like(out), kind)
        torch.cuda.synchronize()
        assert so_ops.launches == n0 + 2 and torch.equal(out, again)
        ref = sketch_omega_ref(seed, tile, shape, dtype, kind, cuda)
        if kind == "rademacher":
            assert torch.equal(out, ref)
        else:
            err = ((out - ref).abs() / ref.abs().clamp(min=1.0)).max()
            assert float(err) <= _GAUSS_TOL[dtype], float(err)


@pytest.mark.cuda
def test_sketch_omega_never_takes_the_plain_version_on_cuda(cuda,
                                                            monkeypatch):
    """A CUDA tensor gets the kernel, never the plain version."""
    from repro_torch.kernels.sketch_omega import ops as so_ops

    def no(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(so_ops, "sketch_omega_ref", no)
    out = torch.empty((33, 5), dtype=torch.complex64, device=cuda)
    so_ops.sketch_omega(3, 1, out)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("power", [0, 1])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.float64])
def test_randomized_sketch_on_cuda(cuda, dtype, power, tmp_path):
    """rb_randomized_streamed on the card: one sketch_omega launch a tile
    (phase 0 only), the CPU build's k and sigma_hat within tolerance, and
    a crash mid-pass resumed to the uninterrupted bits."""
    from repro_torch.core.randomized import rb_randomized_streamed
    from repro_torch.data import ArrayProvider, FaultPlan, FaultyProvider
    from repro_torch.kernels.sketch_omega import ops as so_ops

    gen = torch.Generator().manual_seed(3)
    r = 12
    S = (_rand(gen, (500, r), dtype, "cpu")
         @ _rand(gen, (r, 333), dtype, "cpu"))
    kw = dict(tau=1e-3 * float(torch.linalg.matrix_norm(S, ord=2)),
              max_k=20, sketch_p=6, power=power, tile_m=40)
    n0 = so_ops.launches
    got = rb_randomized_streamed(S.to(cuda), **kw)
    assert so_ops.launches - n0 == got.n_tiles == 9
    cpu = rb_randomized_streamed(S, device="cpu", **kw)
    assert got.k == cpu.k == r and got.ell == cpu.ell
    np.testing.assert_allclose(got.svals, cpu.svals, rtol=0,
                               atol=1e-4 * float(cpu.svals[0]))
    d = str(tmp_path / "ck")
    prov = FaultyProvider(ArrayProvider(S.to(cuda), device=cuda),
                          FaultPlan(raise_at_tile=5 + 9 * power))
    with pytest.raises(IOError):
        rb_randomized_streamed(prov, checkpoint_dir=d,
                               checkpoint_every_tiles=2, **kw)
    res = rb_randomized_streamed(S.to(cuda), checkpoint_dir=d, resume=True,
                                 **kw)
    assert torch.equal(res.Q, got.Q) and np.array_equal(res.svals,
                                                        got.svals)


# ragged row counts of the column-norm checks: 1-3, odd levels all the way
# up, the path's N and its neighbours, and one past the single-launch
# limit (two launches: a partial stage, then the fold)
NORM_ROWS = [1, 2, 3, 313, 9999, 10_000, 10_001, 30_000]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NORM_ROWS)
def test_column_norms_kernel_is_the_tree_bitwise(cuda, dtype, n):
    """The kernel's column norms are the plain halving tree's bit for bit,
    on the card and against the CPU's tree, at widths that are not a
    multiple of a CTA's columns, on a column slice of a wider matrix
    (row stride above the width) and on a transposed view; one launch a
    call below 25,601 rows, two above."""
    from repro_torch.kernels.column_norms import ops as cn_ops
    from repro_torch.kernels.column_norms.ref import column_norms_sq_ref

    gen = torch.Generator().manual_seed(n)
    wide = _rand(gen, (n, 101), dtype, cuda)
    for X in (wide[:, :1], wide[:, :33], wide[:, 7:90], wide,
              _rand(gen, (37, n), dtype, cuda).mT):
        n0 = cn_ops.launches
        got = cn_ops.column_norms_sq(X)
        torch.cuda.synchronize()
        assert cn_ops.launches - n0 == len(cn_ops.plan(n))
        assert got.dtype == dtype.to_real() and got.shape == (X.shape[1],)
        assert torch.equal(got, column_norms_sq_ref(X))
        assert torch.equal(got.cpu(), column_norms_sq_ref(X.cpu()))


@pytest.mark.cuda
def test_column_norms_at_the_path_tile(cuda):
    """The randomized and streamed paths' tile, a (10,000, 65,536)
    complex64 column slice of a wider matrix: one launch, the tree's
    bits, and the greedy init's norms of the whole matrix in one launch
    with the bits of its tiles."""
    from repro_torch.core.greedy import _column_norms_sq
    from repro_torch.kernels.column_norms import ops as cn_ops
    from repro_torch.kernels.column_norms.ref import column_norms_sq_ref

    gen = torch.Generator(device=cuda).manual_seed(0)
    S = torch.randn((10_000, 2 * 65_536), dtype=torch.complex64,
                    device=cuda, generator=gen)
    T = S[:, 65_536:]
    n0 = cn_ops.launches
    got = cn_ops.column_norms_sq(T)
    whole = _column_norms_sq(S)
    torch.cuda.synchronize()
    assert cn_ops.launches - n0 == 2
    assert torch.equal(got, column_norms_sq_ref(T))
    assert torch.equal(whole[65_536:], got)


@pytest.mark.cuda
def test_column_norms_never_takes_the_plain_version_on_cuda(cuda,
                                                            monkeypatch):
    """A CUDA tensor gets the kernel, never the plain tree, through the
    function every caller uses."""
    from repro_torch.kernels.column_norms import ops as cn_ops
    from repro_torch.sums import column_norms_sq

    def no(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(cn_ops, "column_norms_sq_ref", no)
    X = torch.full((5, 40), 1 + 2j, dtype=torch.complex64, device=cuda)
    assert torch.equal(column_norms_sq(X),
                       torch.full((40,), 25.0, device=cuda))


@pytest.mark.cuda
def test_llc_probe_is_one_launch(cuda, monkeypatch):
    """reps passes of the working set in one launch, never the plain loop;
    the partial sums add up to reps * (x . x)."""
    from repro_torch.kernels.llc_probe import ops as lp_ops

    def no(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(lp_ops, "llc_probe_ref", no)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for n, reps in ((1 << 18, 64), (1 << 22, 4), (1 << 10, 3), (4, 2)):
        x = torch.randn((n,), generator=gen, device=cuda)
        n0 = lp_ops.launches
        part = lp_ops.llc_probe(x, reps)
        torch.cuda.synchronize()
        assert lp_ops.launches == n0 + 1
        want = reps * float(torch.dot(x.double(), x.double()))
        assert abs(float(part.double().sum()) - want) <= 1e-4 * want


@pytest.mark.cuda
def test_measured_cache_on_the_card(cuda):
    """The working-set sweep sees the L2 cliff on the card: a positive
    cache size, at most the largest working set."""
    from repro_torch.api import roofline as R

    cache = R._measure_cache_once(str(torch.device("cuda", 0)))
    assert 0 < cache <= 128 << 20


# --------------------------------------------- the B-lane sweep kernel ----
def _lane_case(gen, dtype, B, N, M, stacked, device, q_pad=None):
    """Lanes of the sweep's operands: q in rows ``q_pad`` elements apart
    (default: 512-byte lane rows, as the lockstep driver places them)."""
    from repro_torch.core.backend import lane_rows

    S = _rand(gen, (B, N, M) if stacked else (N, M), dtype, device)
    if q_pad is None:
        q = lane_rows(B, (N,), dtype, device)
    else:
        q = torch.zeros(B * (N + q_pad), dtype=dtype,
                        device=device).as_strided((B, N), (N + q_pad, 1))
    q.copy_(_rand(gen, (B, N), dtype, device))
    rdt = dtype.to_real()
    acc = torch.rand((B, M), generator=gen, dtype=torch.float64).to(
        rdt).to(device)
    col = (S.abs() ** 2).sum(-2)
    norms = (col if stacked else col.expand(B, M)).contiguous() + acc \
        + torch.randperm(M, generator=gen).to(device).to(rdt)
    return q, S, acc, norms


def _check_lanes(q, S, acc, norms, active=None, route="lanes"):
    """One call of the B-lane wrapper on ``route``, each lane bitwise the
    scalar wrapper's call on its operands with its own flag (the one-lane
    launch on the sm90 route: a lane's bits do not depend on B or its
    group; never the plain version)."""
    from repro_torch.kernels.greedy_update_lanes import ops as gl_ops

    stacked = S.dim() == 3
    n0 = getattr(gl_ops, f"launches_{route}")
    got = gl_ops.greedy_update_lanes(q, S, acc, norms, active)
    torch.cuda.synchronize()
    assert getattr(gl_ops, f"launches_{route}") == n0 + 1, route
    for b in range(q.shape[0]):
        one = gu_ops.greedy_update(
            q[b], S[b] if stacked else S, acc[b], norms[b],
            None if active is None else active[b])
        for x, y in zip(got, one):
            assert torch.equal(x[b], y), (b, route)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("B", [1, 2, 3, 8, 15, 16, 17])
@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_update_lanes_bitwise_the_scalar_kernel(cuda, dtype, B,
                                                       stacked):
    """Each lane of the B-lane kernel is bitwise its one-lane launch (the
    scalar sm90 route), for B 1 to 17 (a second group of lanes past 16 in
    the shared layout), N off a stage's rows and M off a CTA's 128
    columns."""
    gen = torch.Generator().manual_seed(B)
    M = 1000 if dtype.itemsize < 16 else 1001
    M -= M % (16 // dtype.itemsize)
    _check_lanes(*_lane_case(gen, dtype, B, 131, M, stacked, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_update_lanes_masked_lanes_read_nothing(cuda, dtype,
                                                        stacked):
    """A false lane gets what q = 0 gives, bitwise the scalar route's
    false flag; with every lane false the kernel reads neither S nor q
    (both NaN here) and still folds each lane's first-index argmax."""
    gen = torch.Generator().manual_seed(3)
    q, S, acc, norms = _lane_case(gen, dtype, 6, 300, 704, stacked, cuda)
    active = torch.tensor([True, False, True, False, False, True],
                          device=cuda)
    got = _check_lanes(q, S, acc, norms, active)
    assert torch.equal(got[0][1], torch.zeros_like(got[0][1]))
    assert torch.equal(got[1][3], acc[3])
    off = torch.zeros(6, dtype=torch.bool, device=cuda)
    got = _check_lanes(q.fill_(float("nan")), S.fill_(float("nan")), acc,
                       norms, off)
    assert torch.equal(got[1], acc)
    assert torch.equal(got[3], (norms - acc).argmax(dim=1))


@pytest.mark.cuda
def test_greedy_update_lanes_routes_by_shape(cuda):
    """Odd M in complex64 (rows off 16 bytes) and q lanes off 16-byte
    multiples go per lane, to the scalar kernel (its general route for odd
    M), still bitwise the scalar call on each lane."""
    gen = torch.Generator().manual_seed(4)
    n0 = gu_ops.launches_general
    _check_lanes(*_lane_case(gen, torch.complex64, 3, 70, 333, False, cuda),
                 route="per_lane")
    assert gu_ops.launches_general >= n0 + 3
    _check_lanes(*_lane_case(gen, torch.float32, 3, 70, 256, True, cuda,
                             q_pad=1), route="per_lane")


@pytest.mark.cuda
def test_greedy_update_lanes_wide_and_deterministic(cuda):
    """At the GW path's width (M 131,072: 1,024 CTAs a lane), eight lanes
    shared and stacked, bitwise the one-lane launches; two launches give the
    same bits."""
    from repro_torch.kernels.greedy_update_lanes import ops as gl_ops

    gen = torch.Generator().manual_seed(5)
    for stacked in (False, True):
        args = _lane_case(gen, torch.complex64, 8, 250, 131072, stacked,
                          cuda)
        a = _check_lanes(*args)
        b = gl_ops.greedy_update_lanes(*args)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.float64])
def test_batched_driver_lanes_bitwise_the_scalar_builds_on_card(cuda,
                                                                dtype):
    """The lockstep driver on the card: every lane, in both layouts, is
    bitwise the scalar build at its tau (the B-lane kernel's lanes are its
    one-lane launches, the scalar route's), with one B-lane launch a
    round."""
    from repro_torch.core.batch_greedy import batch_rb_greedy
    from repro_torch.core.greedy import rb_greedy
    from repro_torch.kernels.greedy_update_lanes import ops as gl_ops

    x = np.linspace(0, 1, 200)
    nu = np.linspace(0.5, 2.0, 128)
    S = np.stack([np.sin(2 * np.pi * v * x) * np.exp(-v * x) for v in nu],
                 axis=1)
    if dtype.is_complex:
        S = S * np.exp(1j * np.outer(x, nu))
    S = torch.from_numpy(S).to(dtype).to(cuda)
    scale = float(torch.linalg.vector_norm(S, dim=0).max())
    taus = [1e-2 * scale, 1e-4 * scale, 1e-6 * scale]
    for src in (S, torch.stack([S, S.flip(1).contiguous(), S])):
        n0 = gl_ops.launches_lanes
        res = batch_rb_greedy(src, taus, chunk=5, device=cuda)
        assert gl_ops.launches_lanes - n0 == res.rounds
        for b, tau in enumerate(taus):
            ref = rb_greedy(src if src.dim() == 2 else src[b], tau,
                            chunk=5, device=cuda)
            lane = res.lane(b)
            assert lane.k == ref.k and lane.stop == ref.stop
            for name in ("Q", "R", "pivots", "errs", "rnorms",
                         "n_ortho_passes"):
                assert torch.equal(getattr(lane, name), getattr(ref, name))


def _gw_resident(N, M, cuda):
    """The (N, M) complex64 GW matrix of ``_torch_dist_ranks.
    gw_card_build`` and its resident greedy build on the card."""
    from repro_torch.api import build_basis
    from repro_torch.gw import build_snapshot_matrix, chirp_grid
    from repro_torch.gw import frequency_grid

    f = frequency_grid(40.0, 1024.0, N)
    m1, m2 = chirp_grid(n_mc=M // 16, n_eta=16)
    S = build_snapshot_matrix(f, m1, m2, dtype=torch.complex64, device=cuda)
    return build_basis(source=S, strategy="greedy", tau=1e-4, max_k=64,
                       chunk=16, device=cuda)


def _assert_prefix_bitwise(got, ref):
    """k >= 5 and, on the shared prefix (the distributed build stops by
    the reference's distributed rules), pivots, errs, Q and R bit for
    bit."""
    k = min(got["k"], ref.k)
    assert k >= 5
    assert np.array_equal(got["pivots"][:k], ref.pivots[:k])
    assert np.array_equal(got["errs"][:k], ref.errs[:k])
    assert np.array_equal(got["Q"][:, :k], ref.Q[:, :k].cpu().numpy())
    assert np.array_equal(got["R"][:k], ref.R[:k])


@pytest.mark.cuda
def test_distributed_one_nccl_rank_is_the_resident_build(cuda):
    """One rank in this process: init_ranks picks NCCL (the rank has the
    card to itself), and the distributed build of a (512, 8,192) complex64
    GW matrix is bitwise the resident greedy build on the shared
    prefix."""
    import torch.distributed as dist

    from _torch_dist_ranks import gw_card_build
    from repro_torch.launch.mesh import close_ranks, init_ranks

    ranks = init_ranks(device="cuda")
    try:
        assert ranks.backend == "nccl" and ranks.world_size == 1
        got = gw_card_build(512, 8192, 16)
        assert dist.get_backend() == "nccl"
    finally:
        close_ranks()
    assert got["strategy"] == "distributed"
    _assert_prefix_bitwise(got, _gw_resident(512, 8192, cuda))


@pytest.mark.cuda
def test_distributed_two_gloo_ranks_share_the_card(cuda):
    """Two spawned ranks on one card: init_ranks picks gloo (NCCL refuses
    two ranks on one GPU), each rank generates its 4,096 columns, and the
    build is bitwise the resident greedy build on the shared prefix, on
    both ranks."""
    from _torch_dist_ranks import gw_card_build
    from repro_torch.launch.mesh import spawn_ranks

    out = spawn_ranks(gw_card_build, 2, (512, 8192, 16), device="cuda",
                      timeout_s=300)
    ref = _gw_resident(512, 8192, cuda)
    for got in out:
        assert got["backend"] == "gloo" and got["strategy"] == "distributed"
        _assert_prefix_bitwise(got, ref)


def _to_device(tree, device):
    """A parameter / cache tree (NamedTuples, dicts, lists) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-9b",
                                  "mamba2-780m", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_lm_family_on_card_matches_cpu(cuda, arch):
    """The reduced config (f32) prefilled and decoded 3 steps on the card
    against the CPU path on the same weights, tokens and vision / frame
    embeddings (the vlm's cross gates opened to 0.5): the card's attention
    is the flash kernel (one launch a self-attention layer of the prefill,
    the encoder's included, non-causal), the CPU's its plain version.  Both
    are f32 with TF32 off; they differ in the order of f32 sums, 1e-4 of
    the logits' scale."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import api

    cfg = get_reduced(arch).replace(attn_impl="flash")
    n_attn = {"moe": cfg.n_layers, "ssm": 0,
              "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
              "vlm": cfg.n_layers // max(cfg.cross_every, 1)
              * cfg.cross_every,
              "encdec": cfg.encoder_layers + cfg.n_layers}[cfg.family]
    params = api.init_params(cfg, 0, device="cpu")
    if cfg.family == "vlm":
        params = params._replace(cross=[dict(cp, gate=torch.tensor(0.5))
                                        for cp in params.cross])
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 80), generator=gen)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn(
            (2, cfg.vision_tokens, cfg.vision_dim), generator=gen)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (2, cfg.audio_frames, cfg.audio_dim), generator=gen)
    lc, cc = api.prefill(cfg, params, batch, max_len=88)
    n0 = fa_ops.launches
    lg, cg = api.prefill(cfg, _to_device(params, cuda),
                         _to_device(batch, cuda), max_len=88)
    torch.cuda.synchronize()
    assert fa_ops.launches - n0 == n_attn
    pg = _to_device(params, cuda)
    for step in range(4):
        tol = 1e-4 * max(1.0, float(lc.abs().max()))
        assert float((lg.cpu() - lc).abs().max()) <= tol, step
        if step == 3:
            break
        tok = lc.argmax(-1).to(torch.int32)
        lc, cc = api.decode_step(cfg, params, tok, cc)
        lg, cg = api.decode_step(cfg, pg, tok.to(cuda), cg)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_cached_cross_decode_on_bf16_is_the_f32_route(cuda, hd):
    """cross_attend_cached on a bf16 memory on the card (the query and the
    probabilities as three bf16 pieces, cuBLAS products with float32
    outputs, the memory never copied) against the same call on the memory
    cast to float32 (plain f32 products), elementwise: both sum exact
    products in float32 in other orders.  A logit's hd products are off
    by ~eps sqrt(hd) of max_s |q| . |k_s|, which moves the output by that
    much of attention(q, k, |v|); the output's S products by ~eps sqrt(S)
    of it.  Twice the two."""
    from repro_torch.models.attention import cross_attend_cached

    gen = torch.Generator().manual_seed(hd)
    B, H, K, S = 8, 16, 16, 4096
    q = (torch.randn((B, 1, H, hd), generator=gen) * hd ** -0.5).to(cuda)
    mk, mv = (torch.randn((B, K, S, hd), generator=gen).to(
        torch.bfloat16).to(cuda) for _ in range(2))
    k32, v32 = mk.float(), mv.float()
    out = cross_attend_cached(q, mk, mv)
    ref = cross_attend_cached(q, k32, v32)
    lmax = torch.bmm(q.abs().reshape(B * K, H // K, hd),
                     k32.abs().reshape(B * K, S, hd).transpose(1, 2)
                     ).amax(-1).reshape(B, 1, H, 1)
    a = cross_attend_cached(q, k32, v32.abs()).reshape(B, 1, H, hd)
    tol = (2 * torch.finfo(torch.float32).eps * (S ** 0.5 + hd ** 0.5 * lmax)
           * a).reshape(B, 1, H * hd)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert bool(((out - ref).abs() <= tol).all())


@pytest.mark.cuda
def test_flash_raises_under_grad_on_the_card(cuda):
    """The kernel has no backward pass: with q requiring grad both routes
    raise instead of returning an output with no gradient."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 128, 64), generator=gen).to(
        torch.bfloat16).to(cuda) for _ in range(3))
    q.requires_grad_()
    for fn in (fa_ops.flash_attention, fa_ops._flash_attention_general):
        n = fa_ops.launches
        with pytest.raises(NotImplementedError, match="queue 2 entry 5"):
            fn(q, k, v)
        assert fa_ops.launches == n
        with torch.no_grad():
            assert bool(torch.isfinite(fn(q, k, v)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_on_card_match_cpu(cuda, n_micro, monkeypatch):
    """Reduced stablelm-3b in float32 (TF32 off): the same parameters and
    batches, 5 steps on the card and on the CPU; the losses within 1e-4
    relative (the two sum products in other orders).  The deterministic
    step asks for the reproducible cuBLAS workspace setting; PyTorch's own
    workspace on an sm90 card has that size."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLMData
    from repro_torch.training import make_train_step, train_state_init
    from repro_torch.training.trainer import CUBLAS_WORKSPACE, state_to

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

    cfg = get_reduced("stablelm-3b")
    cpu_state = train_state_init(cfg, 0, device="cpu")
    losses = {}
    for name, state in (("cpu", cpu_state), ("card", state_to(cpu_state,
                                                               cuda))):
        data = SyntheticLMData(cfg.vocab_size, 32, 4, device=state.step.device)
        step = make_train_step(cfg, n_microbatches=n_micro, base_lr=1e-3,
                               warmup=0, total_steps=5)
        losses[name] = []
        for i in range(5):
            state, m = step(state, data.batch(i))
            losses[name].append(float(m["loss"]))
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_train_launcher_restart_is_bitwise_on_card(cuda, tmp_path):
    """The launcher on the card: uninterrupted, then crashed after step 17
    and resumed; the final checkpoints are the same bytes."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, PYTHONPATH=src)
    args = ["--arch", "stablelm-3b", "--reduced", "--steps", "30", "--seq",
            "32", "--batch", "4", "--ckpt-every", "10", "--log-every", "30",
            "--device", "cuda"]

    def run(ckpt, *extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *args,
             "--ckpt-dir", str(ckpt), *extra], env=env, capture_output=True,
            text=True, timeout=300)

    assert run(tmp_path / "ref").returncode == 0
    assert run(tmp_path / "ft", "--crash-at", "17").returncode == 42
    assert run(tmp_path / "ft").returncode == 0
    a, b = tmp_path / "ref" / "step_00000030", tmp_path / "ft" / "step_00000030"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
