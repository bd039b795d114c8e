"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the paper's RB-greedy build at the GW
workload's full width (N = 10,000 frequencies, complex64, max_k = 100,
M = 131,072 TaylorF2 snapshots: 10.5 GB of S on the card), then the
artifact and the ROQ online stage — and holds each hand-written kernel
against its plain PyTorch version.  Phases, each one JSON line:

  env        torch / CUDA versions and the card
  build      seconds to build the CUDA kernels (nvcc, at first use)
  kernels    each kernel vs its plain version at the main path's shapes and
             at small ragged ones, with the tolerance of each check; times
             of the kernel, the plain version and the one-call library
             yardstick (CUDA events, best of n), and the bound
  snapshots  generation of S on the card
  build_basis  the full-width build through the front door; launches of
             each kernel (counted from 0 just before it), orthogonality and
             per-column-error checks
  artifact   save/load bit-equality, EIM nodes
  roq        16 ROQ inner products against full quadrature

Then a line listing every ported kernel, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises: the
script exits non-zero and prints no result.  It needs a CUDA device and
the repository's ``src/`` beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# Shapes of the GW workload (the paper's N, dtype and max_k; M cut from
# 3,276,800 to what one 80 GB card holds beside the build's temporaries).
N, M, MAX_K = 10_000, 131_072, 100
N_MC, N_ETA = 512, 256            # chirp grid, N_MC * N_ETA == M
F_MIN, F_MAX = 40.0, 1024.0       # Hz
TAU = 1e-4
SEED = 0
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
FP32_FLOPS = 67e12                # H100 SXM, float32 outside tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int) -> float:
    """Best of ``reps`` CUDA-event timings of one call, after a warm-up."""
    fn()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sum_tol(dtype: torch.dtype, n: int) -> float:
    """Rounding of an n-term sum, relative to the terms' scale: the kernel
    and the plain version sum in different orders, each off by
    ~eps*sqrt(n); 10x margin."""
    return 10.0 * torch.finfo(dtype.to_real()).eps * math.sqrt(n)


# ------------------------------------------------------------- kernels ----
def check_greedy_update(S, q, acc, norms, exact_argmax: bool) -> float:
    """Kernel vs plain on one input; returns the max abs error of c."""
    from repro_torch.kernels.greedy_update.ops import greedy_update
    from repro_torch.kernels.greedy_update.ref import greedy_update_ref

    c, a, mx, am = greedy_update(q, S, acc, norms)
    cr, ar, mxr, amr = greedy_update_ref(q, S, acc, norms)
    torch.cuda.synchronize()
    eps = torch.finfo(acc.dtype).eps
    scale = float(torch.linalg.vector_norm(S, dim=0).max())
    tol = sum_tol(S.dtype, S.shape[0]) * scale * float(
        torch.linalg.vector_norm(q))
    err_c = float((c - cr).abs().max())
    tol_a = 2 * float(cr.abs().max()) * tol + 4 * eps * float(
        ar.abs().max())
    err_a = float((a - ar).abs().max())
    check(err_c <= tol, f"greedy_update c: {err_c} > {tol}")
    check(err_a <= tol_a, f"greedy_update acc_out: {err_a} > {tol_a}")
    # the kernel's argmax indexes a residual equal to its own max_res
    check(float(norms[am] - a[am]) == float(mx),
          "greedy_update argmax does not index max_res")
    tol_m = tol_a + 4 * eps * float(norms.abs().max())
    check(abs(float(mx) - float(mxr)) <= tol_m,
          f"greedy_update max_res: {float(mx)} vs {float(mxr)}")
    if exact_argmax:
        check(int(am) == int(amr), f"argmax {int(am)} != {int(amr)}")
    emit("kernels", kernel="greedy_update", dtype=str(S.dtype),
         shape=list(S.shape), max_abs_err_c=err_c, tol_c=tol,
         max_abs_err_acc=err_a, tol_acc=tol_a, max_res=float(mx),
         argmax=int(am), plain_argmax=int(amr), exact_argmax=exact_argmax)
    return err_c


def check_imgs_project(v, Q) -> float:
    from repro_torch.kernels.imgs_project.ops import imgs_project
    from repro_torch.kernels.imgs_project.ref import imgs_project_ref

    vo, c = imgs_project(v, Q)
    vr, cr = imgs_project_ref(v, Q)
    torch.cuda.synchronize()
    tol = sum_tol(Q.dtype, Q.shape[0]) * float(torch.linalg.vector_norm(v))
    err = max(float((c - cr).abs().max()), float((vo - vr).abs().max()))
    check(err <= tol, f"imgs_project: {err} > {tol}")
    emit("kernels", kernel="imgs_project", dtype=str(Q.dtype),
         shape=list(Q.shape), max_abs_err=err, tol=tol)
    return err


def random_update_inputs(gen, shape, dtype, dev):
    """Residuals separated by design (a distinct offset per column, far
    above the tolerance), so the argmax must match exactly."""
    n, m = shape
    S = rand(gen, (n, m), dtype, dev)
    q = rand(gen, (n,), dtype, dev)
    q = q / torch.linalg.vector_norm(q)
    rdt = dtype.to_real()
    acc = torch.rand(m, generator=gen, dtype=torch.float64).to(rdt).to(dev)
    perm = torch.randperm(m, generator=gen).to(dev).to(rdt)
    return S, q, acc, (S.abs() ** 2).sum(0) + perm


def rand(gen, shape, dtype, dev):
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(shape, generator=gen,
                                         dtype=torch.float64))
    return x.to(dtype).to(dev)


def kernel_phase(S, dev) -> dict:
    """Every kernel vs its plain version; timings at the main path's
    shapes.  Returns the per-kernel entries of the final kernels line."""
    from repro_torch.kernels.greedy_update.ops import greedy_update
    from repro_torch.kernels.greedy_update.ref import greedy_update_ref
    from repro_torch.kernels.imgs_project.ops import imgs_project
    from repro_torch.kernels.imgs_project.ref import imgs_project_ref

    gen = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float32, torch.complex64, torch.float64,
                  torch.complex128):
        for shape in ((17, 33), (300, 700)):
            check_greedy_update(*random_update_inputs(gen, shape, dtype, dev),
                                exact_argmax=True)
        for shape in ((33, 17), (513, 37)):
            Q = torch.linalg.qr(rand(gen, shape, dtype, dev))[0].contiguous()
            check_imgs_project(rand(gen, (shape[0],), dtype, dev), Q)

    # greedy_update at full width, on the GW snapshots themselves (real
    # residuals may have near-ties: the argmax is checked through max_res)
    q = rand(gen, (N,), S.dtype, dev)
    q = q / torch.linalg.vector_norm(q)
    norms = torch.linalg.vector_norm(S, dim=0) ** 2
    acc = torch.rand(M, generator=gen, dtype=torch.float64).to(
        norms.dtype).to(dev) * 0.5
    err_gu = check_greedy_update(S, q, acc, norms, exact_argmax=False)
    qc = q.conj().resolve_conj()
    # bytes: S, q, acc, norms read once; c, acc_out written once
    gu_bytes = S.nbytes + q.nbytes + 2 * acc.nbytes + norms.nbytes \
        + M * S.element_size()
    b_gu = bound(gu_bytes, 8 * N * M)
    gu = {
        "ms": time_ms(lambda: greedy_update(q, S, acc, norms), 10),
        "plain_ms": time_ms(lambda: greedy_update_ref(q, S, acc, norms), 10),
        "library_ms": time_ms(lambda: torch.mv(S.mT, qc), 10),
        "bound_ms": b_gu[0], "bound_by": b_gu[1], "max_abs_err": err_gu,
    }

    # imgs_project at the main path's (N, max_k) with a half-filled basis
    Q = torch.zeros((N, MAX_K), dtype=S.dtype, device=dev)
    Q[:, :MAX_K // 2] = torch.linalg.qr(
        rand(gen, (N, MAX_K // 2), S.dtype, dev))[0]
    v = rand(gen, (N,), S.dtype, dev)
    err_ip = check_imgs_project(v, Q)
    # bytes: Q and v read once; c and v' written once
    ip_bytes = Q.nbytes + 2 * v.nbytes + MAX_K * Q.element_size()
    b_ip = bound(ip_bytes, 16 * N * MAX_K)
    ip = {
        "ms": time_ms(lambda: imgs_project(v, Q), 50),
        "plain_ms": time_ms(lambda: imgs_project_ref(v, Q), 50),
        "library_ms": time_ms(
            lambda: torch.addmv(v, Q, torch.mv(Q.mH, v), alpha=-1), 50),
        "bound_ms": b_ip[0], "bound_by": b_ip[1], "max_abs_err": err_ip,
    }
    for name, entry, shape, nbytes in (
            ("greedy_update", gu, [N, M], gu_bytes),
            ("imgs_project", ip, [N, MAX_K], ip_bytes)):
        emit("kernels", kernel=name, timing_shape=shape, dtype=str(S.dtype),
             achieved_gb_s=nbytes / (entry["ms"] * 1e-3) / 1e9, **entry)
    return {"greedy_update": gu, "imgs_project": ip}


# ---------------------------------------------------------------- main ----
def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from repro_torch.api import ReducedBasis, build_basis
    from repro_torch.core.errors import per_column_errors
    from repro_torch.gw import build_snapshot_matrix, chirp_grid
    from repro_torch.gw import frequency_grid
    from repro_torch.gw.waveform import taylorf2_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.imgs_project import ops as ip_ops

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)

    t0 = time.perf_counter()
    reports = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for r in reports.values()
                for ln in r.splitlines() if "registers" in ln
                or "spill" in ln])

    # --- snapshots: TaylorF2 over the chirp grid, generated on the card
    f = frequency_grid(F_MIN, F_MAX, N)
    m1, m2 = chirp_grid(n_mc=N_MC, n_eta=N_ETA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S = build_snapshot_matrix(f, m1, m2, dtype=torch.complex64, device=dev)
    torch.cuda.synchronize()
    norms = torch.linalg.vector_norm(S, dim=0)
    check(tuple(S.shape) == (N, M) and bool(torch.isfinite(norms).all()),
          "snapshots not finite / wrong shape")
    check(float((norms - 1).abs().max()) <= 1e-4, "snapshots not unit-norm")
    emit("snapshots", seconds=time.perf_counter() - t0, shape=[N, M],
         dtype="complex64", gbytes=S.nbytes / 1e9)

    timings = kernel_phase(S, dev)

    # --- the main path: build_basis at full width, counts from 0
    gu_ops.launches = 0
    ip_ops.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    basis = build_basis(source=S, strategy="greedy", tau=TAU, max_k=MAX_K,
                        chunk=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"greedy_update": gu_ops.launches,
                "imgs_project": ip_ops.launches}
    k = basis.k
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path was not launched: {launches}")
    check(5 <= k <= MAX_K and np.all(np.isfinite(basis.errs)),
          f"bad rank {k}")
    eps = torch.finfo(torch.float32).eps
    Q64 = basis.Q.to(torch.complex128)
    defect = float(torch.linalg.matrix_norm(
        Q64.mH @ Q64 - torch.eye(k, dtype=Q64.dtype, device=dev), ord=2))
    defect_bound = 100 * 2.0 * eps * math.sqrt(k)
    check(defect <= defect_bound, f"orthogonality {defect} > {defect_bound}")
    cols = torch.randperm(M, generator=torch.Generator().manual_seed(SEED))[
        :8192].to(dev)
    pce = float(per_column_errors(S.index_select(1, cols), basis.Q).max())
    last = float(basis.errs[-1])
    check(pce <= 1.5 * last, f"per-column error {pce} > 1.5 * {last}")
    emit("build_basis", k=k, stop=basis.provenance["stop"],
         wall_s=wall, s_per_basis=wall / k,
         swept_gb_s=launches["greedy_update"] * S.nbytes / wall / 1e9,
         launches=launches, orthogonality=defect,
         orthogonality_bound=defect_bound, max_sampled_col_err=pce,
         last_err=last, col_err_bound=1.5 * last,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         backend=basis.provenance["backend"],
         device=basis.provenance["device"])

    # --- artifact: save, load, bit-equal; EIM
    with tempfile.TemporaryDirectory() as tmp:
        basis.save(tmp)
        back = ReducedBasis.load(tmp)
    same = (torch.equal(back.Q, basis.Q)
            and np.array_equal(back.pivots, basis.pivots)
            and np.array_equal(back.errs, basis.errs)
            and np.array_equal(back.R, basis.R)
            and torch.equal(back.eim().nodes, basis.eim().nodes)
            and torch.equal(back.eim().B, basis.eim().B))
    check(same, "artifact save/load is not bit-equal")
    nodes = basis.eim().nodes
    check(len(set(nodes.tolist())) == k, "EIM nodes repeat")
    emit("artifact", bit_equal=same, k=k, eim_nodes=k,
         nodes_head=nodes[:8].tolist())

    # --- ROQ: 16 inner products <d, h> (the online stage's requests)
    rng = np.random.default_rng(SEED)
    fd = torch.as_tensor(f, device=dev)
    df = float(f[1] - f[0])
    w = torch.full((N,), df, dtype=torch.float64, device=dev)
    d = taylorf2_batch(fd, torch.tensor([9.0]), torch.tensor([7.0]),
                       dtype=torch.complex128)[:, 0]
    d = d + 0.05 / math.sqrt(N) * torch.complex(
        torch.as_tensor(rng.standard_normal(N), device=dev),
        torch.as_tensor(rng.standard_normal(N), device=dev))
    omega = basis.roq_weights(d.to(torch.complex64), w)
    mc = rng.uniform(5.5, 14.5, 16)
    eta = rng.uniform(0.11, 0.24, 16)
    mt = mc / eta ** 0.6
    disc = np.sqrt(1 - 4 * eta)
    h = taylorf2_batch(fd, torch.as_tensor(0.5 * mt * (1 + disc)),
                       torch.as_tensor(0.5 * mt * (1 - disc)),
                       dtype=torch.complex64)
    full = (w * d.conj()) @ h.to(torch.complex128)
    roq = (omega @ h[nodes]).to(torch.complex128)
    wd = float(torch.linalg.vector_norm(w * d))
    interp = basis.eim().B @ h[nodes]
    i_err = torch.linalg.vector_norm((h - interp).to(torch.complex128),
                                     dim=0)
    err = (roq - full).abs()
    # Cauchy-Schwarz: |<d, h - I h>| <= |w d| |h - I h|; slack for the
    # complex64 rounding of the k-term ROQ sum and of the interpolant
    cs_bound = 1.01 * wd * i_err + 1e-4 * wd
    check(bool((err <= cs_bound).all()), "ROQ error above Cauchy-Schwarz")
    rel = (err / wd).cpu().numpy()  # normalized by |w d| |h|, |h| = 1
    check(bool(np.all(np.isfinite(rel))) and float(np.max(rel)) <= 1e-2,
          f"ROQ relative error {float(np.max(rel))} > 1e-2")
    emit("roq", requests=16, median_rel_err=float(np.median(rel)),
         max_rel_err=float(np.max(rel)), rel_err_bound=1e-2,
         max_interp_err=float(i_err.max()), k=k)

    kernels = []
    for name, src, replaces in (
            ("greedy_update", "src/repro_torch/csrc/greedy_update.cu",
             "src/repro/kernels/greedy_update/kernel.py:108,147"),
            ("imgs_project", "src/repro_torch/csrc/imgs_project.cu",
             "src/repro/kernels/imgs_project/kernel.py:67")):
        t = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
