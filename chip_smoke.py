"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two build paths at the GW workload's full width
(N = 10,000 frequencies, complex64, max_k = 100, M = 131,072 TaylorF2
snapshots: 10.5 GB of S on the card) — the paper's RB-greedy build, then
the artifact and the ROQ online stage, then the blocked build
(``strategy="block_greedy"``, block_p = 8) — then the dense-LM serving path
(granite-3-8b at full width, its prefill attention in the flash kernel),
and holds each hand-written kernel against its plain PyTorch version.  Phases, each one JSON line:

  env        torch / CUDA versions and the card
  build      seconds to build the CUDA kernels (nvcc, at first use)
  kernels    each kernel vs its plain version at the paths' shapes and at
             small ragged ones, with the tolerance of each check, each call
             on the route its wrapper's rule gives and, for greedy_update,
             imgs_project and imgs_panel, on their general routes too (two
             launches bitwise equal); both routes of greedy_update and
             imgs_project with a false active flag on NaN-filled S / Q (the
             zero-vector result exactly: the kernel never read them) and a
             true one (bitwise the unflagged call); times of the kernel,
             the plain version and the one-call library yardstick (CUDA
             events, best of n, the card's time alone: the host has issued
             a call before the card reaches it), with the routes of a
             wrapper timed in turns, and the bound
  snapshots  generation of S on the card
  build_basis  the full-width greedy build through the front door;
             launches of each kernel (counted from 0 just before it), every
             greedy_update and imgs_project launch on the sm90 route, the
             sweeps that read S (the steps up to the latched stop: the
             later ones' flags are false), orthogonality and
             per-column-error checks
  artifact   save/load bit-equality, EIM nodes
  roq        16 ROQ inner products against full quadrature
  block_build  the full-width blocked build through the front door, with
             the greedy basis freed first; launches counted from 0 just
             before it, every imgs_panel and imgs_project launch on the
             sm90 route, the same checks, k within the staleness bound

  lm_kernels  flash_attention's two kernels vs the plain version at the
             serve path's shape (B 4, Hq 32, Hkv 8, S 2048, D 128, bf16,
             causal) and at small ones (f32/bf16/f16, D 16-256, groups
             1/4/8, window 48, non-causal, ragged S, Sq < Skv), each with
             near-uniform and with peaked logits, each call on the route the
             rule gives (the general kernel also at the sm90 kernel's
             shapes); at the path's shape the sm90 kernel and the general
             one (the first design) timed in turns beside the plain version
             and SDPA, with TFLOP/s and the share of the bound
  serve      granite-3-8b at full width (bf16, attn_impl="flash", random
             weights from the seed, initialized on the card, the GW S freed
             first): ServeEngine.generate on 4 prompts of 2048 tokens, 32
             new tokens each; launches counted from 0 just before it, all
             40 flash launches on the sm90 route; prefill logits against
             the einsum (plain) path, two greedy runs equal, every logit
             finite

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
BLOCK_P = 8                       # the blocked path's pivots per sweep
SEED = 0
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
FP32_FLOPS = 67e12                # H100 SXM, float32 outside tensor cores
BF16_FLOPS = 989e12               # H100 SXM, bf16 / f16 tensor cores, dense
# The serving cell: granite-3-8b at full width, 4 requests of 2048-token
# prompts, 32 new tokens each (the KV cache holds prompt + new tokens).
LM_ARCH = "granite-3-8b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# (B, Hq, Hkv, Sq, Skv, D, causal, window) of the small flash checks:
# groups 1, 4 and 8; ragged S; a window of 48 against key tiles of 64; Sq <
# Skv end-aligned; non-causal, with Sq > Skv too; D 16 to 256; one query.
FA_CASES = [
    (2, 4, 4, 200, 200, 64, True, None),
    (1, 8, 2, 256, 256, 128, True, None),
    (1, 8, 1, 130, 130, 16, True, 48),
    (2, 4, 1, 64, 300, 80, True, 48),
    (1, 4, 2, 100, 100, 256, False, None),
    (1, 2, 2, 80, 48, 32, False, None),
    (1, 4, 4, 1, 77, 64, True, None),
]
# 16-bit cases of the sm90 kernel (D 64 / 128 / 256): Sq and Skv off its
# 128-row query and key tiles, a window of 48 inside one key tile, Sq < Skv,
# non-causal with Sq > Skv.
SM90_CASES = [
    (1, 8, 2, 333, 333, 128, True, None),
    (1, 8, 1, 300, 300, 128, True, 48),
    (2, 4, 1, 70, 390, 64, True, 48),
    (1, 4, 4, 190, 130, 128, False, None),
    (1, 4, 2, 150, 200, 256, True, None),
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int, queued: bool = True) -> float:
    """Best of ``reps`` CUDA-event timings of one call, after a warm-up.

    ``queued``: a ~1 ms spin kernel is enqueued before the start event, so
    the host has issued the call's launches before the card reaches them
    and the time is the card's alone.  Without it the time also holds the
    host's cost of issuing the call (Python, argument checks, launches)."""
    fn()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def bound(nbytes: int, flops: int,
          flops_per_s: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sum_tol(dtype: torch.dtype, n: int) -> float:
    """Rounding of an n-term sum, relative to the terms' scale: the kernel
    and the plain version sum in different orders, each off by
    ~eps*sqrt(n); 10x margin."""
    return 10.0 * torch.finfo(dtype.to_real()).eps * math.sqrt(n)


# ------------------------------------------------------------- kernels ----
def check_greedy_update(S, q, acc, norms, exact_argmax: bool,
                        general: bool = False) -> float:
    """Kernel vs plain on one input, on the route kernel_route gives (or,
    with ``general``, the general kernel); the call must launch once, on
    that route, and a second launch give the same bits.  Returns the max
    abs error of c."""
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.greedy_update.ref import greedy_update_ref

    route = "general" if general else gu_ops.kernel_route(
        S.dtype, S.shape[1], S.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    fn = gu_ops._greedy_update_general if general else gu_ops.greedy_update
    n0 = getattr(gu_ops, f"launches_{route}")
    c, a, mx, am = fn(q, S, acc, norms)
    again = fn(q, S, acc, norms)
    cr, ar, mxr, amr = greedy_update_ref(q, S, acc, norms)
    torch.cuda.synchronize()
    check(getattr(gu_ops, f"launches_{route}") == n0 + 2,
          f"greedy_update: the calls did not launch the {route} kernel")
    check(all(torch.equal(x, y) for x, y in zip((c, a, mx, am), again)),
          f"greedy_update [{route}]: two launches differ")
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
    emit("kernels", kernel="greedy_update", route=route, dtype=str(S.dtype),
         shape=list(S.shape), max_abs_err_c=err_c, tol_c=tol,
         max_abs_err_acc=err_a, tol_acc=tol_a, max_res=float(mx),
         argmax=int(am), plain_argmax=int(amr), exact_argmax=exact_argmax)
    return err_c


def check_block_sweep(Qnew, S, acc) -> float:
    """Kernel vs plain on one input; returns the max abs error of C."""
    from repro_torch.kernels.block_sweep.ops import block_sweep
    from repro_torch.kernels.block_sweep.ref import block_sweep_ref

    C, a = block_sweep(Qnew, S, acc)
    Cr, ar = block_sweep_ref(Qnew, S, acc)
    torch.cuda.synchronize()
    p = Qnew.shape[1]
    eps = torch.finfo(acc.dtype).eps
    tol = sum_tol(S.dtype, S.shape[0]) * float(
        torch.linalg.vector_norm(S, dim=0).max()) * float(
        torch.linalg.vector_norm(Qnew, dim=0).max())
    err_c = float((C - Cr).abs().max())
    # acc_out adds p terms |C_i|^2, each off by ~2 |C_i| tol, and rounds
    # a (p + 1)-term sum
    tol_a = 2 * p * float(Cr.abs().max()) * tol + (p + 4) * eps * float(
        ar.abs().max())
    err_a = float((a - ar).abs().max())
    check(err_c <= tol, f"block_sweep C: {err_c} > {tol}")
    check(err_a <= tol_a, f"block_sweep acc_out: {err_a} > {tol_a}")
    zero = (Qnew == 0).all(0)
    check(bool((C[zero] == 0).all()), "block_sweep: a zero column of Qnew "
          "gave a nonzero row of C")
    emit("kernels", kernel="block_sweep", dtype=str(S.dtype),
         shape=list(S.shape), p=p, max_abs_err_c=err_c, tol_c=tol,
         max_abs_err_acc=err_a, tol_acc=tol_a)
    return err_c


def check_imgs_panel(V, Q, general: bool = False) -> float:
    """Kernel vs plain on one input, on the route kernel_route gives (or,
    with ``general``, the general kernel); the call must launch once, on
    that route, and a second launch give the same bits."""
    from repro_torch.kernels.imgs_panel import ops as pp_ops
    from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref

    route = "general" if general else pp_ops.kernel_route(
        Q.dtype, Q.shape[1], V.shape[1])
    fn = pp_ops._imgs_panel_general if general else pp_ops.imgs_panel
    n0 = getattr(pp_ops, f"launches_{route}")
    Vo, C = fn(V, Q)
    again = fn(V, Q)
    Vr, Cr = imgs_panel_ref(V, Q)
    torch.cuda.synchronize()
    check(getattr(pp_ops, f"launches_{route}") == n0 + 2,
          f"imgs_panel: the calls did not launch the {route} kernel")
    check(torch.equal(Vo, again[0]) and torch.equal(C, again[1]),
          f"imgs_panel [{route}]: two launches differ")
    tol = sum_tol(Q.dtype, Q.shape[0]) * float(
        torch.linalg.vector_norm(V, dim=0).max())
    err = max(float((C - Cr).abs().max()), float((Vo - Vr).abs().max()))
    check(err <= tol, f"imgs_panel [{route}]: {err} > {tol}")
    emit("kernels", kernel="imgs_panel", route=route, dtype=str(Q.dtype),
         shape=list(Q.shape), p=V.shape[1], max_abs_err=err, tol=tol)
    return err


def check_imgs_project(v, Q, general: bool = False) -> float:
    """Kernel vs plain on one input, on the route kernel_route gives (or,
    with ``general``, the general kernel); the call must launch once, on
    that route, and a second launch give the same bits."""
    from repro_torch.kernels.imgs_project import ops as ip_ops
    from repro_torch.kernels.imgs_project.ref import imgs_project_ref

    route = "general" if general else ip_ops.kernel_route(
        Q.dtype, Q.shape[1])
    fn = ip_ops._imgs_project_general if general else ip_ops.imgs_project
    n0 = getattr(ip_ops, f"launches_{route}")
    vo, c = fn(v, Q)
    again = fn(v, Q)
    vr, cr = imgs_project_ref(v, Q)
    torch.cuda.synchronize()
    check(getattr(ip_ops, f"launches_{route}") == n0 + 2,
          f"imgs_project: the calls did not launch the {route} kernel")
    check(torch.equal(vo, again[0]) and torch.equal(c, again[1]),
          f"imgs_project [{route}]: two launches differ")
    tol = sum_tol(Q.dtype, Q.shape[0]) * float(torch.linalg.vector_norm(v))
    err = max(float((c - cr).abs().max()), float((vo - vr).abs().max()))
    check(err <= tol, f"imgs_project [{route}] {tuple(Q.shape)} "
          f"{Q.dtype}: {err} > {tol}")
    emit("kernels", kernel="imgs_project", route=route, dtype=str(Q.dtype),
         shape=list(Q.shape), max_abs_err=err, tol=tol)
    return err


def check_flags(gen, dtype, dev) -> None:
    """Both routes of greedy_update and imgs_project with a false active
    flag return exactly what a zero vector gives with S / Q full of NaN
    (so the kernel never read them), and with a true flag the bits of the
    unflagged call; each case then a normal call on the same route, held
    to the plain version (the counters the kernels take were left at 0)."""
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.imgs_project import ops as ip_ops

    off = torch.zeros((), dtype=torch.bool, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    S, q, acc, norms = random_update_inputs(gen, (300, 1024), dtype, dev)
    # a tie of the largest residual norms - acc at columns 5 and 900: 5 wins
    acc_t, norms_t = acc.clone(), norms.clone()
    acc_t[5] = acc_t[900] = 0.5
    norms_t[5] = norms_t[900] = (norms - acc).max() + 1.5
    S_nan = torch.full_like(S, float("nan"))
    Q = torch.linalg.qr(rand(gen, (N, MAX_K), dtype, dev))[0].contiguous()
    Q_nan = torch.full_like(Q, float("nan"))
    v = rand(gen, (N,), dtype, dev)
    for general in (False, True):
        fn = gu_ops._greedy_update_general if general else \
            gu_ops.greedy_update
        c, a, mx, am = fn(q, S_nan, acc_t, norms_t, off)
        torch.cuda.synchronize()
        check(torch.equal(c, torch.zeros_like(c)) and torch.equal(a, acc_t)
              and int(am) == 5
              and float(mx) == float((norms_t - acc_t).max()),
              f"greedy_update [{general=}] {dtype}: a false flag did not "
              "give the zero-vector result")
        check(all(torch.equal(x, y) for x, y in
                  zip(fn(q, S, acc, norms, on), fn(q, S, acc, norms))),
              f"greedy_update [{general=}] {dtype}: a true flag changed "
              "the bits")
        check_greedy_update(S, q, acc, norms, exact_argmax=True,
                            general=general)
        fn = ip_ops._imgs_project_general if general else \
            ip_ops.imgs_project
        vo, c = fn(v, Q_nan, off)
        torch.cuda.synchronize()
        check(torch.equal(vo, v) and torch.equal(c, torch.zeros_like(c)),
              f"imgs_project [{general=}] {dtype}: a false flag did not "
              "give the zero-vector result")
        check(all(torch.equal(x, y) for x, y in
                  zip(fn(v, Q, on), fn(v, Q))),
              f"imgs_project [{general=}] {dtype}: a true flag changed "
              "the bits")
        check_imgs_project(v, Q, general)
    emit("kernels", check="active_flag", dtype=str(dtype),
         kernels=["greedy_update", "imgs_project"],
         routes=["sm90", "general"], ok=True)


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


def macs_flops(dtype: torch.dtype) -> int:
    """Flops of one multiply-add: 8 in complex, 2 in real."""
    return 8 if dtype.is_complex else 2


def timed(name, shape, dtype, nbytes, flops, err, reps, kernel, plain,
          library, flops_per_s=FP32_FLOPS) -> dict:
    """Times of the kernel, its plain version and the library yardstick
    (best of ``reps``), the bound; one kernels line."""
    b = bound(nbytes, flops, flops_per_s)
    entry = {"ms": time_ms(kernel, reps), "plain_ms": time_ms(plain, reps),
             "library_ms": time_ms(library, reps), "bound_ms": b[0],
             "bound_by": b[1], "max_abs_err": err}
    emit("kernels", kernel=name, timing_shape=shape, dtype=str(dtype),
         achieved_gb_s=nbytes / (entry["ms"] * 1e-3) / 1e9, **entry)
    return entry


def timed_turns(name, shape, dtype, nbytes, flops, errs, reps, kernels,
                plain, library, host_reps=0) -> dict:
    """A kernel's routes timed in turns beside its plain version and the
    library yardstick (routes, plain, library, routes reversed; best of
    ``reps`` each); one kernels line per route.  ``kernels`` and ``errs``
    map each entry name to its call and its max abs error.  With
    ``host_reps``, also the time of a call issued to an idle card, the
    host's cost of issuing it included (``call_ms``)."""
    b = bound(nbytes, flops)
    turns = {n: [] for n in (*kernels, "plain", "library")}
    for n, fn in kernels.items():
        turns[n].append(time_ms(fn, reps))
    turns["plain"].append(time_ms(plain, reps))
    turns["library"].append(time_ms(library, reps))
    for n, fn in reversed(kernels.items()):
        turns[n].append(time_ms(fn, reps))
    calls = {}
    if host_reps:
        for n, fn in (*kernels.items(), ("library", library)):
            calls[n] = time_ms(fn, host_reps, queued=False)
    out = {}
    for n in kernels:
        ms = min(turns[n])
        out[n] = {"ms": ms, "plain_ms": turns["plain"][0],
                  "library_ms": turns["library"][0], "bound_ms": b[0],
                  "bound_by": b[1], "max_abs_err": errs[n]}
        extra = {"call_ms": calls[n], "library_call_ms": calls["library"]} \
            if host_reps else {}
        emit("kernels", kernel=n, timing_shape=shape, dtype=str(dtype),
             turns_ms=turns[n], bound_share=b[0] / ms,
             achieved_gb_s=nbytes / (ms * 1e-3) / 1e9, **extra, **out[n])
    return out


def time_greedy_update(S, gen, dev, suffix="") -> dict:
    """greedy_update's two routes at full width, on the GW snapshots
    themselves (real residuals may have near-ties: the argmax is checked
    through max_res)."""
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.greedy_update.ref import greedy_update_ref

    q = rand(gen, (N,), S.dtype, dev)
    q = q / torch.linalg.vector_norm(q)
    norms = torch.linalg.vector_norm(S, dim=0) ** 2
    acc = torch.rand(M, generator=gen, dtype=torch.float64).to(
        norms.dtype).to(dev) * 0.5
    check(gu_ops.kernel_route(S.dtype, M, True) == "sm90",
          "greedy_update: the path's shape is not on the sm90 route")
    errs = {"greedy_update" + suffix: check_greedy_update(
                S, q, acc, norms, exact_argmax=False),
            "greedy_update_general" + suffix: check_greedy_update(
                S, q, acc, norms, exact_argmax=False, general=True)}
    qc = q.conj().resolve_conj()
    # bytes: S, q, acc, norms read once; c, acc_out written once
    nbytes = S.nbytes + q.nbytes + 2 * acc.nbytes + norms.nbytes \
        + M * S.element_size()
    return timed_turns(
        "greedy_update", [N, M], S.dtype, nbytes, macs_flops(S.dtype) * N * M,
        errs, 10,
        {"greedy_update" + suffix: lambda: gu_ops.greedy_update(
            q, S, acc, norms),
         "greedy_update_general" + suffix:
             lambda: gu_ops._greedy_update_general(q, S, acc, norms)},
        lambda: greedy_update_ref(q, S, acc, norms),
        lambda: torch.mv(S.mT, qc))


def kernel_phase(S, dev) -> dict:
    """Every kernel vs its plain version; timings at the build paths'
    shapes.  Returns the per-kernel entries of the final kernels line."""
    from repro_torch.kernels.block_sweep.ops import block_sweep
    from repro_torch.kernels.block_sweep.ref import block_sweep_ref
    from repro_torch.kernels.imgs_panel import ops as pp_ops
    from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref
    from repro_torch.kernels.imgs_project import ops as ip_ops
    from repro_torch.kernels.imgs_project.ref import imgs_project_ref

    gen = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float32, torch.complex64, torch.float64,
                  torch.complex128):
        # both routes: odd M (the general route but in complex128), M off
        # the sm90 kernel's 128-column tiles, N off its stages
        for shape in ((17, 33), (300, 700), (129, 1000)):
            for general in (False, True):
                check_greedy_update(
                    *random_update_inputs(gen, shape, dtype, dev),
                    exact_argmax=True, general=general)
        # both routes: odd K, a ragged last slab (N off a multiple of a
        # CTA's rows), K 1, 8 and 100, and N = 40,001: every SM, rows past
        # what fits in shared memory (two chunks a CTA)
        for shape in ((33, 17), (513, 37), (2113, 7), (3001, 1), (3001, 8),
                      (1000, 100), (40001, 100)):
            Q = torch.linalg.qr(rand(gen, shape, dtype, dev))[0]
            if shape[1] > 1:   # an empty slot of the basis
                Q[:, shape[1] // 2] = 0
            v = rand(gen, (shape[0],), dtype, dev)
            for general in (False, True):
                check_imgs_project(v, Q.contiguous(), general)
        check_flags(gen, dtype, dev)
        # p below, at and above the kernels' widest panel of 32; a zero
        # column stands for a rejected candidate / an empty slot
        for n, m, p in ((17, 33, 1), (300, 700, 3), (257, 130, 8),
                        (129, 257, 33)):
            Qnew = torch.linalg.qr(rand(gen, (n, p), dtype, dev))[0]
            Qnew[:, p // 2] = 0
            acc = torch.rand(m, generator=gen, dtype=torch.float64).to(
                dtype.to_real()).to(dev)
            check_block_sweep(Qnew.contiguous(), rand(gen, (n, m), dtype, dev),
                              acc)
        # both routes: ragged slabs and a ticket tree of one to three
        # levels, odd and even K and p, two column panels
        for n, k, p in ((33, 17, 1), (513, 37, 3), (300, 40, 8),
                        (1100, 40, 33), (40001, 9, 2)):
            Q = torch.linalg.qr(rand(gen, (n, k), dtype, dev))[0]
            Q[:, k // 2] = 0
            V = rand(gen, (n, p), dtype, dev)
            for general in (False, True):
                check_imgs_panel(V, Q.contiguous(), general)

    out = time_greedy_update(S, gen, dev)
    # the f32 case of greedy_update (greedy_update_real on the TPU) at the
    # same width, on the real part of the snapshots; not on the GW path
    S32 = S.real.contiguous()
    time_greedy_update(S32, gen, dev, suffix="_f32")
    del S32
    torch.cuda.empty_cache()

    # imgs_project at the greedy path's (N, max_k) with a half-filled basis
    Q = torch.zeros((N, MAX_K), dtype=S.dtype, device=dev)
    Q[:, :MAX_K // 2] = torch.linalg.qr(
        rand(gen, (N, MAX_K // 2), S.dtype, dev))[0]
    v = rand(gen, (N,), S.dtype, dev)
    check(ip_ops.kernel_route(S.dtype, MAX_K) == "sm90",
          "imgs_project: the path's shape is not on the sm90 route")
    # bytes: Q and v read once; c and v' written once
    out.update(timed_turns(
        "imgs_project", [N, MAX_K], S.dtype,
        Q.nbytes + 2 * v.nbytes + MAX_K * Q.element_size(),
        2 * macs_flops(S.dtype) * N * MAX_K,
        {"imgs_project": check_imgs_project(v, Q),
         "imgs_project_general": check_imgs_project(v, Q, general=True)},
        50,
        {"imgs_project": lambda: ip_ops.imgs_project(v, Q),
         "imgs_project_general": lambda: ip_ops._imgs_project_general(v, Q)},
        lambda: imgs_project_ref(v, Q),
        lambda: torch.addmv(v, Q, torch.mv(Q.mH, v), alpha=-1),
        host_reps=50))

    # block_sweep at the blocked path's (N, M) and p
    Qnew = torch.linalg.qr(rand(gen, (N, BLOCK_P), S.dtype, dev))[0] \
        .contiguous()
    acc = torch.rand(M, generator=gen, dtype=torch.float64).to(
        S.dtype.to_real()).to(dev) * 0.5
    # bytes: S, Qnew, acc read once; C, acc_out written once
    out["block_sweep"] = timed(
        "block_sweep", [N, M, BLOCK_P], S.dtype,
        S.nbytes + Qnew.nbytes + 2 * acc.nbytes
        + BLOCK_P * M * S.element_size(),
        macs_flops(S.dtype) * BLOCK_P * N * M,
        check_block_sweep(Qnew, S, acc), 10,
        lambda: block_sweep(Qnew, S, acc),
        lambda: block_sweep_ref(Qnew, S, acc),
        lambda: torch.matmul(Qnew.mH, S))

    # imgs_panel at the blocked path's (N, max_k + p) slots, half filled
    K = MAX_K + BLOCK_P
    Q = torch.zeros((N, K), dtype=S.dtype, device=dev)
    Q[:, :K // 2] = torch.linalg.qr(rand(gen, (N, K // 2), S.dtype, dev))[0]
    V = rand(gen, (N, BLOCK_P), S.dtype, dev)
    check(pp_ops.kernel_route(S.dtype, K, BLOCK_P) == "sm90",
          "imgs_panel: the path's shape is not on the sm90 route")
    # bytes: Q and V read once; C and V' written once
    out.update(timed_turns(
        "imgs_panel", [N, K, BLOCK_P], S.dtype,
        Q.nbytes + 2 * V.nbytes + K * BLOCK_P * Q.element_size(),
        2 * macs_flops(S.dtype) * N * K * BLOCK_P,
        {"imgs_panel": check_imgs_panel(V, Q),
         "imgs_panel_general": check_imgs_panel(V, Q, general=True)}, 50,
        {"imgs_panel": lambda: pp_ops.imgs_panel(V, Q),
         "imgs_panel_general": lambda: pp_ops._imgs_panel_general(V, Q)},
        lambda: imgs_panel_ref(V, Q),
        lambda: torch.addmm(V, Q, torch.mm(Q.mH, V), alpha=-1),
        host_reps=50))
    return out


# --------------------------------------------------------- LM kernels ----
# q and k scales of the flash checks: 0.3 gives logits of std 0.09 (a
# near-uniform softmax, as at initialization); 2.0 gives logits of std 4,
# peaked, so that the running max of a row moves across key tiles and the
# rescale of the output by alpha = exp(m_old - m_new) is far from 1.
FA_QK_SCALES = (0.3, 2.0)


def fa_tol(q, k, v, causal, window):
    """The plain version r (f32, from the same rounded inputs) and the
    elementwise tolerance of the kernel's output against it.

    16-bit: the kernel differs from r by (1) P rounded to the input type
    for the second product, each p_j off by at most u = eps / 2 of itself
    (or half the smallest subnormal, f16), which moves o_i by at most
    u * sum_j p_j |v_j| / l = u * attention(q, k, |v|)_i; (2) the output's
    rounding, u |o_i|; (3) f32 sums in another order, ~1e-6 relative.  The
    tolerance is twice that bound: eps (|r| + attention(q, k, |v|)) plus
    Skv subnormal steps of max|v|.  f32: both sum in f32 in different
    orders, ~eps * sqrt(D) of the logits' scale; 1e-4 of max|v|."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    qf, kf, vf = q.float(), k.float(), v.float()
    r = attention_ref(qf, kf, vf, causal=causal, window=window)
    vmax = float(vf.abs().max())
    if q.dtype == torch.float32:
        return r, torch.full_like(r, 1e-4 * vmax)
    a = attention_ref(qf, kf, vf.abs(), causal=causal, window=window)
    fi = torch.finfo(q.dtype)
    return r, fi.eps * (r.abs() + a) + (
        k.shape[2] * fi.smallest_normal * fi.eps * vmax)


def fa_inputs(gen, B, hq, hkv, sq, skv, D, dtype, dev, qk_scale=0.3):
    """q, k, v as transposed views of (B, S, H, D) tensors: the layout
    multihead_attention hands the kernel.  q and k are scaled by
    ``qk_scale``, v is standard normal."""
    out = []
    for h, s, scale in ((hq, sq, qk_scale), (hkv, skv, qk_scale),
                        (hkv, skv, 1.0)):
        x = torch.randn((B, s, h, D), generator=gen, device=dev) * scale
        out.append(x.to(dtype).transpose(1, 2))
    return out


def check_flash(q, k, v, causal, window, qk_scale, general=False) -> float:
    """Kernel vs plain on one input, elementwise within fa_tol; 16-bit
    also within eps in relative L2 (the two roundings are unbiased and
    ~u / sqrt(3) of |o| each in rms, ~0.4 eps together).  The call takes
    the route kernel_route gives, or with ``general`` the general kernel;
    it must launch once, on that route."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    route = "general" if general else fa_ops.kernel_route(
        q.dtype, q.shape[3], fa_ops.aligned16(q, k, v))
    fn = fa_ops._flash_attention_general if general else \
        fa_ops.flash_attention
    n0 = getattr(fa_ops, f"launches_{route}")
    o = fn(q, k, v, causal=causal, window=window)
    r, tol = fa_tol(q, k, v, causal, window)
    torch.cuda.synchronize()
    check(getattr(fa_ops, f"launches_{route}") == n0 + 1,
          f"flash_attention: the call did not launch the {route} kernel")
    check(o.dtype == q.dtype and o.shape == q.shape,
          "flash_attention: output dtype / shape")
    d = o.float() - r
    err = float(d.abs().max())
    worst = float((d.abs() / tol).max())
    rel_l2 = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(r))
    rel_tol = (None if q.dtype == torch.float32
               else torch.finfo(q.dtype).eps)
    what = (f"flash_attention [{route}] {tuple(q.shape)} {q.dtype} "
            f"causal={causal} window={window} qk_scale={qk_scale}")
    check(worst <= 1.0, f"{what}: |o - r| up to {worst} x its tolerance")
    check(rel_tol is None or rel_l2 <= rel_tol,
          f"{what}: relative L2 {rel_l2} > {rel_tol}")
    emit("lm_kernels", kernel="flash_attention", route=route,
         dtype=str(q.dtype), q_shape=list(q.shape), kv_shape=list(k.shape),
         causal=causal, window=window, qk_scale=qk_scale, max_abs_err=err,
         max_err_over_tol=worst, rel_l2=rel_l2, rel_l2_tol=rel_tol,
         mean_abs_ref=float(r.abs().mean()))
    return err


def lm_kernel_phase(dev) -> dict:
    """flash_attention's two kernels vs the plain version at small shapes
    and at the serve path's; the two kernels timed in turns at the path's
    shape.  Returns the timing entries of both."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)
    half = (torch.bfloat16, torch.float16)
    for dtype in (torch.float32, *half):
        for case in FA_CASES + (SM90_CASES if dtype in half else []):
            for qs in FA_QK_SCALES:
                check_flash(*fa_inputs(gen, *case[:6], dtype, dev, qs),
                            case[6], case[7], qs)
    # the general kernel's 16-bit branch where the sm90 kernel now serves
    for dtype in half:
        for case in FA_CASES:
            if case[5] in fa_ops.SM90_HEAD_DIMS:
                check_flash(*fa_inputs(gen, *case[:6], dtype, dev, 2.0),
                            case[6], case[7], 2.0, general=True)
    # determinism: no atomics, the same bits twice, on both kernels
    q, k, v = fa_inputs(gen, 2, 8, 2, 300, 300, 128, torch.bfloat16, dev)
    for fn in (fa_ops.flash_attention, fa_ops._flash_attention_general):
        check(torch.equal(fn(q, k, v, window=100), fn(q, k, v, window=100)),
              "flash_attention: two launches differ")

    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    B, hq, hkv, S, D = (SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads,
                        SERVE_PROMPT, cfg.hd)
    peaked = fa_inputs(gen, B, hq, hkv, S, S, D, torch.bfloat16, dev,
                       FA_QK_SCALES[1])
    err = check_flash(*peaked, True, None, FA_QK_SCALES[1])
    err_general = check_flash(*peaked, True, None, FA_QK_SCALES[1],
                              general=True)
    check(torch.equal(fa_ops.flash_attention(*peaked),
                      fa_ops.flash_attention(*peaked)),
          "flash_attention: two launches differ at the path's shape")
    del peaked
    q, k, v = fa_inputs(gen, B, hq, hkv, S, S, D, torch.bfloat16, dev)
    err = max(err, check_flash(q, k, v, True, None, FA_QK_SCALES[0]))
    err_general = max(err_general, check_flash(
        q, k, v, True, None, FA_QK_SCALES[0], general=True))
    # operations: two products of 2 flops per multiply-add over the
    # S (S + 1) / 2 causal (query, key) pairs; bytes: q, k, v read once,
    # o written once
    flops = 4 * B * hq * D * (S * (S + 1) // 2)
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
    try:    # the library call: PyTorch's fused attention, GQA in place
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
    except TypeError:   # an older PyTorch: K/V repeated outside the timing
        kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kr, vr, is_causal=True)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    kernels = {"flash_attention": lambda: fa_ops.flash_attention(q, k, v),
               "flash_attention_general":
                   lambda: fa_ops._flash_attention_general(q, k, v)}
    # in turns: sm90, general, plain, library, general, sm90
    turns = {name: [] for name in (*kernels, "plain", "library")}
    for name in ("flash_attention", "flash_attention_general"):
        turns[name].append(time_ms(kernels[name], 10))
    turns["plain"].append(time_ms(lambda: attention_ref(q, k, v), 10))
    turns["library"].append(time_ms(library, 10))
    for name in ("flash_attention_general", "flash_attention"):
        turns[name].append(time_ms(kernels[name], 10))
    out = {}
    for name, e in (("flash_attention", err),
                    ("flash_attention_general", err_general)):
        ms = min(turns[name])
        out[name] = {"ms": ms, "plain_ms": turns["plain"][0],
                     "library_ms": turns["library"][0], "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": e}
        emit("lm_kernels", kernel=name, timing_shape=[B, hq, hkv, S, D],
             dtype=str(q.dtype), gflop=flops / 1e9, turns_ms=turns[name],
             achieved_tflop_s=flops / (ms * 1e-3) / 1e12,
             bound_share=b_ms / ms,
             library_tflop_s=flops / (turns["library"][0] * 1e-3) / 1e12,
             **out[name])
    return out


def serve_phase(dev, reset_counts, read_counts) -> dict:
    """granite-3-8b at full width through ServeEngine.generate; returns the
    launches of the generate run, counted from 0 just before it."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving import ServeEngine

    cfg = get_config(LM_ARCH).replace(attn_impl="flash")
    check(cfg.dtype == "bfloat16" and cfg.family == "dense",
          f"{LM_ARCH}: unexpected config {cfg}")
    max_len = SERVE_PROMPT + SERVE_GEN
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = torch.cuda.memory_allocated() / 1e9
    batch = api.make_batch(cfg, SEED, SERVE_BATCH, SERVE_PROMPT, device=dev)
    eng = ServeEngine(cfg, params, max_len=max_len)

    # the main path, launches counted from 0 just before it
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.generate(batch, SERVE_GEN)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["flash_attention"] == cfg.n_layers
          and launches["flash_attention_sm90"] == cfg.n_layers,
          f"serve: {launches} flash launches in one prefill, expected "
          f"{cfg.n_layers}, all on the sm90 route")
    t0 = time.perf_counter()
    again = eng.generate(batch, SERVE_GEN)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(tuple(toks.shape) == (SERVE_BATCH, SERVE_GEN)
          and toks.dtype == torch.int32, f"serve: tokens {toks.shape}")
    check(torch.equal(toks, again), "serve: two greedy runs differ")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "serve: token id out of range")

    # prefill and decode apart: flash vs the einsum (plain) path, timings
    def prefill(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = api.prefill(c, params, batch, max_len=max_len)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (logits, cache), prefill_ms = prefill(cfg)
    check(tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "serve: prefill logits")
    del cache
    (ref, ref_cache), einsum_ms = prefill(cfg.replace(attn_impl="einsum"))
    del ref_cache
    d = (logits.float() - ref.float())
    rel_l2 = float(torch.linalg.vector_norm(d)
                   / torch.linalg.vector_norm(ref.float()))
    max_rel = float(d.abs().max() / ref.float().abs().max())
    # the two paths round differently inside attention only (P in bf16,
    # the einsum path's f32 softmax); through 40 layers that is ~sqrt(40)
    # half-ulps, ~2.5% of the logits; the gate is 8 bf16 eps = 6.25%
    tol = 8 * torch.finfo(torch.bfloat16).eps
    check(rel_l2 <= tol and max_rel <= tol,
          f"serve: flash vs einsum prefill logits {rel_l2} / {max_rel} > "
          f"{tol}")
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    del ref
    def decode(inplace):
        """ms per decode step over SERVE_GEN steps from a fresh prefill:
        in place, as generate() decodes, or the default functional step
        (a copy of the whole cache per step); and the steps' logits."""
        _, cache = api.prefill(cfg, params, batch, max_len=max_len)
        tok = logits.argmax(-1).to(torch.int32)
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_GEN):
            step_logits, cache = api.decode_step(cfg, params, tok, cache,
                                                 inplace=inplace)
            check(bool(torch.isfinite(step_logits).all()),
                  "serve: decode logits not finite")
            tok = step_logits.argmax(-1).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SERVE_GEN, out

    decode_ms, toks_inplace = decode(True)
    copying_ms, toks_copying = decode(False)
    check(all(torch.equal(a, b) for a, b in zip(toks_inplace, toks_copying)),
          "serve: in-place and functional decode steps differ")
    emit("serve", arch=LM_ARCH, dtype=cfg.dtype, attn_impl=cfg.attn_impl,
         params_b=cfg.param_count() / 1e9, weight_gb=weight_gb,
         init_s=init_s,
         batch=SERVE_BATCH, prompt=SERVE_PROMPT, new_tokens=SERVE_GEN,
         launches=launches, first_generate_s=first_s,
         warm_generate_s=warm_s,
         generated_tok_s=SERVE_BATCH * SERVE_GEN / warm_s,
         prefill_ms=prefill_ms, einsum_prefill_ms=einsum_ms,
         prefill_tok_s=SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
         decode_ms_per_token=decode_ms,
         functional_decode_ms_per_token=copying_ms, peak_mem_gb=peak_gb,
         logits_rel_l2_vs_einsum=rel_l2, logits_max_rel_vs_einsum=max_rel,
         logits_tol=tol, first_token_agree=agree,
         sample=toks[0, :8].tolist())
    del params, eng
    torch.cuda.empty_cache()
    return launches


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
    from repro_torch.kernels.block_sweep import ops as bs_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.imgs_panel import ops as pp_ops
    from repro_torch.kernels.imgs_project import ops as ip_ops

    counters = {"greedy_update": gu_ops, "imgs_project": ip_ops,
                "block_sweep": bs_ops, "imgs_panel": pp_ops,
                "flash_attention": fa_ops}

    # the wrappers that route between two kernels count each route apart
    routed = ("greedy_update", "imgs_project", "imgs_panel",
              "flash_attention")

    def reset_counts():
        for mod in counters.values():
            mod.launches = 0
        for name in routed:
            counters[name].launches_sm90 = counters[name].launches_general = 0

    def read_counts():
        counts = {name: mod.launches for name, mod in counters.items()}
        for name in routed:
            counts[name + "_sm90"] = counters[name].launches_sm90
            counts[name + "_general"] = counters[name].launches_general
        return counts

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

    cols = torch.randperm(M, generator=torch.Generator().manual_seed(SEED))[
        :8192].to(dev)

    def drive(phase, sweeps_with, flagged, path_kernels, sm90_only,
              **spec):
        """One full-width build through the front door, its kernels'
        launches counted from 0 just before it; checks that every launch of
        the kernels in ``sm90_only`` took the sm90 route, orthogonality and
        the error on 8192 sampled columns; emits the phase line, with the
        sweeps (launches of ``sweeps_with``) that read S: with ``flagged``
        (the sweep takes the driver's active flag) those of the live
        steps."""
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b = build_basis(source=S, tau=TAU, max_k=MAX_K, chunk=16, **spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        k = b.k
        check(all(launches[n] > 0 for n in path_kernels),
              f"{phase}: a kernel of the path was not launched: {launches}")
        check(all(launches[n + "_sm90"] == launches[n]
                  and launches[n + "_general"] == 0 for n in sm90_only),
              f"{phase}: a launch of {sm90_only} left the sm90 route: "
              f"{launches}")
        check(5 <= k <= MAX_K and np.all(np.isfinite(b.errs)),
              f"{phase}: bad rank {k}")
        eps = torch.finfo(torch.float32).eps
        Q64 = b.Q.to(torch.complex128)
        defect = float(torch.linalg.matrix_norm(
            Q64.mH @ Q64 - torch.eye(k, dtype=Q64.dtype, device=dev),
            ord=2))
        defect_bound = 100 * 2.0 * eps * math.sqrt(k)
        check(defect <= defect_bound,
              f"{phase}: orthogonality {defect} > {defect_bound}")
        pce = float(per_column_errors(S.index_select(1, cols), b.Q).max())
        last = float(b.errs[-1])
        check(pce <= 1.5 * last,
              f"{phase}: per-column error {pce} > 1.5 * {last}")
        # the sweeps that read S: with ``flagged`` those of the steps up to
        # the latched stop (the later steps' flags are false), k plus the
        # latched step whose basis a rank or tau stop drops; else all
        read = launches[sweeps_with]
        if flagged:
            read = k + (b.provenance["stop"] in ("STOP_RANK", "STOP_TAU"))
        emit(phase, k=k, stop=b.provenance["stop"], tau=TAU,
             block_p=b.provenance["block_p"], wall_s=wall,
             s_per_basis=wall / k, sweeps_launched=launches[sweeps_with],
             sweeps_read_s=read,
             swept_gb_s=read * S.nbytes / wall / 1e9,
             launches=launches, orthogonality=defect,
             orthogonality_bound=defect_bound, max_sampled_col_err=pce,
             last_err=last, col_err_bound=1.5 * last,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             backend=b.provenance["backend"],
             device=b.provenance["device"])
        return b, launches

    # --- the greedy path: build_basis at full width
    basis, launches = drive("build_basis", "greedy_update", True,
                            ("greedy_update", "imgs_project"),
                            ("greedy_update", "imgs_project"),
                            strategy="greedy")
    k = basis.k

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

    # --- the blocked path: the greedy basis freed first
    del basis, back, omega, interp
    torch.cuda.empty_cache()
    blk, blk_launches = drive("block_build", "block_sweep", False,
                              ("block_sweep", "imgs_panel", "imgs_project"),
                              ("imgs_panel", "imgs_project"),
                              strategy="block_greedy", block_p=BLOCK_P)
    # pivot staleness costs at most ~15% more bases (the reference's
    # bound, tests/test_block_greedy.py) plus one block of headroom
    check(5 <= blk.k <= int(1.15 * k) + BLOCK_P,
          f"block_build: k {blk.k} outside [5, 1.15 * {k} + {BLOCK_P}]")
    check(blk.provenance["block_p"] == BLOCK_P,
          f"block_build: provenance block_p {blk.provenance['block_p']}")
    del blk, S, cols
    torch.cuda.empty_cache()

    # --- the dense-LM serving path, with the GW S freed
    timings.update(lm_kernel_phase(dev))
    serve_launches = serve_phase(dev, reset_counts, read_counts)

    # one entry per kernel; a wrapper that routes between two kernels has
    # an entry for each, which counts its own route's launches
    kernels = []
    for name, src, replaces, path, key in (
            ("greedy_update", "src/repro_torch/csrc/greedy_update_sm90.cu",
             "src/repro/kernels/greedy_update/kernel.py:108,147", launches,
             "greedy_update_sm90"),
            ("greedy_update_general", "src/repro_torch/csrc/greedy_update.cu",
             "src/repro/kernels/greedy_update/kernel.py:108,147", launches,
             "greedy_update_general"),
            ("imgs_project", "src/repro_torch/csrc/imgs_project_sm90.cu",
             "src/repro/kernels/imgs_project/kernel.py:67", launches,
             "imgs_project_sm90"),
            ("imgs_project_general", "src/repro_torch/csrc/imgs_project.cu",
             "src/repro/kernels/imgs_project/kernel.py:67", launches,
             "imgs_project_general"),
            ("block_sweep", "src/repro_torch/csrc/block_sweep.cu",
             "src/repro/kernels/block_sweep/kernel.py:86,119", blk_launches,
             "block_sweep"),
            ("imgs_panel", "src/repro_torch/csrc/imgs_panel_sm90.cu",
             "src/repro/kernels/imgs_panel/kernel.py:76", blk_launches,
             "imgs_panel_sm90"),
            ("imgs_panel_general", "src/repro_torch/csrc/imgs_panel.cu",
             "src/repro/kernels/imgs_panel/kernel.py:76", blk_launches,
             "imgs_panel_general"),
            ("flash_attention", "src/repro_torch/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention/kernel.py:96",
             serve_launches, "flash_attention_sm90"),
            ("flash_attention_general",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:96",
             serve_launches, "flash_attention_general")):
        t = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": path[key],
                        "counter": key,
                        "launches_by_path": {
                            "greedy": launches[key],
                            "block_greedy": blk_launches[key],
                            "serve": serve_launches[key]},
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
