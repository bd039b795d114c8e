"""Plans of the sm90 kernels of ``roq_apply`` and ``taylorf2_tile`` timed on
one GPU, each held against the general kernel.

    python3 tools/tune_torch_sm90_plans.py [--reps 30] [--out FILE]

``roq_apply``: at the GW basis (N 10,000, k 83, random B and F from seed 0)
in complex64 and complex128, for each bucket 1, 2, 4, ..., 128: the plan
of ``kernels/roq_apply/ops.py::plan`` and the other register tiles and CTA
heights the kernel is built for, each checked bitwise against the general
kernel (a plan never changes what an output sums, or in what order), timed
beside the general kernel and ``torch.matmul``.

``taylorf2_tile``: a (10,000 x 65,536) tile of the paper's grid (f 40-1024
Hz, the 512 x 256 chirp grid), normalized and not, complex64 and
complex128: the general kernel and the sm90 kernel at each cluster width
(C columns), threads a CTA and unroll whose slab fits; unnormalized
bitwise the general kernel, normalized within 10 eps sqrt(N) of it.  The
kernel's CTA is ``THREADS`` (256) threads; for another count the tool
builds its own copy of ``csrc/taylorf2_sm90.cu`` into ``.kernel_build/``.

Times are CUDA events, best of ``--reps``, a spin kernel queued before the
start event (the card's time alone).  One JSON line per case, also written
to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

N, K = 10_000, 83
TILE = 65_536
# the register tiles (rows x columns a thread) roq_apply_sm90.cu is built for
TILES = ((1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (2, 4), (4, 1), (4, 2),
         (4, 4))


def time_ms(fn, reps):
    fn()
    best = math.inf
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def rand(gen, shape, dtype, dev):
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(shape, generator=gen,
                                         dtype=torch.float64))
    return x.to(dtype).to(dev)


def roq_plans(nb, isz, sm):
    """The default plan first, then every other (rr, cc, ty) the kernel is
    built for, at CTA heights of one and two CTAs an SM."""
    from repro_torch.kernels.roq_apply import ops

    default = ops.plan(N, K, nb, isz, sm)
    out = [default]
    fit = (ops.SMEM_BUDGET - ops.smem_bytes(K, nb, 0, isz)) // (K * isz)
    for rr, cc in TILES:
        tx = -(-nb // cc)
        if tx > ops.MAX_THREADS:
            continue
        for rows in (-(-N // sm), -(-N // (2 * sm))):
            ty = min(-(-rows // rr), ops.MAX_THREADS // tx, fit // rr)
            p = (rr, cc, tx, ty)
            if ty >= 1 and p not in out:
                out.append(p)
    return out


def roq_phase(dev, reps, emit):
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import ptr, stream_ptr
    from repro_torch.kernels.roq_apply import ops

    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    lib = _build.load(*ops._LIBS["sm90"])
    for dtype in (torch.complex64, torch.complex128):
        sfx = {torch.complex64: "c64", torch.complex128: "c128"}[dtype]
        B = rand(gen, (N, K), dtype, dev)
        for nb in (1, 2, 4, 8, 16, 32, 64, 128):
            F = rand(gen, (K, nb), dtype, dev)
            ref = ops._roq_apply_general(B, F)
            row = {"kernel": "roq_apply", "dtype": str(dtype), "N": N,
                   "k": K, "nb": nb,
                   "route": ops.kernel_route(dtype, K, nb),
                   "general_ms": time_ms(
                       lambda: ops._roq_apply_general(B, F), reps),
                   "matmul_ms": time_ms(lambda: torch.matmul(B, F), reps),
                   "plans": []}
            for rr, cc, tx, ty in roq_plans(nb, dtype.itemsize, sm):
                out = torch.empty((N, nb), dtype=dtype, device=dev)
                aligned = int(rr * ty * K * dtype.itemsize % 16 == 0)

                def call():
                    err = getattr(lib, f"roq_apply_sm90_{sfx}")(
                        ptr(B), ptr(F), ptr(out), N, K, nb, rr, cc, tx, ty,
                        aligned, stream_ptr(dev))
                    assert err == 0, err

                call()
                torch.cuda.synchronize()
                row["plans"].append({
                    "rr": rr, "cc": cc, "tx": tx, "ty": ty,
                    "aligned": aligned, "ctas": -(-N // (rr * ty)),
                    "bitwise_general": bool(torch.equal(out, ref)),
                    "ms": time_ms(call, reps)})
            emit(row)


def taylorf2_variants(dtype):
    """Columns of a cluster C, threads a CTA and the unroll of the row
    loop."""
    cs = (4, 8, 16) if dtype == torch.complex64 else (2, 4, 8)
    return [{"C": C, "threads": threads, "unroll": unroll}
            for C in cs for threads in (256, 512) for unroll in (1, 2)]


def taylorf2_lib(threads):
    """The sm90 generator's library with ``threads`` a CTA: the package's
    own for its THREADS, else a copy of the source built with that
    count."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.taylorf2 import ops

    name, signatures = ops._LIBS["sm90"]
    if threads == ops.THREADS:
        return _build.load(name, signatures)
    anchor = f"constexpr int THREADS = {ops.THREADS};"
    src = (_build.CSRC / f"{name}.cu").read_text()
    if src.count(anchor) != 1:
        raise SystemExit(f"tune_torch_sm90_plans: {anchor!r} not found once "
                         f"in the kernel")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"{name}_t{threads}.cu"
    so = _build.BUILD_DIR / f"lib{name}_t{threads}.so"
    cu.write_text(src.replace(anchor, f"constexpr int THREADS = {threads};"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def taylorf2_phase(dev, reps, emit):
    from repro_torch.gw import WaveformGrid, chirp_grid, frequency_grid
    from repro_torch.kernels.common import ptr, stream_ptr
    from repro_torch.kernels.taylorf2 import ops

    libs = {t: taylorf2_lib(t) for t in (256, 512)}

    f = frequency_grid(40.0, 1024.0, N)
    m1, m2 = chirp_grid(n_mc=512, n_eta=256)
    for dtype in (torch.complex64, torch.complex128):
        sfx = {torch.complex64: "c64", torch.complex128: "c128"}[dtype]
        g = WaveformGrid(f, m1, m2, dtype=dtype, device=dev)
        out = torch.empty((N, TILE), dtype=dtype, device=dev)
        eps = torch.finfo(dtype.to_real()).eps
        for normalize in (False, True):
            args = (g.rows, g.cols, 0, TILE, normalize, dtype)
            ref = ops._taylorf2_tile_general(*args).clone()
            row = {"kernel": "taylorf2_tile", "dtype": str(dtype),
                   "shape": [N, TILE], "normalize": normalize,
                   "route": ops.kernel_route(N, dtype),
                   "plan": ops.plan(N, dtype),
                   "general_ms": time_ms(
                       lambda: ops._taylorf2_tile_general(*args, out=out),
                       reps), "clusters": []}
            for v in taylorf2_variants(dtype):
                if ops.smem_bytes(N, dtype, v["C"]) > ops.SMEM_BUDGET:
                    continue

                fn = getattr(libs[v["threads"]], f"taylorf2_tile_sm90_{sfx}")
                _, rows_cta = ops.plan(N, dtype)

                def call():
                    return fn(ptr(g.rows), ptr(g.cols), N, g.shape[1], 0,
                              TILE, TILE, int(normalize), ptr(out), v["C"],
                              rows_cta, v["unroll"], stream_ptr(dev))

                e = call()
                torch.cuda.synchronize()
                if e:
                    row["clusters"].append({**v, "error": e})
                    continue
                err = float((out - ref).abs().max())
                row["clusters"].append({
                    **v, "smem": ops.smem_bytes(N, dtype, v["C"]),
                    "bitwise_general": bool(torch.equal(out, ref)),
                    "max_abs_err_general": err,
                    "tol": 10 * eps * math.sqrt(N),
                    "ms": time_ms(call, reps)})
            emit(row)
        del g, out, ref
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--only", choices=("roq_apply", "taylorf2_tile"),
                    default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tune_torch_sm90_plans: no CUDA device")
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    reports = _build.build_all(("roq_apply", "roq_apply_sm90", "taylorf2",
                                "taylorf2_sm90"))
    fh = open(a.out, "w") if a.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if fh:
            fh.write(line + "\n")

    try:
        emit({"card": smi, "ptxas": {
            n: [ln.strip() for ln in r.splitlines()
                if "registers" in ln or "spill" in ln or "error" in ln]
            for n, r in reports.items()}})
        if a.only != "taylorf2_tile":
            roq_phase(dev, a.reps, emit)
        if a.only != "roq_apply":
            taylorf2_phase(dev, a.reps, emit)
    finally:
        if fh:
            fh.close()


if __name__ == "__main__":
    main()
