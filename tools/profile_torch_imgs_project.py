"""Where the time of one ``imgs_project`` pass on the sm90 route goes, on
one GPU.

    python3 tools/profile_torch_imgs_project.py [--reps 30]

Builds a copy of ``src/repro_torch/csrc/imgs_project_sm90.cu`` with
``%globaltimer`` stamps at the phase boundaries of each CTA (kernel start,
slab copied, partial written, past the grid barrier, fold done, update
done) into ``.kernel_build/``, runs it at the greedy path's shape (N =
10,000, K = max_k = 100, complex64, the basis half filled, as
``chip_smoke.py`` times it) and prints one JSON line: the CUDA-event time
of the call (a spin kernel queued first, so the card's time alone), the
SM clock during the kernel (``clock64`` over ``%globaltimer``) and, per
phase, the latest CTA's end in us from the earliest CTA's start.  The
best of ``--reps`` calls is kept.  Beside it, timed the same way: the
uninstrumented pass with a false active flag (``masked_us``) and a
one-element ``add_`` (``floor_us``, what any launch costs measured so).
The timer ticks in steps of a few hundred ns.  A stamp anchor that the
kernel source no longer has stops the script: update ``STAMPS`` with the
kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("start", "copied", "partial", "barrier", "fold", "update")
OFFSET = 1 << 19   # bytes into the scratch buffer where the stamps go

STAMP_FN = """__device__ __forceinline__ void stamp(void* scratch, int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    long long* s = reinterpret_cast<long long*>(
        static_cast<char*>(scratch) + %d) + blockIdx.x * 8;
    s[i] = (long long)t;
    if (i == 0 || i == 5) s[6 + (i == 5)] = clock64();
  }
}

""" % OFFSET

# (anchor in the kernel source, the same text with a stamp)
STAMPS = [
    ("template <typename R, bool CPLX>\n__global__ void __launch_bounds__"
     "(THREADS, 1)\n    project(",
     STAMP_FN + "template <typename R, bool CPLX>\n__global__ void "
     "__launch_bounds__(THREADS, 1)\n    project("),
    ("  if (active != nullptr && !*active) {  // the same in every CTA",
     "  stamp(scratch, 0);\n"
     "  if (active != nullptr && !*active) {  // the same in every CTA"),
    ("    wait_copies();\n    project_rows",
     "    wait_copies();\n    stamp(scratch, 1);\n    project_rows"),
    ("  grid_barrier(bar);\n",
     "  stamp(scratch, 2);\n  grid_barrier(bar);\n  stamp(scratch, 3);\n"),
    ("  if (blockIdx.x == 0)\n    for (int k = threadIdx.x; k < K; "
     "k += THREADS) c[k] = cs[k];\n",
     "  stamp(scratch, 4);\n  if (blockIdx.x == 0)\n    for (int k = "
     "threadIdx.x; k < K; k += THREADS) c[k] = cs[k];\n"),
    ("    update_rows<R, CPLX>(q, rows, K, cs, vs, v_out + r0);\n  }\n}",
     "    update_rows<R, CPLX>(q, rows, K, cs, vs, v_out + r0);\n  }\n"
     "  __syncthreads();\n  stamp(scratch, 5);\n}"),
]


def build_instrumented() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "imgs_project_sm90.cu").read_text()
    for anchor, stamped in STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"profile_torch_imgs_project: anchor not found "
                             f"once in the kernel: {anchor!r}")
        src = src.replace(anchor, stamped)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "imgs_project_sm90_stamped.cu"
    so = _build.BUILD_DIR / "libimgs_project_sm90_stamped.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    fn = lib.imgs_project_sm90_c64
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_imgs_project: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels.common import (
        barrier_counter, ptr, scratch_buffer, stream_ptr,
    )
    from repro_torch.kernels.imgs_project import ops as ip_ops
    from repro_torch.kernels.imgs_project.ref import imgs_project_ref

    fn = build_instrumented()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    N, K, dtype = cs.N, cs.MAX_K, torch.complex64
    Q = torch.zeros((N, K), dtype=dtype, device=dev)
    Q[:, :K // 2] = torch.linalg.qr(cs.rand(gen, (N, K // 2), dtype, dev))[0]
    v = cs.rand(gen, (N,), dtype, dev)
    c = torch.empty(K, dtype=dtype, device=dev)
    v_out = torch.empty(N, dtype=dtype, device=dev)
    stream = stream_ptr(dev)
    rows, ctas, T = ip_ops.plan(
        N, K, dtype.itemsize,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = scratch_buffer(dev, stream, OFFSET + ctas * 64)
    bar = barrier_counter(dev, stream)
    best = None
    for _ in range(args.reps):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(ptr(v), ptr(Q), None, ptr(c), ptr(v_out), ptr(scratch),
                 ptr(bar), N, K, rows, T, stream)
        end.record()
        end.synchronize()
        if err:
            raise SystemExit(f"profile_torch_imgs_project: launch error {err}")
        s = scratch[OFFSET:OFFSET + ctas * 64].view(torch.int64).view(
            ctas, 8).cpu().double()
        t0 = s[:, 0].min()
        line = {"call_us": start.elapsed_time(end) * 1e3,
                "sm_mhz": float(((s[:, 7] - s[:, 6])
                                 / (s[:, 5] - s[:, 0])).median() * 1e3)}
        line.update({f"{p}_us": float((s[:, i] - t0).max() / 1e3)
                     for i, p in enumerate(PHASES)})
        if best is None or line["call_us"] < best["call_us"]:
            best = line
    off = torch.zeros((), dtype=torch.bool, device=dev)
    one = torch.zeros(1, device=dev)
    best["masked_us"] = cs.time_ms(lambda: ip_ops.imgs_project(v, Q, off),
                                   args.reps) * 1e3
    best["floor_us"] = cs.time_ms(lambda: one.add_(1), args.reps) * 1e3
    vr, cr = imgs_project_ref(v, Q)
    best["max_abs_err"] = max(float((v_out - vr).abs().max()),
                              float((c - cr).abs().max()))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shape": [N, K], "dtype": str(dtype), "ctas": ctas,
                      "rows_per_cta": rows, **best}), flush=True)


if __name__ == "__main__":
    main()
