"""Where the time of a normalized ``taylorf2_tile`` on the sm90 route goes,
on one GPU.

    python3 tools/profile_torch_taylorf2.py [--reps 5] [--variant C,T,U]

Builds a copy of ``src/repro_torch/csrc/taylorf2_sm90.cu`` with
``%globaltimer`` stamps at the phase boundaries of each CTA (start; its
elements evaluated into the slab and folded over each warp; past the
cluster wait, every CTA of the cluster evaluated; past the cluster
barrier, the sums exchanged; the scales known; its slab stored) and the SM
it ran on, into
``.kernel_build/``, runs it on a (10,000 x 65,536) complex64 tile of the
paper's grid (the streamed path's tile, normalized) and prints one JSON
line: the CUDA-event time of the call, the SM clock during the kernel
(``clock64`` over ``%globaltimer``), the median and mean of each phase
over the CTAs, and the share of the kernel's span in which each SM had at
least one CTA evaluating (the float64 pipe's work).  The call with the
best time of ``--reps`` is kept.  ``--variant`` picks the cluster's
columns C, the threads of a CTA (the copy is built with that count) and
the unroll of the row loop (default: the plan's).  A stamp anchor that the kernel source no longer
has stops the script: update ``STAMPS`` with the kernel.
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

PHASES = ("evaluate", "cluster_wait", "exchange", "scale", "store")

STAMP_FN = """__device__ long long* g_stamps;
extern "C" int taylorf2_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[blockIdx.x * 10 + i] = (long long)t;
    if (i == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      g_stamps[blockIdx.x * 10 + 7] = sm;
    }
    if (i == 0 || i == 5)
      g_stamps[blockIdx.x * 10 + 8 + (i == 5)] = clock64();
  }
}

"""

# (anchor in the kernel source, the same text with a stamp)
STAMPS = [
    ("namespace {\n\nconstexpr int MAX_C",
     STAMP_FN + "namespace {\n\nconstexpr int MAX_C"),
    ("  repro::tf2::ColTerms c{};\n",
     "  stamp(0);\n  repro::tf2::ColTerms c{};\n"),
    ("  if (lane < C) warp_sums[warp][lane] = acc;\n  __syncthreads();\n",
     "  if (lane < C) warp_sums[warp][lane] = acc;\n  __syncthreads();\n"
     "  stamp(1);\n"),
    ("  cluster_wait();\n", "  cluster_wait();\n  stamp(2);\n"),
    ("  cluster.sync();  // every CTA's sums are in every inbox\n",
     "  cluster.sync();  // every CTA's sums are in every inbox\n"
     "  stamp(3);\n"),
    ("    scale[threadIdx.x] = (R)(1.0 / sqrt(v[0]));\n  }\n"
     "  __syncthreads();\n",
     "    scale[threadIdx.x] = (R)(1.0 / sqrt(v[0]));\n  }\n"
     "  __syncthreads();\n  stamp(4);\n"),
    ("    *o = scaled(slab[i * C + j], sc);\n}",
     "    *o = scaled(slab[i * C + j], sc);\n  stamp(5);\n}"),
]


def build_instrumented(threads: int):
    from repro_torch.kernels import _build
    from repro_torch.kernels.taylorf2 import ops as tf_ops

    src = (_build.CSRC / "taylorf2_sm90.cu").read_text()
    stamps = STAMPS + [(f"constexpr int THREADS = {tf_ops.THREADS};",
                        f"constexpr int THREADS = {threads};")]
    for anchor, stamped in stamps:
        if src.count(anchor) != 1:
            raise SystemExit(f"profile_torch_taylorf2: anchor not found once "
                             f"in the kernel: {anchor!r}")
        src = src.replace(anchor, stamped)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "taylorf2_sm90_stamped.cu"
    so = _build.BUILD_DIR / "libtaylorf2_sm90_stamped.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   stdout=subprocess.DEVNULL)
    return ctypes.CDLL(str(so))


def eval_share(s: torch.Tensor, span: float) -> float:
    """Mean over the SMs of the share of the kernel's span in which at
    least one of the SM's CTAs was evaluating (stamps 0 to 1)."""
    by_sm: dict = {}
    for a, b, sm in zip(s[:, 0].tolist(), s[:, 1].tolist(),
                        s[:, 7].tolist()):
        by_sm.setdefault(int(sm), []).append((a, b))
    shares = []
    for spans in by_sm.values():
        busy, end = 0.0, -math.inf
        for a, b in sorted(spans):
            if b > end:
                busy += b - max(a, end)
                end = b
        shares.append(busy / span)
    return sum(shares) / len(shares)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variant", default=None,
                    help="C,threads,unroll of the sm90 kernel")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_taylorf2: no CUDA device")
    from repro_torch.gw import WaveformGrid, chirp_grid, frequency_grid
    from repro_torch.kernels.common import ptr, stream_ptr
    from repro_torch.kernels.taylorf2 import ops as tf_ops

    N, w, dtype = 10_000, 65_536, torch.complex64
    G, rows_cta = tf_ops.plan(N, dtype)
    (C, unroll), threads = tf_ops.LAUNCH[dtype, True], tf_ops.THREADS
    if a.variant:
        C, threads, unroll = (int(x) for x in a.variant.split(","))
    lib = build_instrumented(threads)
    dev = torch.device("cuda", 0)
    g = WaveformGrid(frequency_grid(40.0, 1024.0, N),
                     *chirp_grid(n_mc=512, n_eta=256), dtype=dtype,
                     device=dev)
    out = torch.empty((N, w), dtype=dtype, device=dev)
    ctas = -(-w // C) * G
    stamps = torch.zeros((ctas, 10), dtype=torch.int64, device=dev)
    if lib.taylorf2_set_stamps(ctypes.c_void_p(stamps.data_ptr())):
        sys.exit("profile_torch_taylorf2: cannot set the stamp buffer")
    fn = lib.taylorf2_tile_sm90_c64
    fn.argtypes = tf_ops._LIBS["sm90"][1]["taylorf2_tile_sm90_c64"][0]
    fn.restype = ctypes.c_int
    best = None
    for _ in range(a.reps):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(ptr(g.rows), ptr(g.cols), N, g.shape[1], 0, w, w, 1,
                 ptr(out), C, rows_cta, unroll, stream_ptr(dev))
        end.record()
        end.synchronize()
        if err:
            sys.exit(f"profile_torch_taylorf2: launch error {err}")
        s = stamps.cpu().double()
        t0, span = s[:, 0].min(), s[:, 5].max() - s[:, 0].min()
        d = s[:, 1:6] - s[:, 0:5]
        line = {"call_ms": start.elapsed_time(end),
                "sm_mhz": float(((s[:, 9] - s[:, 8])
                                 / (s[:, 5] - s[:, 0])).median() * 1e3),
                "span_ms": float(span / 1e6),
                "cta_life_us_median": float((s[:, 5] - s[:, 0]).median()
                                            / 1e3),
                "evaluating_share_of_span": eval_share(s - t0, float(span))}
        for i, p in enumerate(PHASES):
            line[f"{p}_us_median"] = float(d[:, i].median() / 1e3)
            line[f"{p}_us_mean"] = float(d[:, i].mean() / 1e3)
        if best is None or line["call_ms"] < best["call_ms"]:
            best = line
    ref = tf_ops._taylorf2_tile_general(g.rows, g.cols, 0, w, True, dtype)
    best["max_abs_err_general"] = float((out - ref).abs().max())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shape": [N, w], "dtype": str(dtype), "G": G, "C": C,
                      "threads": threads, "unroll": unroll, "ctas": ctas,
                      **best}), flush=True)


if __name__ == "__main__":
    main()
