"""Where the time of the streamed GW build goes, on one GPU.

    python3 tools/profile_torch_streamed.py [--n-mc 12800] [--bases 6] \
        [--block-p 1] [--trace PATH]

Streams the chirp grid of ``chip_smoke.py``'s streamed cell (N = 10,000,
complex64, f 40-1024 Hz; ``--n-mc`` x 256 mass pairs: 12,800 gives the
paper's M = 3,276,800) through ``build_basis(strategy="streamed")`` in
tiles of 65,536 columns, the first ``--bases`` bases only (every sweep
reads all of S, so a few sweeps show the steady state).  One untraced
build, then one under ``torch.profiler``; prints one JSON line with the
walls, s per sweep, the traced build's device busy share (union of kernel
intervals over its wall time), kernel time by name (the generator
``taylorf2`` beside the sweep and the GS passes) and the host syncs.  The
Chrome trace is kept at ``--trace PATH`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-mc", type=int, default=12_800)
    ap.add_argument("--bases", type=int, default=6)
    ap.add_argument("--block-p", type=int, default=1)
    ap.add_argument("--trace", default=None,
                    help="keep the Chrome trace at this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_streamed: no CUDA device")
    import chip_smoke as cs
    from profile_torch_build import kernel_stats
    from repro_torch.api import ReductionSpec, build_basis
    from repro_torch.gw import chirp_grid, frequency_grid
    from repro_torch.kernels import _build

    _build.build_all()
    f = frequency_grid(cs.F_MIN, cs.F_MAX, cs.N)
    m1, m2 = chirp_grid(n_mc=args.n_mc, n_eta=cs.N_ETA)
    spec = ReductionSpec.waveform(
        f, m1, m2, strategy="streamed", tau=cs.TAU, max_k=args.bases,
        tile_m=cs.STREAM_TILE, block_p=args.block_p, keep_R=False,
        device="cuda")

    def build():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = build_basis(spec)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t0

    _, first_s = build()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        b, traced_s = build()
    with tempfile.TemporaryDirectory() as tmp:
        trace = args.trace or os.path.join(tmp, "trace.json")
        if os.path.dirname(trace):
            os.makedirs(os.path.dirname(trace), exist_ok=True)
        prof.export_chrome_trace(trace)
        stats = kernel_stats(trace, traced_s * 1e6)
    pv = b.provenance
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "M": len(m1), "N": cs.N,
        "tile_m": cs.STREAM_TILE, "block_p": args.block_p, "k": b.k,
        "stop": pv["stop"], "passes": pv["passes"], "sweeps": pv["sweeps"],
        "first_build_s": first_s, "traced_build_s": traced_s,
        "s_per_pass_traced": traced_s / pv["passes"], **stats}), flush=True)


if __name__ == "__main__":
    main()
