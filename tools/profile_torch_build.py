"""Where the time of the port's full-width builds goes, on one GPU.

    python3 tools/profile_torch_build.py [--strategy block_greedy] \
        [--trace PATH]

Builds the same GW snapshot matrix as ``chip_smoke.py`` (N = 10,000,
M = 131,072, complex64), runs ``build_basis(strategy=...)`` (``greedy``,
``block_greedy`` at the smoke's block_p, ``batched``: the smoke's tau sweep
of 8 lanes over S above its floor, or ``batched_bands``: its band split of S into 8
stacked lanes at tau 1e-4) twice
untraced (cold, then warm) and once under ``torch.profiler``, and prints one
JSON line with the kernels' build time, the first (cold) and second
(warm) build times, the traced build's device busy share (union of kernel
intervals over the build's wall time), kernel time by name, the launches
of each kernel that took 1 ms or more (a sweep that read S), and the host
syncs seen (``cudaStreamSynchronize`` / memory copies).  The Chrome
trace is kept at ``--trace PATH`` when given.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def kernel_stats(trace_path: str, wall_us: float) -> dict:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = collections.Counter()
    long_by_name = collections.Counter()
    for e in kernels:
        by_name[e["name"][:60]] += e["dur"]
        if e["dur"] >= 1000:
            long_by_name[e["name"][:60]] += 1
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, -1.0
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    runtime = collections.Counter(
        e["name"] for e in events if e.get("cat") == "cuda_runtime")
    syncs = {k: v for k, v in runtime.items()
             if "Synchronize" in k or "Memcpy" in k}
    return {"kernels": len(kernels), "busy_us": busy,
            "busy_share": busy / wall_us,
            "top_kernels_us": dict(by_name.most_common(12)),
            "launches_over_1ms": dict(long_by_name),
            "sync_calls": syncs}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="keep the Chrome trace at this path")
    ap.add_argument("--strategy", default="greedy",
                    choices=("greedy", "block_greedy", "batched",
                             "batched_bands"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_build: no CUDA device")
    import chip_smoke as cs
    from repro_torch.api import build_basis
    from repro_torch.gw import build_snapshot_matrix, chirp_grid
    from repro_torch.gw import frequency_grid
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    build_kernels_s = time.perf_counter() - t0
    S = build_snapshot_matrix(
        frequency_grid(cs.F_MIN, cs.F_MAX, cs.N),
        *chirp_grid(n_mc=cs.N_MC, n_eta=cs.N_ETA), device="cuda")

    block_p = cs.BLOCK_P if args.strategy == "block_greedy" else 1
    strategy, source, tau = args.strategy, S, cs.TAU
    if strategy == "batched":
        # the smoke's sweep: taus between the greedy build's last errors
        tau = cs.sweep_taus(build_basis(
            source=S, strategy="greedy", tau=cs.TAU, max_k=cs.MAX_K,
            chunk=16).errs, cs.BATCH)
    elif strategy == "batched_bands":
        from repro_torch.data import band_split

        strategy, source = "batched", band_split(S, cs.BATCH)

    def build():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = build_basis(source=source, strategy=strategy, tau=tau,
                        max_k=cs.MAX_K, chunk=16, block_p=block_p)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t0

    _, first_s = build()
    again, again_s = build()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, traced_s = build()
    with tempfile.TemporaryDirectory() as tmp:
        trace = args.trace or os.path.join(tmp, "trace.json")
        if os.path.dirname(trace):
            os.makedirs(os.path.dirname(trace), exist_ok=True)
        prof.export_chrome_trace(trace)
        stats = kernel_stats(trace, traced_s * 1e6)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "strategy": args.strategy, "block_p": block_p,
        "k": [c.k for c in again] if strategy == "batched" else again.k,
        **({"lockstep": again.provenance["lockstep"]}
           if strategy == "batched" else {}),
        "build_kernels_s": build_kernels_s,
        "first_build_s": first_s, "warm_build_s": again_s,
        "traced_build_s": traced_s, **stats}), flush=True)


if __name__ == "__main__":
    main()
