"""Wall times of the port's full-width builds, untraced, on one GPU.

    python3 tools/time_torch_builds.py [--warm 3] [--strategy greedy ...]

Builds the same GW snapshot matrix as ``chip_smoke.py`` (N = 10,000,
M = 131,072, complex64) once, then runs ``build_basis`` for each strategy
(``greedy``, and ``block_greedy`` at the smoke's block_p) once cold and
``--warm`` times warm, and prints one JSON line per strategy: the cold
time, every warm time, their median, k and the stop code.  ``init`` times
the resident builds' init pass alone (``core.greedy._column_norms_sq``,
the column norms of S) the same way.  It reads only
the checkout it sits in, so a copy placed in another checkout times that
one: two commits compare on one card by running each checkout's copy in
turns.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--strategy", nargs="+",
                    default=["init", "greedy", "block_greedy"],
                    choices=("init", "greedy", "block_greedy"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_torch_builds: no CUDA device")
    import chip_smoke as cs
    from repro_torch.api import build_basis
    from repro_torch.core.greedy import _column_norms_sq
    from repro_torch.gw import build_snapshot_matrix, chirp_grid
    from repro_torch.gw import frequency_grid
    from repro_torch.kernels import _build

    _build.build_all()
    S = build_snapshot_matrix(
        frequency_grid(cs.F_MIN, cs.F_MAX, cs.N),
        *chirp_grid(n_mc=cs.N_MC, n_eta=cs.N_ETA), device="cuda")

    for strategy in args.strategy:
        block_p = cs.BLOCK_P if strategy == "block_greedy" else 1

        def build():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if strategy == "init":
                b = _column_norms_sq(S)
            else:
                b = build_basis(source=S, strategy=strategy, tau=cs.TAU,
                                max_k=cs.MAX_K, chunk=16, block_p=block_p)
            torch.cuda.synchronize()
            return b, time.perf_counter() - t0

        _, cold = build()
        warm = []
        for _ in range(args.warm):
            b, t = build()
            warm.append(t)
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "strategy": strategy,
            "block_p": block_p,
            **({} if strategy == "init" else {
                "k": b.k, "stop": b.provenance["stop"]}),
            "cold_s": cold, "warm_s": warm,
            "warm_median_s": statistics.median(warm)}), flush=True)


if __name__ == "__main__":
    main()
