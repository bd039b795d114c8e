"""Distributed greedy reduction over ranks of one host (the port).

The port's counterpart of ``examples/distributed_greedy_demo.py``: the
paper's Sec. 6 system end to end — S split by column over 4 ranks, each
rank generating only its own TaylorF2 columns, the pivot exchanged with an
all_reduce, the basis orthogonalized on every rank — beside the serial
build of the same matrix.

Run:  PYTHONPATH=src python examples/torch_distributed_greedy.py
          # the 4 ranks share the card, over gloo
      PYTHONPATH=src python examples/torch_distributed_greedy.py \\
          --device cpu      # the 4 ranks on the CPU, over gloo
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _rank(n_freq, n_mc, n_eta, tau, device):
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.api import build_basis, make_auto_mesh
    from repro_torch.core.errors import proj_error_max
    from repro_torch.data.providers import WaveformProvider
    from repro_torch.gw import build_snapshot_matrix, chirp_grid
    from repro_torch.gw import frequency_grid

    world, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device(device) if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    f = frequency_grid(20.0, 512.0, n_freq)
    m1, m2 = chirp_grid(n_mc=n_mc, n_eta=n_eta)
    # the build materializes only this rank's columns of the provider
    prov = WaveformProvider(f, m1, m2, dtype=torch.complex128, device=dev)
    mesh = make_auto_mesh((world,), ("cols",), dev.type)
    t0 = time.perf_counter()
    # one front door: a mesh flips strategy="auto" to "distributed"
    basis = build_basis(source=prov, tau=tau, mesh=mesh, device=dev)
    wall = time.perf_counter() - t0
    if rank != 0:
        return None
    S = build_snapshot_matrix(f, m1, m2, dtype=torch.complex128, device=dev)
    ser = build_basis(source=S, strategy="greedy", tau=tau, device=dev)
    kk = min(ser.k, basis.k)  # the shared prefix, if the ranks differ
    return {
        "ranks": world, "shape": list(S.shape),
        "strategy": basis.provenance["strategy"], "k": basis.k,
        "stop": basis.provenance["stop"], "wall_s": wall,
        "serial_k": ser.k, "serial_stop": ser.provenance["stop"],
        "pivots_equal": bool(np.array_equal(ser.pivots[:kk],
                                            basis.pivots[:kk])),
        "max_err": float(proj_error_max(S, basis.Q)),
    }


def report(out: dict, device: str) -> None:
    """Print what rank 0 of :func:`_rank` returned."""
    print(f"S: {out['shape']} split by column over {out['ranks']} ranks "
          f"({device})")
    print(f"distributed greedy ({out['strategy']}): k={out['k']} "
          f"({out['stop']}) in {out['wall_s']:.2f}s, max err "
          f"{out['max_err']:.2e}")
    print(f"matches serial: k {out['serial_k']}=={out['k']}, pivots "
          f"equal: {out['pivots_equal']}")


def main(device: str = "cuda", ranks: int = 4, n_freq: int = 1000,
         n_mc: int = 64, n_eta: int = 8, tau: float = 1e-6) -> dict:
    from repro_torch.launch.mesh import spawn_ranks

    out = spawn_ranks(_rank, ranks, (n_freq, n_mc, n_eta, tau, device),
                      device=device, timeout_s=600)[0]
    report(out, device)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    main(device=args.device, ranks=args.ranks)
