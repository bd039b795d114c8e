"""Quickstart on the PyTorch port: build a reduced basis for gravitational
waveforms.

The tour of the paper's pipeline through the port's front door
(:mod:`repro_torch.api`), as ``examples/quickstart.py`` takes it through
the JAX package's:
  1. generate a snapshot matrix from the TaylorF2 waveform family,
  2. ``build_basis`` it to a target tolerance (``"auto"`` picks the
     driver: RB-greedy at this size),
  3. compare against POD (Algorithm 1) and the reconstruction (Algorithm 4),
  4. build an empirical interpolant (EIM) and validate out-of-sample,
  5. save the artifact and reload it.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(``cuda`` by default).
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import ReducedBasis, build_basis
from repro_torch.core import empirical_interpolant, reconstruction
from repro_torch.core.errors import orthogonality_defect
from repro_torch.device import resolve_device
from repro_torch.gw import build_snapshot_matrix, chirp_grid, frequency_grid
from repro_torch.gw.grids import random_mass_samples


def main(device="cuda"):
    dev = resolve_device(device)
    # 1. snapshots: h(f; m1, m2) on a 60x15 chirp-mass grid
    f = frequency_grid(20.0, 512.0, 1500)
    m1, m2 = chirp_grid(n_mc=60, n_eta=15)
    S = build_snapshot_matrix(f, m1, m2, dtype=torch.complex128, device=dev)
    print(f"snapshot matrix S: {tuple(S.shape)} {S.dtype} on {dev} "
          f"({S.nbytes / 1e6:.1f} MB)")

    # 2. one front door: strategy="auto" picks the driver from S's shape,
    #    the device's memory and its roofline (here S fits and one sweep
    #    of it stays in the last-level cache: the resident greedy)
    tau = 1e-6
    basis = build_basis(source=S, tau=tau, device=dev)
    k = basis.k
    strategy = basis.provenance["strategy"]
    print(f"{strategy} basis (auto): k = {k} of {S.shape[1]} columns "
          f"(compression {S.shape[1] / k:.1f}x)")
    print(f"  max projection error: "
          f"{float(basis.per_column_errors(S).max()):.2e} (tau = {tau:.0e})")
    print(f"  orthogonality defect: "
          f"{float(orthogonality_defect(basis.Q)):.2e}")
    print(f"  error decay: "
          f"{[f'{float(e):.1e}' for e in basis.errs[::max(1, k // 8)]]}")

    # 3. POD comparison (Theorem 3.2 / Remark 4.2) — same front door,
    #    different strategy — and the reconstruction approach
    p = build_basis(source=S, strategy="pod", tau=tau, device=dev)
    print(f"POD rank at same tau (2-norm): k = {p.k} "
          f"(greedy uses max-norm; Cor. 4.4 orders the criteria)")
    rec = reconstruction(S, tau1=tau * 1e-2, tau2=tau, device=dev)
    print(f"reconstruction (Alg. 4): j = {rec.j} QR terms -> "
          f"k = {rec.k} SVD-rotated bases")

    # 4. EIM + out-of-sample validation
    ei = basis.eim()
    mv1, mv2 = random_mass_samples(200, 7.0, 25.0, seed=7)
    V = build_snapshot_matrix(f, mv1, mv2, dtype=torch.complex128,
                              device=dev)
    errs = torch.linalg.vector_norm(
        empirical_interpolant(ei.B, ei.nodes, V) - V, dim=0).cpu().numpy()
    print(f"EIM: {k} nodes; out-of-sample interpolation error "
          f"median {np.median(errs):.2e} / max {np.max(errs):.2e}")

    # 5. the basis is a durable artifact: save, reload, reuse
    with tempfile.TemporaryDirectory() as td:
        basis.save(td)
        again = ReducedBasis.load(td, dev)
        same = torch.equal(again.Q, basis.Q)
        print(f"save/load round trip: bit-identical Q = {same}, "
              f"provenance strategy = {again.provenance['strategy']!r}")
    return {"k": k, "strategy": strategy, "pod_k": p.k, "rec_j": rec.j,
            "rec_k": rec.k, "max_oos_err": float(np.max(errs)),
            "round_trip": same}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
