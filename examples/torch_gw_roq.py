"""Reduced-order quadrature for GW likelihoods on the PyTorch port.

The pipeline of ``examples/gw_roq.py`` on :mod:`repro_torch`: greedy basis
-> EIM nodes -> ROQ weights, then the inner products <d, h(nu)> two ways —
full quadrature vs ROQ — over a batch of "requests" (parameter draws),
with their accuracy and the operation-count reduction.

Run:  PYTHONPATH=src python examples/torch_gw_roq.py [--device cpu]
(``cuda`` by default).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.api import build_basis
from repro_torch.device import resolve_device
from repro_torch.gw import build_snapshot_matrix, chirp_grid, frequency_grid
from repro_torch.gw.grids import random_mass_samples
from repro_torch.gw.waveform import taylorf2, taylorf2_batch


def _synchronize(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device="cuda"):
    dev = resolve_device(device)
    # ---- offline stage ----
    N = 2000
    f = frequency_grid(20.0, 512.0, N)
    m1, m2 = chirp_grid(n_mc=50, n_eta=12)
    S = build_snapshot_matrix(f, m1, m2, dtype=torch.complex128, device=dev)
    basis = build_basis(source=S, tau=1e-6, device=dev)
    k = basis.k
    ei = basis.eim()
    print(f"offline on {dev}: basis k = {k}, EIM nodes selected from "
          f"N = {N} bins")

    # synthetic "data" = signal + noise, quadrature = uniform df
    rng = np.random.default_rng(0)
    fj = torch.as_tensor(f, device=dev)
    noise = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    data = taylorf2(fj, 12.0, 9.0, dtype=torch.complex128) + 0.05 * \
        torch.as_tensor(noise, device=dev)
    w = torch.full((N,), float(f[1] - f[0]), dtype=torch.float64,
                   device=dev)
    omega = basis.roq_weights(data, w)  # (k,) precomputed ROQ weights

    # ---- online stage: batched likelihood-style inner products ----
    n_req = 256
    q1, q2 = random_mass_samples(n_req, 7.0, 25.0, seed=3)
    # the model on the full grid for the full quadrature; the ROQ sum only
    # reads it at the k EIM nodes
    H = taylorf2_batch(fj, torch.as_tensor(q1), torch.as_tensor(q2),
                       dtype=torch.complex128)
    full_v = (w * data.conj()) @ H
    roq_v = omega @ H[ei.nodes]
    rel = ((full_v - roq_v).abs() / full_v.abs()).cpu().numpy()
    print(f"online: {n_req} requests; ROQ inner-product relative error "
          f"median {np.median(rel):.2e} / max {np.max(rel):.2e}")
    print(f"operation count per request: full = O({2 * N}) mul-adds, "
          f"ROQ = O({2 * k}) -> {N / k:.0f}x reduction")

    # wall time of the summation stage alone (steady state, best of 5)
    Hn = H[ei.nodes]
    wd = w * data.conj()
    times = {}
    for name, fn in (("full", lambda: wd @ H), ("roq", lambda: omega @ Hn)):
        fn()
        _synchronize(dev)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            _synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        times[name] = best
    print(f"summation wall-time on {dev}: full {times['full'] * 1e3:.3f} ms "
          f"vs ROQ {times['roq'] * 1e3:.3f} ms")
    return {"k": k, "median_rel_err": float(np.median(rel)),
            "max_rel_err": float(np.max(rel))}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
