"""Banded reduction on the PyTorch port: B per-band bases in one lockstep
pass, then served.

The counterpart of ``examples/banded_bases.py``: FFT the sample axis of a
chirp family, slice the spectrum into B contiguous bands, and reduce each
band with its own basis.  The B band matrices share one (N_b, M) shape, the
stacked workload ``strategy="batched"`` builds in one lockstep pass (one
sweep launch a round for every band) instead of B sequential greedy builds;
each band's basis is bitwise the scalar build's on that band.  The
resulting ``ReducedBasisSet`` registers its children with the serving
``BasisRouter`` (one route a band), and the ``ROQEngine`` interpolates a
held-out signal band by band: one request a band, each answer bitwise the
direct evaluation of its interpolant.

Run:  PYTHONPATH=src python examples/torch_banded_bases.py [--device cpu]
(``cuda`` by default).
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.api import ReducedBasisSet, build_basis
from repro_torch.data import band_split
from repro_torch.device import resolve_device
from repro_torch.serving import BasisRouter, ROQEngine, direct_interpolate


def chirp_family(n=1024, m=160, seed=0):
    """Real time-domain chirps h(t) = sin(2 pi (f0 t + c t^2 / 2)) over a
    random (f0, c) grid: a stand-in for a time-domain detector-frame
    family."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n, endpoint=False)
    f0 = rng.uniform(12.0, 48.0, size=m)
    c = rng.uniform(30.0, 120.0, size=m)
    S = np.sin(2 * np.pi * (f0[None, :] * t[:, None]
                            + 0.5 * c[None, :] * t[:, None] ** 2))
    return np.asarray(S, dtype=np.float32)


def main(device="cuda", bands=8, tau=1e-5, max_k=64):
    dev = resolve_device(device)
    S = chirp_family()
    split = band_split(S, bands=bands, device=dev)  # rFFT -> (B, N_b, M)
    B, Nb, M = split.stack.shape
    print(f"chirp family {S.shape} -> {B} bands x ({Nb} bins, {M} cols) "
          f"on {dev}; rFFT bins {split.n_freq}, edges {split.edges[0]}.."
          f"{split.edges[-1]}")

    with tempfile.TemporaryDirectory() as tmp:
        workdir = os.path.join(tmp, "bands")
        bset = build_basis(source=split, strategy="batched", tau=tau,
                           max_k=max_k, workdir=workdir, device=dev)
        ks = [b.k for b in bset]
        lock = bset.provenance["lockstep"]
        print(f"batched build: {B} bases in {lock['rounds']} lockstep "
              f"rounds, k per band = {ks} "
              f"({bset.provenance['wall_time_s']:.2f} s)")

        # the set is one artifact directory: B children + set.json
        bset = ReducedBasisSet.load(workdir, dev)

        # one serving route a band (directory-backed: evictable)
        router = BasisRouter(device=dev)
        ids = bset.register(router, prefix="band")
        engine = ROQEngine(router, max_batch=16, max_wait_ms=1.0)
        try:
            held_out = torch.fft.rfft(torch.from_numpy(
                chirp_family(m=3, seed=7)), dim=0)
            worst, same = 0.0, True
            for b, bid in enumerate(ids):
                lo, hi = split.edges[b]
                col = held_out[lo:hi, 0]
                _, eim = engine.router.get(bid)
                f_nodes = col[eim.nodes.cpu()]
                rec = engine.submit(bid, f_nodes).result(timeout=60)
                same &= torch.equal(rec, direct_interpolate(eim, f_nodes))
                err = float((rec - col).abs().max())
                worst = max(worst, err / (float(col.abs().max()) + 1e-30))
            print(f"served {B} per-band interpolations, each bitwise its "
                  f"direct evaluation: {same}; worst relative EIM error "
                  f"{worst:.3e}")
        finally:
            engine.close()
    return {"batch": B, "ks": ks, "rounds": lock["rounds"],
            "stops": [b.provenance["lane"]["stop"] for b in bset],
            "worst_rel_err": worst, "served_bitwise": same,
            "edges": split.edges}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
