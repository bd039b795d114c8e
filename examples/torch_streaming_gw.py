"""Out-of-core GW basis build on the PyTorch port: snapshots generated on
the fly, never stored.

The pipeline of ``examples/streaming_gw.py`` on :mod:`repro_torch`.  The
paper's headline run reduces a snapshot matrix that no single worker can
hold.  ``ReductionSpec.waveform`` wraps a (chirp mass, eta) grid in a
:class:`repro_torch.data.WaveformProvider` that generates TaylorF2 tiles
on demand (the ``taylorf2_tile`` kernel on the card) — the full matrix
never exists — and ``build_basis(strategy="streamed")`` sweeps the tiles
with peak device memory O(N * (max_k + 2 * tile_m)), checkpointing
mid-build so that a killed job resumes from the last completed tile:

    PYTHONPATH=src python examples/torch_streaming_gw.py [--device cpu]
    PYTHONPATH=src python examples/torch_streaming_gw.py   # resumes

(``cuda`` by default; the checkpoints go to ``examples/_streaming_ckpt``.)
"""

import argparse
import os

import numpy as np
import torch

from repro_torch.api import ReductionSpec, build_basis
from repro_torch.device import resolve_device
from repro_torch.gw import chirp_grid, frequency_grid


def main(device="cuda", ckpt=None, n_freq=2000, n_mc=120, n_eta=40,
         tile_m=600):
    dev = resolve_device(device)
    f = frequency_grid(20.0, 512.0, n_freq)
    # narrow chirp-mass band: the family's n-width decays within ~60 bases
    m1, m2 = chirp_grid(mc_min=9.0, mc_max=11.0, n_mc=n_mc, n_eta=n_eta)
    max_k = 96
    if ckpt is None:
        ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_streaming_ckpt")
    # a waveform-grid spec: snapshot columns generated on the fly, the
    # matrix never materialized (the paper's out-of-core regime)
    spec = ReductionSpec.waveform(
        f, m1, m2, dtype=torch.complex64, device=dev,
        strategy="streamed", tau=1e-4, max_k=max_k, tile_m=tile_m,
        keep_R=False, checkpoint_dir=ckpt, checkpoint_every_tiles=2,
        resume=True,
        callback=lambda i: print(
            f"  basis {i['k']:3d}  pivot {i['pivot']:5d}  "
            f"err {i['err']:.3e}"),
    )
    prov = spec.source
    N, M = prov.shape
    print(f"provider on {dev}: N={N} x M={M} complex64 "
          f"(~{N * M * 8 / 1e6:.0f} MB if materialized), tile_m={tile_m} "
          f"-> device peak ~{N * (max_k + 2 * tile_m) * 8 / 1e6:.1f} MB "
          f"(current + prefetched tile)")

    basis = build_basis(spec)
    print(f"built k={basis.k} bases ({basis.provenance['stop']}) over "
          f"{-(-M // tile_m)} tiles/sweep")

    # in-grid spot checks against freshly generated waveforms
    rng = np.random.default_rng(7)
    worst = 0.0
    for _ in range(50):
        h = prov.column(int(rng.integers(0, M)))
        worst = max(worst, float(torch.linalg.vector_norm(
            h - basis.reconstruct(h))))
    print(f"max in-grid residual over 50 spot checks: {worst:.3e}")
    return {"k": basis.k, "stop": basis.provenance["stop"],
            "max_spot_err": worst, "last_err": float(basis.errs[-1])}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
