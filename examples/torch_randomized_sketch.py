"""One-pass randomized sketch of a GW waveform family on the PyTorch port,
then greedy refinement.

The pipeline of ``examples/randomized_sketch.py`` on :mod:`repro_torch`.
Greedy streams the snapshot family once per accepted basis vector; the
randomized range-finder (``strategy="randomized"``) streams it 1 + 2 *
``sketch_power`` times whatever the rank: each waveform tile, generated on
the fly, is folded into a small sketch ``Y = S @ Omega`` (the test block
of each tile drawn on the card by the ``sketch_omega`` kernel) whose dense
SVD gives the basis and the spectrum estimates.  ``strategy=
"sketch+greedy"`` then restores greedy's exact tau semantics: the sketch
basis warm-starts the streamed greedy driver, which adds real pivots only
where the sketch fell short.

    PYTHONPATH=src python examples/torch_randomized_sketch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.api import ReductionSpec, build_basis
from repro_torch.device import resolve_device
from repro_torch.gw import chirp_grid, frequency_grid


def main(device="cuda", n_freq=1200, n_mc=60, n_eta=25, tile_m=300):
    dev = resolve_device(device)
    f = frequency_grid(20.0, 512.0, n_freq)
    m1, m2 = chirp_grid(mc_min=9.0, mc_max=11.0, n_mc=n_mc, n_eta=n_eta)

    # --- one streamed sketch (power 1: three passes) + dense SVD ---------
    spec = ReductionSpec.waveform(
        f, m1, m2, dtype=torch.complex64, device=dev,
        strategy="randomized", tau=1e-4, max_k=80, tile_m=tile_m,
        sketch_p=10, sketch_power=1,
    )
    N, M = spec.source.shape
    print(f"waveform family on {dev}: N={N} x M={M} complex64; sketch "
          f"width ell={min(90, N, M)}, passes={1 + 2 * 1}")
    basis = build_basis(spec)
    sk = basis.provenance["sketch"]
    print(f"randomized: rank k={basis.k} from {sk['n_passes']} pass(es) "
          f"over {sk['n_tiles']} tiles in "
          f"{basis.provenance['wall_time_s']:.2f}s")
    est = basis.provenance["sigma_estimates"]
    print(f"  sigma estimates (Ritz): {est[0]:.3e} ... "
          f"{est[basis.k - 1]:.3e}")

    # --- sketch warm start + greedy refinement to tau --------------------
    refined = build_basis(ReductionSpec.waveform(
        f, m1, m2, dtype=torch.complex64, device=dev,
        strategy="sketch+greedy", tau=1e-4, max_k=120, tile_m=tile_m,
        sketch_p=10, sketch_power=1, keep_R=False,
    ))
    k0 = refined.provenance["sketch"]["k0"]
    added = int((refined.pivots >= 0).sum())
    print(f"sketch+greedy: sketch seeded k0={k0}, greedy refined with "
          f"{added} pivot(s) to k={refined.k} "
          f"(stop={refined.provenance['stop']})")

    # both against the whole family, generated once
    S = spec.source.materialize()
    errs = {}
    for name, b in (("randomized", basis), ("sketch+greedy", refined)):
        errs[name] = float(b.per_column_errors(S).max())
        print(f"  {name}: max per-column projection error "
              f"{errs[name]:.3e}")
    return {"k": basis.k, "n_passes": sk["n_passes"], "k0": k0,
            "refined_k": refined.k, "added": added,
            "stop": refined.provenance["stop"],
            "max_err_randomized": errs["randomized"],
            "max_err_refined": errs["sketch+greedy"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
