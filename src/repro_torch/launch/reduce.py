"""Distributed greedy-reduction launcher (the paper's production job).

The port's counterpart of :mod:`repro.launch.reduce`'s real mode: build
the GW snapshot matrix split by column over the ranks of the group (each
rank generates only its own parameter slice on its device,
greedycpp-style), run the distributed RB-greedy with a checkpoint after
every chunk, and export the basis, its pivots and its EI nodes from rank
0.  Start one process per rank::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.reduce --small --device cpu --out out/
    python -m repro_torch.launch.reduce --small --out out/   # one rank, card

On a host whose ranks each have a card the group runs over NCCL; on the
CPU, or with ranks sharing a card, over gloo
(:func:`repro_torch.launch.mesh.init_ranks`).  ``--strategy`` other than
``distributed`` runs that strategy in one process over a
:class:`~repro_torch.data.providers.WaveformProvider`.

The reference's dry-run mode (``REPRO_DRYRUN=1``: lower and compile one
step through XLA at the 512-device production mesh) belongs with the
port's roofline launcher (ROADMAP.md queue 1 item 9); here it raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.configs.gw_greedy import CONFIG as GW_CONFIG
from repro_torch.configs.gw_greedy import reduced as gw_reduced


def real_run(tau: float | None, out: str, small: bool, chunk: int = 16,
             backend: str | None = None, strategy: str = "distributed",
             workdir: str | None = None, resume: bool = False,
             tile_m: int = 4096, device: str = "cuda"):
    """One build of the GW workload (``--small``: its reduced size) and
    its exports under ``out``; ``tau`` None takes the workload's.  Under
    ``distributed`` every rank of the group calls it; rank 0 writes."""
    import torch

    from repro_torch.api import ReductionSpec, build_basis
    from repro_torch.data.providers import WaveformProvider
    from repro_torch.gw import chirp_grid, frequency_grid

    wl = gw_reduced() if small else GW_CONFIG
    f = frequency_grid(20.0, 512.0, wl.n_rows)
    n_cols = wl.n_cols
    m1, m2 = chirp_grid(n_mc=n_cols // 16, n_eta=16)

    common = dict(
        tau=wl.tau if tau is None else tau, max_k=wl.max_k, chunk=chunk,
        backend=backend, workdir=workdir, resume=resume, device=device,
    )
    writer = True
    if strategy == "distributed":
        from repro_torch.compat import make_auto_mesh
        from repro_torch.launch.mesh import init_ranks

        ranks = init_ranks(device=device)
        writer = ranks.rank == 0
        mesh = make_auto_mesh((ranks.world_size,), ("cols",),
                              ranks.device.type)
        # each rank generates only its own columns of the chirp grid
        prov = WaveformProvider(f, m1, m2, dtype=torch.complex64,
                                device=ranks.device)
        if workdir is None:
            # without a workdir the driver checkpoints into out/ckpt/
            common["checkpoint_dir"] = os.path.join(out, "ckpt")
        common["device"] = ranks.device
        spec = ReductionSpec(source=prov, strategy="distributed", mesh=mesh,
                             **common)
    else:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise ValueError(f"strategy {strategy!r} runs in one process; "
                             f"only 'distributed' takes several ranks")
        prov = WaveformProvider(f, m1, m2, dtype=torch.complex64,
                                device=device)
        spec = ReductionSpec(
            source=prov, strategy=strategy, tile_m=tile_m,
            checkpoint_every_tiles=1 if workdir is not None else 0,
            **common)

    t0 = time.time()
    try:
        basis = build_basis(spec)
    finally:
        if strategy == "distributed":
            from repro_torch.launch.mesh import close_ranks

            close_ranks()
    k = basis.k
    if not writer:
        return basis
    print(f"greedy k={k} in {time.time()-t0:.1f}s; "
          f"final err={float(basis.errs[max(k-1, 0)]):.3e}; "
          f"stop={basis.provenance.get('stop')}", flush=True)
    os.makedirs(out, exist_ok=True)
    # the durable artifact (Q/R/pivots/errs + provenance; serve with
    # `python -m repro_torch.launch.serve --basis <dir>`): with a workdir
    # the build already finalized it there; otherwise save under out/ ...
    if workdir is None:
        basis.save(os.path.join(out, "basis"))
    # ... plus the flat exports
    np.save(os.path.join(out, "basis.npy"), basis.Q.cpu().numpy())
    np.save(os.path.join(out, "pivots.npy"), np.asarray(basis.pivots))
    ei = basis.eim()
    np.save(os.path.join(out, "ei_nodes.npy"), ei.nodes.cpu().numpy())
    print(f"exported ReducedBasis artifact + {k} EI nodes to {out}",
          flush=True)
    return basis


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tau", type=float, default=None,
                    help="stopping tolerance (default: the workload's)")
    ap.add_argument("--out", default="artifacts/reduce")
    ap.add_argument("--small", action="store_true",
                    help="the workload's reduced size (256 x 2,048)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="greedy iterations per host sync "
                         "(1 = one step per sync)")
    ap.add_argument("--backend", choices=["auto", "ref"], default=None,
                    help="hot-loop primitive backend (default: auto — "
                         "the CUDA kernels on the card, their plain "
                         "versions on the CPU; ref = the plain ops)")
    ap.add_argument("--strategy",
                    choices=["distributed", "streamed", "greedy",
                             "block_greedy", "auto"],
                    default="distributed",
                    help="reduction strategy (streamed generates waveform "
                         "tiles on the fly and never materializes S)")
    ap.add_argument("--workdir", default=None,
                    help="build-lifecycle directory: checkpoints in "
                         "<workdir>/build/, finalized artifact in "
                         "<workdir>; resumable and supervisor-safe")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --workdir checkpoints (or return "
                         "the already-finalized artifact)")
    ap.add_argument("--tile-m", type=int, default=4096,
                    help="streamed tile width in columns")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if os.environ.get("REPRO_DRYRUN"):
        raise NotImplementedError(
            "REPRO_DRYRUN (lower and compile one step at the production "
            "mesh) is not ported: ROADMAP.md queue 1 item 9 (the roofline "
            "launcher)")
    real_run(args.tau, args.out, args.small, chunk=args.chunk,
             backend=args.backend, strategy=args.strategy,
             workdir=args.workdir, resume=args.resume, tile_m=args.tile_m,
             device=args.device)


if __name__ == "__main__":
    main()
