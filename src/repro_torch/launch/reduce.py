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

Dry-run mode (``REPRO_DRYRUN=1``, :func:`dryrun`): trace one distributed
greedy step at the paper's flagship shape (10,000 x 3,276,800 complex64,
columns padded to the world, max_k 100) as rank 0 of a fake world of 256
or 512 ranks (``--mesh single|multi``), on fake tensors: nothing is
allocated.  It reports the per-device memory, cost terms, collectives and
H100 roofline, and ``useful_flop_ratio`` (useful = 8 N M / P)::

    REPRO_DRYRUN=1 python -m repro_torch.launch.reduce --mesh multi \
        --device cpu --out artifacts/reduce
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.configs.gw_greedy import CONFIG as GW_CONFIG
from repro_torch.configs.gw_greedy import reduced as gw_reduced


def dryrun(mesh_kind: str, out_dir: str, device: str = "cuda") -> dict:
    """One traced step of the column-distributed greedy at the flagship
    shape on the production mesh of a fake world; the record is printed
    and written to ``out_dir/gw_greedy__<mesh>.json``."""
    import json

    import torch

    from repro_torch.core.distributed import (
        DistGreedyState, make_dist_greedy_step,
    )
    from repro_torch.launch import roofline as R
    from repro_torch.launch.dryrun import fake_world_mode
    from repro_torch.launch.mesh import (
        close_ranks, init_fake_world, make_production_mesh,
    )

    multi = mesh_kind == "multi"
    init_fake_world(512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type=device)
        wl = GW_CONFIG
        n_dev = mesh.size()
        # columns padded to divide the ranks (greedycpp's N/P blocks)
        M = -(-wl.n_cols // n_dev) * n_dev
        N, m_loc, K = wl.n_rows, M // n_dev, wl.max_k
        dt, rdt = torch.complex64, torch.float32
        step = make_dist_greedy_step(mesh, M)
        with fake_world_mode():
            def empty(shape, dtype):
                return torch.empty(shape, dtype=dtype, device=device)

            S_loc = empty((N, m_loc), dt)
            state = DistGreedyState(
                Q=empty((N, K), dt), R=empty((K, m_loc), dt),
                norms_sq=empty((m_loc,), rdt), acc=empty((m_loc,), rdt),
                pivots=empty((K,), torch.int32), errs=empty((K,), rdt),
                k=torch.zeros((), dtype=torch.int64, device=device))
            counter = R.CostCounter()
            arg_bytes = counter.track((S_loc, state))
            t0 = time.time()
            with counter:
                out = step(S_loc, state)
            trace_s = time.time() - t0
            out_bytes = counter.storages_bytes(out, exclude=(S_loc, state))
    finally:
        close_ranks()
    terms = counter.terms()
    useful = 8.0 * N * m_loc
    rec = {
        "workload": wl.name, "mesh": mesh_kind, "devices": n_dev,
        "shape": [N, M], "dtype": "complex64", "trace_s": trace_s,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": max(counter.peak - arg_bytes, 0),
                   "peak_size_in_bytes": counter.peak},
        "per_device_cost": {k: v for k, v in terms.items()
                            if k != "collective_detail"},
        "collective_detail": terms["collective_detail"],
        "roofline": R.roofline_seconds(terms),
        "useful_flops_per_device": useful,
        "useful_flop_ratio": useful / max(terms["flops"], 1.0),
    }
    print(json.dumps(rec, indent=1, default=str), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"gw_greedy__{mesh_kind}.json"),
              "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


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
    ap.add_argument("--mesh", choices=["single", "multi"],
                    default="single",
                    help="REPRO_DRYRUN's production mesh: 256 or 512 "
                         "ranks")
    args = ap.parse_args(argv)
    if os.environ.get("REPRO_DRYRUN"):
        dryrun(args.mesh, args.out, args.device)
        return
    real_run(args.tau, args.out, args.small, chunk=args.chunk,
             backend=args.backend, strategy=args.strategy,
             workdir=args.workdir, resume=args.resume, tile_m=args.tile_m,
             device=args.device)


if __name__ == "__main__":
    main()
