"""Rank programs of ``test_torch_distributed.py``.

:func:`repro_torch.launch.mesh.spawn_ranks` starts each rank with
``spawn``, so a rank's function must be importable by name; these live
apart from the test module so that a rank imports PyTorch and the port
alone (no JAX).  Each returns host data.
"""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

EXAMPLES = str(Path(__file__).resolve().parents[1] / "examples")

TAU = 1e-5
MAX_K = 256             # the reference test's min(N, M)
MESHES = {"(4,)": ((4,), ("cols",)), "(2, 2)": ((2, 2), ("data", "model"))}
CHUNKS = (1, 8, 16)
BLOCK_P = 4
ELASTIC_CHUNK = 4      # steps per chunk of the build that is stopped
ELASTIC_CHUNKS = 2     # chunks checkpointed before it stops
WORKDIR_K = 20         # bases of the workdir build
# examples/torch_distributed_greedy.py's rank program at the reference
# demo's family, half its grid (600 x 256 complex128; the example's own
# size is 1,000 x 512)
EXAMPLE_ARGS = (600, 32, 8, 1e-6, "cpu")


class Stop(RuntimeError):
    """Raised by every rank's callback to end a build mid-way."""


# Unit-normalized TaylorF2 columns share one norm to an ulp, so their
# first pivot is a rounding decision that two packages' summation orders
# make differently (ROADMAP.md queue 3, "Limits recorded").  Rounded to
# multiples of 2^-30 (a perturbation of 1e-9, four decades below TAU), the
# columns' norms stand ~1e-9 apart, far above rounding, and both packages
# pick the same pivots.
ROUND = 2.0 ** -30


def gw_matrix(rounded=True):
    """The reference's distributed-suite family: 600 frequencies x 256
    TaylorF2 snapshots (a 32 x 8 chirp grid), complex128; ``rounded``:
    each entry rounded to a multiple of ROUND."""
    from repro_torch.gw import build_snapshot_matrix, chirp_grid
    from repro_torch.gw import frequency_grid

    f = frequency_grid(20.0, 512.0, 600)
    m1, m2 = chirp_grid(n_mc=32, n_eta=8)
    S = build_snapshot_matrix(f, m1, m2, dtype=torch.complex128,
                              device="cpu")
    if rounded:
        S = torch.complex(torch.round(S.real / ROUND) * ROUND,
                          torch.round(S.imag / ROUND) * ROUND)
    return S


def _host(res):
    return {"k": int(res.k), "stop": int(res.stop),
            "pivots": res.pivots.numpy(), "errs": res.errs.numpy(),
            "Q": res.Q.numpy(), "R": res.R.numpy()}


def _stopped(S, ckpt_dir):
    """A 4-rank build stopped after ELASTIC_CHUNKS checkpointed chunks (by
    its callback, on every rank); returns the k of its newest step."""
    from repro_torch.compat import make_auto_mesh
    from repro_torch.core.distributed import distributed_greedy

    seen = []

    def stop_after(state):
        seen.append(int(state.k))
        if len(seen) > ELASTIC_CHUNKS:
            raise Stop

    try:
        distributed_greedy(S, TAU, MAX_K,
                           make_auto_mesh((4,), ("cols",), "cpu"),
                           chunk=ELASTIC_CHUNK, callback=stop_after,
                           checkpoint_dir=ckpt_dir, device="cpu")
    except Stop:
        return seen[ELASTIC_CHUNKS - 1]
    raise AssertionError("the build ended before it was stopped")


def example_rank():
    """The distributed example's rank program on this group (its result
    on rank 0, None elsewhere)."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    import torch_distributed_greedy

    return torch_distributed_greedy._rank(*EXAMPLE_ARGS)


def cases(ckpt_dir):
    """Every case on 4 ranks: at both meshes the stepwise build (chunk
    16) on the rounded family; at mesh (4,) also chunks 1 and 8, the
    blocked build and the family as generated; a build stopped after
    ELASTIC_CHUNKS checkpointed chunks (resumed by
    :func:`resume_on_two`); the front door with a workdir; the
    distributed example's rank program.  Rank 0 also runs the port's
    serial drivers on the same matrices, in this process, for the bitwise
    comparisons."""
    from repro_torch.compat import make_auto_mesh
    from repro_torch.core.block_greedy import _rb_greedy_block_impl
    from repro_torch.core.distributed import distributed_greedy
    from repro_torch.core.greedy import rb_greedy

    S = gw_matrix()
    raw = gw_matrix(rounded=False)
    out = {"world": dist.get_world_size(), "ckpt_dir": ckpt_dir}
    for name, (shape, axes) in MESHES.items():
        mesh = make_auto_mesh(shape, axes, "cpu")
        out[name, 16] = _host(distributed_greedy(S, TAU, MAX_K, mesh,
                                                 device="cpu"))
        if name != "(4,)":
            continue
        # the other cases at the first mesh only, as the reference's (each
        # build is ~200 collectives; the other mesh lays out the same 4
        # shards)
        for chunk in (1, 8):
            out[name, chunk] = _host(distributed_greedy(
                S, TAU, MAX_K, mesh, chunk=chunk, device="cpu"))
        out[name, "blocked"] = _host(distributed_greedy(
            S, TAU, MAX_K, mesh, block_p=BLOCK_P, chunk=BLOCK_P,
            device="cpu"))
        out[name, "raw"] = _host(distributed_greedy(raw, TAU, MAX_K, mesh,
                                                    device="cpu"))
    out["stopped_at_k"] = _stopped(S, ckpt_dir)
    # the front door with a workdir: rank 0 finalizes the artifact
    from repro_torch.api import build_basis

    b = build_basis(source=S, tau=TAU, max_k=WORKDIR_K,
                    mesh=make_auto_mesh((4,), ("cols",), "cpu"),
                    workdir=f"{ckpt_dir}_work", device="cpu")
    out["workdir"] = {"k": b.k, "pivots": b.pivots, "Q": b.Q.numpy(),
                      "strategy": b.provenance["strategy"]}
    out["example"] = example_rank()
    if dist.get_rank() == 0:
        for chunk in CHUNKS:
            out["serial", chunk] = _host(rb_greedy(
                S, TAU, MAX_K, chunk=chunk, device="cpu"))
        out["serial", "blocked"] = _host(_rb_greedy_block_impl(
            S, TAU, p=BLOCK_P, max_k=MAX_K, chunk=BLOCK_P, device="cpu"))
        out["serial", "raw"] = _host(rb_greedy(raw, TAU, MAX_K,
                                               device="cpu"))
    return out


def resume_on_two(ckpt_dir):
    """The stopped 4-rank build resumed on 2 ranks, to its end."""
    from repro_torch.compat import make_auto_mesh
    from repro_torch.core.distributed import distributed_greedy

    S = gw_matrix()
    mesh = make_auto_mesh((dist.get_world_size(),), ("cols",), "cpu")
    return _host(distributed_greedy(S, TAU, MAX_K, mesh,
                                    chunk=ELASTIC_CHUNK,
                                    checkpoint_dir=ckpt_dir, resume=True,
                                    device="cpu"))


def fail_on_rank_one():
    """Rank 1 raises; rank 0 would wait for ten minutes."""
    import time

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    time.sleep(600)
    return 0


def ranks_sum(device):
    """Each rank's index summed over the group, on ``device``."""
    x = torch.full((1,), float(dist.get_rank()), dtype=torch.float64,
                   device=device)
    dist.all_reduce(x)
    return {"sum": float(x[0]), "backend": dist.get_backend()}


def gw_card_build(N, M, chunk):
    """The distributed build of an (N, M) complex64 GW matrix on the card,
    every rank generating its own columns; rank 0 returns the result."""
    from repro_torch.api import build_basis, make_auto_mesh
    from repro_torch.data.providers import WaveformProvider
    from repro_torch.gw import chirp_grid, frequency_grid

    dev = torch.device("cuda", torch.cuda.current_device())
    f = frequency_grid(40.0, 1024.0, N)
    m1, m2 = chirp_grid(n_mc=M // 16, n_eta=16)
    prov = WaveformProvider(f, m1, m2, dtype=torch.complex64, device=dev)
    mesh = make_auto_mesh((dist.get_world_size(),), ("cols",), "cuda")
    b = build_basis(source=prov, tau=1e-4, max_k=64, chunk=chunk, mesh=mesh,
                    device=dev)
    return {"k": b.k, "stop": b.provenance["stop"],
            "strategy": b.provenance["strategy"],
            "backend": dist.get_backend(), "pivots": np.asarray(b.pivots),
            "errs": np.asarray(b.errs), "Q": b.Q.cpu().numpy(),
            "R": np.asarray(b.R)}
