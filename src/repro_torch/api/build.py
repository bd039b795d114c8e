"""`build_basis`: the front door of the port.

Port of :mod:`repro.api.build` for the resident strategies and the
streamed ones: ``greedy`` runs :func:`repro_torch.core.greedy.rb_greedy`,
``block_greedy`` :func:`repro_torch.core.block_greedy.
_rb_greedy_block_impl`, ``streamed``
:func:`repro_torch.core.streaming.rb_greedy_streamed`, ``randomized``
:func:`repro_torch.core.randomized.rb_randomized_streamed` (a POD-shaped
result: no pivots, the errs are the singular-value estimates) and
``sketch+greedy`` that sketch refined to tau by the streamed greedy driver
(the streamed strategies over the source's provider, never materialized),
so the artifact's arrays equal the driver's (trimmed) output; the paper's
oracles ``pod``
(:func:`repro_torch.core.pod.pod`) and ``mgs``
(:func:`repro_torch.core.mgs._mgs_pivoted_qr_impl`) run through the same
door.
``strategy="auto"`` resolves to ``"greedy"`` (the roofline model that picks
the blocked path is not ported yet) and logs the choice on logger
``repro_torch.api``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.api.artifact import ReducedBasis
from repro_torch.api.spec import ReductionSpec
from repro_torch.device import resolve_device

logger = logging.getLogger("repro_torch.api")

_ENV_BUDGET = "REPRO_DEVICE_MEM_BUDGET"
_FALLBACK_BUDGET = 4 << 30  # 4 GiB when nothing else is detectable


def device_memory_budget(device=None) -> int:
    """Device-memory budget (bytes) that the serving router plans against.

    Precedence: ``REPRO_DEVICE_MEM_BUDGET`` > the card's total memory
    (``torch.cuda.mem_get_info``; ``device`` None means the current card
    if there is one) > half of the host's MemAvailable (a CPU device
    shares host RAM) > 4 GiB.
    """
    env = os.environ.get(_ENV_BUDGET)
    if env:
        return int(float(env))
    if device is None and torch.cuda.is_available():
        device = "cuda"
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(resolve_device(device))[1])
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 // 2
    except OSError:
        pass
    return _FALLBACK_BUDGET


# Each builder returns (Q, pivots, errs, R, k, extras): the arrays trimmed
# to the accepted rank, and a JSON-serializable dict merged into the
# artifact provenance (the terminal stop code; the adaptive blocked
# driver's width trajectory).


def _trim_greedy(res, extras=None):
    from repro_torch.core.greedy import STOP_NAMES

    k = int(res.k)
    extras = dict(extras or {})
    extras["stop"] = STOP_NAMES.get(int(res.stop), str(int(res.stop)))
    return (res.Q[:, :k].contiguous(),
            res.pivots[:k].cpu().numpy(), res.errs[:k].cpu().numpy(),
            None if res.R is None else res.R[:k].cpu().numpy(), k, extras)


def _build_greedy(spec, S, ckpt_dir=None):
    from repro_torch.core.greedy import rb_greedy

    return _trim_greedy(rb_greedy(
        S, tau=spec.tau, max_k=spec.max_k, kappa=spec.kappa,
        max_passes=spec.max_passes, callback=spec.callback,
        refresh=spec.refresh, refresh_safety=spec.refresh_safety,
        chunk=spec.chunk, backend=spec.backend,
        checkpoint_dir=ckpt_dir, resume=spec.resume, device=S.device,
    ))


def _build_block_greedy(spec, S, ckpt_dir=None):
    from repro_torch.core.block_greedy import _rb_greedy_block_impl

    # spec.chunk counts greedy ITERATIONS per host sync; the blocked
    # driver's chunk counts BLOCKS of block_p, so divide to keep the
    # cadence the user configured.
    diag = {} if spec.adaptive_block else None
    res = _rb_greedy_block_impl(
        S, tau=spec.tau, p=spec.block_p, max_k=spec.max_k,
        kappa=spec.kappa, max_passes=spec.max_passes, refresh=spec.refresh,
        refresh_safety=spec.refresh_safety, backend=spec.backend,
        chunk=max(1, spec.chunk // max(spec.block_p, 1)),
        callback=spec.callback, panel=spec.panel_ortho,
        adaptive=spec.adaptive_block, diagnostics=diag,
        checkpoint_dir=ckpt_dir, resume=spec.resume, device=S.device,
    )
    return _trim_greedy(res, diag)


def _build_streamed(spec, prov, ckpt_dir=None):
    from repro_torch.core.streaming import rb_greedy_streamed

    # the provenance records the passes over S: tile passes (init, sweeps,
    # refreshes) and single columns fetched
    diag = {}
    return _trim_greedy(rb_greedy_streamed(
        prov, tau=spec.tau, max_k=spec.max_k, tile_m=spec.tile_m,
        block_p=spec.block_p, kappa=spec.kappa,
        max_passes=spec.max_passes, refresh=spec.refresh,
        refresh_safety=spec.refresh_safety, backend=spec.backend,
        panel_ortho=spec.panel_ortho, keep_R=spec.keep_R,
        checkpoint_dir=ckpt_dir,
        checkpoint_every_tiles=spec.checkpoint_every_tiles,
        resume=spec.resume, callback=spec.callback, diagnostics=diag,
    ), diag)


def _sketch_extras(res):
    """Randomized provenance: sketch params + singular-value estimates."""
    return {
        "sketch": {
            "ell": int(res.ell),
            "p": int(res.sketch_p),
            "power": int(res.power),
            "seed": int(res.seed),
            "kind": res.kind,
            "n_passes": int(res.n_passes),
            "n_tiles": int(res.n_tiles),
        },
        "sigma_estimates": [float(s) for s in res.svals],
    }


def _run_sketch(spec, prov, ckpt_dir):
    from repro_torch.core.randomized import rb_randomized_streamed

    return rb_randomized_streamed(
        prov, tau=spec.tau, max_k=spec.max_k, sketch_p=spec.sketch_p,
        power=spec.sketch_power, seed=spec.sketch_seed,
        kind=spec.sketch_kind, tile_m=spec.tile_m, backend=spec.backend,
        checkpoint_dir=ckpt_dir,
        checkpoint_every_tiles=spec.checkpoint_every_tiles,
        resume=spec.resume and ckpt_dir is not None,
    )


def _build_randomized(spec, prov, ckpt_dir=None):
    res = _run_sketch(spec, prov, ckpt_dir)
    k = int(res.k)
    # POD-shaped result: no pivots (the basis spans a sketched range, not
    # selected columns), errs are the spectrum estimates
    return (res.Q, np.zeros((0,), np.int32), np.asarray(res.svals[:k]),
            None, k, _sketch_extras(res))


def _build_sketch_greedy(spec, prov, ckpt_dir=None):
    """One-pass sketch initializes Q; the streamed greedy driver refines it
    to tau.

    The sketch's basis enters :func:`repro_torch.core.streaming.
    rb_greedy_streamed` through ``warm_start=`` with pivots of -1 (these
    columns were not selected from S), and the greedy loop extends it with
    the directions the sketch missed, under tau's exact Eq.-(6.3) error
    control.  The refinement runs stepwise (block_p = 1): the blocked
    driver's compaction drops slots whose pivot is -1, which would evict
    the warm columns.
    """
    from repro_torch.core.streaming import rb_greedy_streamed

    sketch_dir = os.path.join(ckpt_dir, "sketch") if ckpt_dir else None
    refine_dir = os.path.join(ckpt_dir, "refine") if ckpt_dir else None
    res = _run_sketch(spec, prov, sketch_dir)
    k0 = int(res.k)
    warm = {
        "Q": res.Q,
        "pivots": np.full((k0,), -1, np.int32),
        "errs": np.asarray(res.svals[:k0]),
    }
    diag = {}
    refined = rb_greedy_streamed(
        prov, tau=spec.tau, max_k=spec.max_k, tile_m=spec.tile_m,
        block_p=1, kappa=spec.kappa, max_passes=spec.max_passes,
        refresh=spec.refresh, refresh_safety=spec.refresh_safety,
        backend=spec.backend, panel_ortho=spec.panel_ortho,
        keep_R=spec.keep_R, checkpoint_dir=refine_dir,
        checkpoint_every_tiles=spec.checkpoint_every_tiles,
        resume=spec.resume, callback=spec.callback, warm_start=warm,
        diagnostics=diag,
    )
    # the refinement's passes over S, as strategy="streamed" records them
    out = _trim_greedy(refined, {**diag, **_sketch_extras(res)})
    out[5]["sketch"]["k0"] = k0
    out[5]["sketch"]["refined_k"] = out[4]
    return out


def _build_mgs(spec, S, ckpt_dir=None):
    from repro_torch.core.mgs import _mgs_pivoted_qr_impl

    res = _mgs_pivoted_qr_impl(S, tau=spec.tau, max_k=spec.max_k,
                               device=S.device)
    return (res.Q, res.pivots.cpu().numpy(), res.r_diag.cpu().numpy(),
            res.R.cpu().numpy(), res.k, {})


def _build_pod(spec, S, ckpt_dir=None):
    from repro_torch.core.pod import pod

    res = pod(S, tau=spec.tau, device=S.device)
    k = res.k if spec.max_k is None else min(res.k, spec.max_k)
    return (res.basis[:, :k].contiguous(), np.zeros((0,), np.int32),
            res.sigmas[:k].cpu().numpy(), None, k, {})


# strategies that stream their source's tiles instead of materializing it
_STREAMING_STRATEGIES = ("streamed", "randomized", "sketch+greedy")

_BUILDERS = {
    "greedy": _build_greedy,
    "block_greedy": _build_block_greedy,
    "streamed": _build_streamed,
    "randomized": _build_randomized,
    "sketch+greedy": _build_sketch_greedy,
    "mgs": _build_mgs,
    "pod": _build_pod,
}


def build_basis(spec: ReductionSpec | None = None,
                **kwargs) -> ReducedBasis:
    """Build a reduced basis.

    Call with a :class:`ReductionSpec`, keyword arguments, or both (the
    keywords override spec fields)::

        basis = build_basis(source=S, tau=1e-6)              # on cuda
        basis = build_basis(source=S, tau=1e-6, device="cpu")

    Returns a :class:`ReducedBasis` trimmed to the accepted rank, with
    build provenance attached.
    """
    if spec is None:
        spec = ReductionSpec(**kwargs)
    elif kwargs:
        spec = dataclasses.replace(spec, **kwargs)
    if not isinstance(spec, ReductionSpec):
        raise TypeError(
            f"build_basis takes a ReductionSpec (or keyword args), got "
            f"{type(spec).__name__}")

    from repro_torch.core.backend import resolve_backend
    from repro_torch.data.providers import as_provider, materialize_source

    device = resolve_device(spec.device)
    # ------------------------------------------- workdir build lifecycle --
    # A workdir owns the whole build: mid-build checkpoints in
    # <workdir>/build/, the finished basis finalized atomically into
    # <workdir> itself, scratch removed on success.  Crash anywhere +
    # relaunch with resume=True lands on the identical artifact.
    build_dir = None
    if spec.workdir is not None:
        build_dir = os.path.join(spec.workdir, "build")
        if spec.resume:
            try:
                basis = ReducedBasis.load(spec.workdir, device)
            except (FileNotFoundError, IOError):
                pass  # nothing finalized yet: (re)build below
            else:
                # Already finalized (the previous run died between
                # finalize and scratch cleanup): return it, finish the GC.
                shutil.rmtree(build_dir, ignore_errors=True)
                logger.info("workdir %s already holds a finalized basis; "
                            "returning it", spec.workdir)
                return basis
        else:
            # A fresh build must not splice onto a previous run's steps.
            shutil.rmtree(build_dir, ignore_errors=True)
    ckpt_dir = build_dir if build_dir is not None else spec.checkpoint_dir

    strategy = spec.strategy
    if strategy == "auto":
        strategy = "greedy"
        logger.info("auto strategy -> 'greedy' (the roofline model that "
                    "picks the blocked path is not ported to repro_torch)")
    if strategy in _STREAMING_STRATEGIES:
        # the source stays where it is: the driver streams its tiles
        S = as_provider(spec.source, device)
        if S.device != device:
            raise ValueError(f"provider places tiles on {S.device}, "
                             f"requested {device}")
    else:
        S = materialize_source(spec.source, device)

    t0 = time.perf_counter()
    Q, pivots, errs, R, k, extras = _BUILDERS[strategy](spec, S, ckpt_dir)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    from repro_torch import __version__

    provenance = {
        "strategy": strategy,
        "requested_strategy": spec.strategy,
        "backend": (None if strategy in ("pod", "mgs")
                    else resolve_backend(spec.backend)),
        "device": device.type,
        "dtype": str(S.dtype).removeprefix("torch."),
        "shape": [int(S.shape[0]), int(S.shape[1])],
        "tau": spec.tau,
        "max_k": spec.max_k,
        "block_p": spec.block_p,
        "wall_time_s": wall,
        "spec": spec.describe(),
        "repro_version": __version__,
        **extras,
    }
    basis = ReducedBasis(Q=Q, pivots=pivots, errs=errs, k=k, R=R,
                         provenance=provenance)
    if spec.workdir is not None:
        # Finalize: atomic save into the workdir, THEN drop the scratch.
        basis.save(spec.workdir)
        shutil.rmtree(build_dir, ignore_errors=True)
    return basis
