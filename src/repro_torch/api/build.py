"""`build_basis`: the front door of the port.

Port of :mod:`repro.api.build`: ``greedy`` runs
:func:`repro_torch.core.greedy.rb_greedy`,
``block_greedy`` :func:`repro_torch.core.block_greedy.
_rb_greedy_block_impl`, ``streamed``
:func:`repro_torch.core.streaming.rb_greedy_streamed`, ``randomized``
:func:`repro_torch.core.randomized.rb_randomized_streamed` (a POD-shaped
result: no pivots, the errs are the singular-value estimates) and
``sketch+greedy`` that sketch refined to tau by the streamed greedy driver
(the streamed strategies over the source's provider, never materialized),
so the artifact's arrays equal the driver's (trimmed) output;
``distributed`` runs :func:`repro_torch.core.distributed.
distributed_greedy` on every rank of ``spec.mesh``, each rank
materializing only its own columns of the source; the paper's oracles
``pod``
(:func:`repro_torch.core.pod.pod`) and ``mgs``
(:func:`repro_torch.core.mgs._mgs_pivoted_qr_impl`) run through the same
door.

Strategy ``"auto"`` picks the driver from the problem shape, a
device-memory budget and a DRAM-roofline model of the device, as the
reference does, before anything is materialized:

  a mesh was given                   -> "distributed" (no roofline work)
  roof-bound, max_k set, greedy pass
    count > 2x the sketch's          -> "randomized" (one-pass range-finder)
  fits budget, sweep roof-bound      -> "block_greedy" (blocked sweep)
  fits budget otherwise              -> "greedy"   (resident chunked)
  too big, sweep roof-bound          -> "streamed" + block_p (blocked)
  too big otherwise                  -> "streamed" (tile-streamed)

"Roof-bound" means the Eq.-(6.3) pivot sweep's arithmetic intensity sits
below the machine balance (peak FLOP/s over DRAM bandwidth) AND one sweep
over S exceeds the last-level cache.  The model's knobs come from the spec
(``bandwidth_gbps`` / ``peak_gflops`` / ``cache_bytes``), the
``REPRO_DRAM_BW_GBPS`` / ``REPRO_PEAK_GFLOPS`` / ``REPRO_LLC_BYTES`` env
vars, a one-time measurement on the build's device
(:mod:`repro_torch.api.roofline`), or per-device defaults, in that order.
A many-basis workload (``batch=``, a (B, N, M), list, tuple or
:class:`~repro_torch.data.bands.BandSplit` source) goes to
:func:`build_basis_set`, as ``strategy="batched"`` does, and returns a
:class:`~repro_torch.api.basis_set.ReducedBasisSet`.  The choice and the
numbers behind it are logged on logger ``repro_torch.api``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.artifact import ReducedBasis
from repro_torch.api.spec import ReductionSpec
from repro_torch.device import resolve_device, torch_dtype

logger = logging.getLogger("repro_torch.api")

_ENV_BUDGET = "REPRO_DEVICE_MEM_BUDGET"
_FALLBACK_BUDGET = 4 << 30  # 4 GiB when nothing else is detectable


def device_memory_budget(device=None) -> int:
    """Device-memory budget (bytes) that ``"auto"`` and the serving router
    plan against.

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


def _resident_bytes(shape, dtype, max_k: Optional[int]) -> int:
    """Device footprint of a resident greedy build: S + Q + R (+ M-vectors)."""
    N, M = shape
    mk = min(N, M) if max_k is None else min(max_k, N, M)
    itemsize = torch_dtype(dtype).itemsize
    return itemsize * (N * M + mk * (N + M)) + 4 * M * itemsize


# --------------------------------------------------- DRAM roofline model ----

_ENV_BW = "REPRO_DRAM_BW_GBPS"
_ENV_FLOPS = "REPRO_PEAK_GFLOPS"
_ENV_CACHE = "REPRO_LLC_BYTES"

# Roofs per device type for when nothing is measured or configured:
# (DRAM bandwidth GB/s, peak GFLOP/s, last-level cache bytes).  "cpu" is
# the reference's row, so the CPU reproduces its decision table; "cuda"
# is what this module's calibration measured on one NVIDIA H100 80GB HBM3
# at a 700.00 W power limit (chip_smoke.py, phase roofline): the
# greedy_update sweep over 128 MB, a 512^3 float32 GEMM (TF32 off) and
# the llc_probe cliff (32 MB of the 50 MB L2 stream at the L2's rate).
_PLATFORM_ROOFS = {
    "cpu": (25.0, 80.0, 64 << 20),
    "cuda": (2616.5, 14_980.0, 32 << 20),
}

# Panel width "auto" applies when it decides blocking pays and the spec
# left block_p at the stepwise default: one S read per 8 bases, the
# reference's rule (the blocked basis falls short at the GW shapes in both
# packages: ROADMAP.md queue 3).
_AUTO_BLOCK_P = 8


def machine_roofline(spec: Optional[ReductionSpec] = None, device=None):
    """(bandwidth GB/s, peak GFLOP/s, cache bytes) the ``"auto"`` roofline
    model plans against, for ``spec.device`` (or ``device`` without a
    spec; ``cuda`` unless asked).  Precedence per knob: spec field >
    ``REPRO_DRAM_BW_GBPS`` / ``REPRO_PEAK_GFLOPS`` / ``REPRO_LLC_BYTES``
    env var > one-time on-device measurement
    (:func:`repro_torch.api.roofline.measured_roofline` for
    bandwidth/FLOPs, :func:`repro_torch.api.roofline.measured_cache_bytes`
    for the LLC working-set sweep; all skipped under
    ``REPRO_ROOFLINE_MEASURE=0``) > per-device default."""
    from repro_torch.api import roofline

    dev = resolve_device(device if spec is None else spec.device)
    defaults = _PLATFORM_ROOFS.get(dev.type, _PLATFORM_ROOFS["cpu"])

    def pinned(field, env):
        if field is not None:
            return float(field)
        raw = os.environ.get(env)
        return float(raw) if raw else None

    bw = pinned(getattr(spec, "bandwidth_gbps", None), _ENV_BW)
    gf = pinned(getattr(spec, "peak_gflops", None), _ENV_FLOPS)
    if (bw is None or gf is None) and roofline.roofline_measurement_enabled():
        # only knobs nobody pinned are filled from the measurement (a
        # failed calibration reports 0.0 and falls through to defaults)
        m_bw, m_gf = roofline.measured_roofline(dev)
        if bw is None and m_bw > 0:
            bw = m_bw
        if gf is None and m_gf > 0:
            gf = m_gf

    cache_field = getattr(spec, "cache_bytes", None)
    if cache_field is not None:
        cache = int(cache_field)
    else:
        raw = os.environ.get(_ENV_CACHE)
        if raw:
            cache = int(float(raw))
        else:
            cache = defaults[2]
            if roofline.roofline_measurement_enabled():
                m_cache = roofline.measured_cache_bytes(dev)
                if m_cache > 0:
                    cache = m_cache

    return (
        defaults[0] if bw is None else bw,
        defaults[1] if gf is None else gf,
        cache,
    )


def _sweep_roofline(shape, dtype, spec: Optional[ReductionSpec] = None):
    """Classify the Eq.-(6.3) pivot sweep for this problem.

    Returns ``(roof_bound, why)``: one sweep reads S once (``N*M*itemsize``
    bytes) for 2 real FLOPs per element (8 for complex).  The sweep is
    DRAM-roof-bound when that intensity sits below the machine balance AND
    the sweep exceeds the last-level cache — exactly the regime where
    block pivoting (one read per block_p bases) is the lever.
    """
    bw, gflops, cache = machine_roofline(spec)
    N, M = shape
    dt = torch_dtype(dtype)
    sweep_bytes = N * M * dt.itemsize
    flops = (8 if dt.is_complex else 2) * N * M
    intensity = flops / sweep_bytes
    balance = gflops / bw
    roof_bound = intensity < balance and sweep_bytes > cache
    why = (f"sweep ~{sweep_bytes / 1e6:.0f} MB at {intensity:.2f} FLOP/B "
           f"vs balance {balance:.2f} FLOP/B, cache ~{cache / 1e6:.0f} MB"
           f" -> {'roof-bound' if roof_bound else 'not roof-bound'}")
    return roof_bound, why


def _estimated_max_k(spec: ReductionSpec, shape):
    """Sketch-estimate a ``max_k`` for planning when the caller gave none.

    Costs a few streamed passes over the source
    (:func:`repro_torch.core.randomized.estimate_rank`), so it runs only
    where the answer changes the plan (roof-bound sweeps, where the
    greedy-vs-sketch pass-count comparison needs a rank) and only when
    on-device probing is enabled (``REPRO_ROOFLINE_MEASURE=0`` also opts
    out of this).  Returns None when the source can't be probed
    (decision-level callers pass placeholder sources: a path that is no
    ``.npy`` file, an object that is no matrix) or the estimate saturated
    (a lower bound must not become a cap).  The returned cap carries 25%
    + sketch_p headroom: the build's own tau stop remains the authority,
    the cap just bounds planning and the Q allocation.
    """
    from repro_torch.core.randomized import estimate_rank

    try:
        est = estimate_rank(spec.source, tau=float(spec.tau),
                            seed=spec.sketch_seed, kind=spec.sketch_kind,
                            tile_m=spec.tile_m, backend=spec.backend,
                            device=spec.device)
    except (OSError, TypeError, ValueError) as e:
        logger.info("rank estimation skipped (%s)", e)
        return None
    if est.saturated:
        logger.info("rank estimate saturated at ell=%d; not capping",
                    est.ell)
        return None
    cap = -(-est.k * 5 // 4) + spec.sketch_p
    cap = min(cap, int(shape[0]), int(shape[1]))
    logger.info("sketch-estimated rank ~%d (ell=%d, %d pass(es)) -> "
                "planning max_k=%d", est.k, est.ell, est.passes, cap)
    return cap


def _auto_strategy(spec: ReductionSpec, shape, dtype):
    """Resolve ``"auto"`` to ``(strategy, block_p, max_k)`` and log the
    decision: the reference's order of decisions, on the spec's device.
    ``max_k`` is ``spec.max_k`` unless the caller gave none and a
    sketch-based rank estimate filled one in (:func:`_estimated_max_k`)."""
    from repro_torch.api.roofline import roofline_measurement_enabled

    block_p = spec.block_p
    max_k = spec.max_k
    if spec.mesh is not None:
        logger.info("auto strategy -> 'distributed' for shape %s %s (a mesh "
                    "was passed)", tuple(shape),
                    str(torch_dtype(dtype)).removeprefix("torch."))
        return "distributed", block_p, max_k
    need = _resident_bytes(shape, dtype, spec.max_k)
    budget = (spec.memory_budget_bytes
              if spec.memory_budget_bytes is not None
              else device_memory_budget(spec.device))
    roof_bound, roof_why = _sweep_roofline(shape, dtype, spec)
    fits = need <= budget
    fit_why = (f"resident footprint ~{need / 1e6:.0f} MB "
               f"{'fits' if fits else 'exceeds'} the device budget "
               f"~{budget / 1e6:.0f} MB")
    if roof_bound and block_p == 1:
        block_p = _AUTO_BLOCK_P
    choice = ("block_greedy" if roof_bound else "greedy") if fits \
        else "streamed"
    why = f"{fit_why}; {roof_why}"
    if roof_bound:
        why += f"; blocked sweep, block_p={block_p}"
    # On a roof-bound sweep every basis costs ~1/block_p of a DRAM read of
    # S, so a greedy build streams S ~ceil(max_k / block_p) times; the
    # one-pass sketch pays 1 + 2*sketch_power passes regardless of k.  When
    # a rank target exists (given, or sketch-estimated when probing is
    # enabled) and greedy's pass count exceeds TWICE the sketch's, the
    # range-finder wins even after paying its probabilistic-vs-exact error
    # margin.
    if roof_bound and max_k is None and roofline_measurement_enabled():
        max_k = _estimated_max_k(spec, shape)
        if max_k is not None:
            why += f"; sketch-estimated max_k={max_k}"
    if roof_bound and max_k is not None:
        greedy_passes = -(-max_k // max(block_p, 1))
        sketch_passes = 1 + 2 * spec.sketch_power
        if greedy_passes > 2 * sketch_passes:
            choice = "randomized"
            block_p = spec.block_p  # blocking is a greedy-only knob
            why += (f"; ~{greedy_passes} greedy passes over S vs "
                    f"{sketch_passes} sketch pass(es) -> randomized")
    logger.info(
        "auto strategy -> %r for shape %s %s (%s)",
        choice, tuple(shape), str(torch_dtype(dtype)).removeprefix("torch."),
        why,
    )
    return choice, block_p, max_k


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


def _build_distributed(spec, prov, ckpt_dir=None):
    from repro_torch.core.distributed import distributed_greedy

    if spec.mesh is None:
        raise ValueError('strategy "distributed" requires spec.mesh')
    N, M = prov.shape
    max_k = min(N, M) if spec.max_k is None else spec.max_k
    return _trim_greedy(distributed_greedy(
        prov, tau=spec.tau, max_k=max_k, mesh=spec.mesh,
        callback=spec.callback, refresh=spec.refresh,
        refresh_safety=spec.refresh_safety, kappa=spec.kappa,
        max_passes=spec.max_passes, chunk=spec.chunk, backend=spec.backend,
        block_p=spec.block_p, panel_ortho=spec.panel_ortho,
        checkpoint_dir=ckpt_dir, resume=spec.resume, device=prov.device,
    ))


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


# strategies that read their source's tiles instead of materializing it
# (``distributed``: each rank materializes only its own columns)
_STREAMING_STRATEGIES = ("streamed", "randomized", "sketch+greedy",
                         "distributed")


def _is_batched_workload(spec: ReductionSpec) -> bool:
    """Does this spec describe a many-basis (B-lane) build?

    True when ``spec.batch`` is set, or the source is inherently B-laned:
    a (B, N, M) stacked array, a list or tuple of per-lane sources, or a
    :class:`~repro_torch.data.bands.BandSplit` (a tuple too).
    """
    if spec.batch is not None:
        return True
    src = spec.source
    if isinstance(src, (list, tuple)):
        return True
    return getattr(src, "ndim", None) == 3


_BUILDERS = {
    "greedy": _build_greedy,
    "block_greedy": _build_block_greedy,
    "distributed": _build_distributed,
    "streamed": _build_streamed,
    "randomized": _build_randomized,
    "sketch+greedy": _build_sketch_greedy,
    "mgs": _build_mgs,
    "pod": _build_pod,
}


def _spec_of(spec, kwargs, caller: str) -> ReductionSpec:
    if spec is None:
        spec = ReductionSpec(**kwargs)
    elif kwargs:
        spec = dataclasses.replace(spec, **kwargs)
    if not isinstance(spec, ReductionSpec):
        raise TypeError(
            f"{caller} takes a ReductionSpec (or keyword args), got "
            f"{type(spec).__name__}")
    return spec


def build_basis(spec: ReductionSpec | None = None, **kwargs):
    """Build a reduced basis.

    Call with a :class:`ReductionSpec`, keyword arguments, or both (the
    keywords override spec fields)::

        basis = build_basis(source=S, tau=1e-6)              # on cuda, auto
        basis = build_basis(source=S, tau=1e-6, device="cpu")

    Returns a :class:`ReducedBasis` trimmed to the accepted rank, with
    build provenance attached.  ``"auto"`` decides on the source's shape
    and dtype before it is materialized, so a source past the device
    budget is streamed.  A many-basis workload (``strategy="batched"``, or
    ``"auto"`` with ``batch=`` or a (B, N, M), list, tuple or
    :class:`~repro_torch.data.bands.BandSplit` source) goes to
    :func:`build_basis_set` and returns its
    :class:`~repro_torch.api.basis_set.ReducedBasisSet` of B children.
    """
    spec = _spec_of(spec, kwargs, "build_basis")

    # A many-basis workload returns a set: decide BEFORE touching providers
    # (a stacked 3-D source is not a valid single-basis one).
    if spec.strategy == "batched":
        return build_basis_set(spec)
    if spec.strategy == "auto" and _is_batched_workload(spec):
        logger.info("auto strategy -> 'batched' (batch=%s, %s source)",
                    spec.batch, type(spec.source).__name__)
        return build_basis_set(spec)

    from repro_torch.core.backend import resolve_backend
    from repro_torch.data.providers import as_provider, materialize_source

    device = resolve_device(spec.device)
    # Under a mesh every rank of it makes this call: rank 0 alone writes
    # the workdir, and the others wait for it.
    writer = True
    if spec.mesh is not None:
        from repro_torch.core.distributed import barrier, is_writer

        writer = is_writer(spec.mesh)
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
                if writer:
                    shutil.rmtree(build_dir, ignore_errors=True)
                logger.info("workdir %s already holds a finalized basis; "
                            "returning it", spec.workdir)
                return basis
        elif writer:
            # A fresh build must not splice onto a previous run's steps.
            shutil.rmtree(build_dir, ignore_errors=True)
        if spec.mesh is not None:
            barrier(spec.mesh)
    ckpt_dir = build_dir if build_dir is not None else spec.checkpoint_dir

    strategy = spec.strategy
    if strategy == "auto":
        # decide on the provider's shape and dtype: nothing is
        # materialized before the choice, so a source past the budget
        # never lands on the device
        prov = as_provider(spec.source, device)
        strategy, auto_p, auto_k = _auto_strategy(spec, prov.shape,
                                                  prov.dtype)
        if auto_p != spec.block_p:
            # the roofline model opted into blocking: the chosen panel
            # width must reach the driver (and the provenance)
            spec = dataclasses.replace(spec, block_p=auto_p)
        if auto_k != spec.max_k:
            # a sketch-estimated rank cap (with headroom) must reach the
            # chosen driver: the randomized builder sizes its sketch from
            # it, the greedy family bounds Q with it
            spec = dataclasses.replace(spec, max_k=auto_k)
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
        if writer:
            basis.save(spec.workdir)
            shutil.rmtree(build_dir, ignore_errors=True)
        if spec.mesh is not None:
            barrier(spec.mesh)
    return basis


def build_basis_set(spec: ReductionSpec | None = None, **kwargs):
    """Build B reduced bases in one lockstep pass.

    The many-basis front door: takes a stacked (B, N, M) source, a list or
    tuple of per-lane sources, a :class:`~repro_torch.data.bands.
    BandSplit` (a banded workload), or a shared (N, M) source with
    ``batch=B`` or a length-B ``tau`` (a tau sweep over one matrix).  Runs
    :func:`repro_torch.core.batch_greedy.batch_rb_greedy` on the spec's
    device and returns a :class:`~repro_torch.api.basis_set.
    ReducedBasisSet` whose children are bitwise B scalar
    ``strategy="greedy"`` builds, in both layouts.

    With ``workdir=`` the finished set is saved there (``set.json`` last);
    ``resume=True`` returns a set already finalized there without
    rebuilding.  :func:`build_basis` delegates here for
    ``strategy="batched"`` and for ``"auto"`` on a batched workload.
    """
    from repro_torch.api.basis_set import ReducedBasisSet
    from repro_torch.core.backend import resolve_backend
    from repro_torch.core.batch_greedy import _batched_source, batch_rb_greedy
    from repro_torch.data.bands import BandSplit

    spec = _spec_of(spec, kwargs, "build_basis_set")
    if spec.strategy not in ("batched", "auto"):
        raise ValueError(
            f"build_basis_set builds the batched strategy, got "
            f"{spec.strategy!r}")
    device = resolve_device(spec.device)
    if spec.workdir is not None and spec.resume:
        try:
            bset = ReducedBasisSet.load(spec.workdir, device)
        except (FileNotFoundError, IOError):
            pass  # nothing finalized yet: build below
        else:
            logger.info("workdir %s already holds a finalized basis set; "
                        "returning it", spec.workdir)
            return bset

    src = spec.source
    bands_meta = None
    if isinstance(src, BandSplit):
        bands_meta = {
            "edges": [[int(lo), int(hi)] for lo, hi in src.edges],
            "n_freq": int(src.n_freq),
            "from_real": bool(src.from_real),
        }
        src = src.stack
    S = _batched_source(src, device)

    t0 = time.perf_counter()
    res = batch_rb_greedy(
        S, spec.tau, max_k=spec.max_k, batch=spec.batch, kappa=spec.kappa,
        max_passes=spec.max_passes, refresh=spec.refresh,
        refresh_safety=spec.refresh_safety, chunk=spec.chunk,
        backend=spec.backend, callback=spec.callback, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    from repro_torch import __version__

    B = res.batch
    taus = np.broadcast_to(
        np.atleast_1d(np.asarray(spec.tau, dtype=np.float64)), (B,))
    base = {
        "strategy": "batched",
        "requested_strategy": spec.strategy,
        "backend": resolve_backend(spec.backend),
        "device": device.type,
        "batch": B,
        "layout": "stacked" if S.dim() == 3 else "shared",
        "dtype": str(S.dtype).removeprefix("torch."),
        "shape": [int(S.shape[-2]), int(S.shape[-1])],
        "tau": [float(t) for t in taus],
        "max_k": spec.max_k,
        "lockstep": {"rounds": res.rounds, "live_rounds": res.live_rounds,
                     "chunks": res.chunks, "refreshes": res.refreshes},
        "wall_time_s": wall,
        "spec": spec.describe(),
        "repro_version": __version__,
        **({"bands": bands_meta} if bands_meta is not None else {}),
    }
    children = []
    for b in range(B):
        Q, pivots, errs, R, k, extras = _trim_greedy(res.lane(b))
        prov = dict(base)
        prov["lane"] = {"index": b, "tau": float(taus[b]), **extras}
        children.append(ReducedBasis(Q=Q, pivots=pivots, errs=errs, k=k,
                                     R=R, provenance=prov))
    bset = ReducedBasisSet(children=tuple(children), provenance=base)
    if spec.workdir is not None:
        bset.save(spec.workdir)
    return bset
