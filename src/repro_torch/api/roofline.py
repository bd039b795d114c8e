"""One-time on-device roofline measurement for the ``"auto"`` strategy.

Port of :mod:`repro.api.roofline`.  The roofline model classifies the
Eq.-(6.3) pivot sweep with per-device default roofs; the block/stepwise
and greedy/sketch cutovers want the numbers of THIS device.
:func:`measured_roofline` spends ~100 ms once per process and device to
get them:

  bandwidth   one f32 Eq.-(6.3) sweep (:func:`repro_torch.core.backend.
              pivot_update`: the ``greedy_update`` kernel on a card) over
              a snapshot matrix sized past any last-level cache (one read
              of S per call), so ``bytes / seconds`` is the streaming rate
              the real sweep sees — the same access pattern, not a
              synthetic triad,
  peak FLOPs  one square f32 GEMM (``torch.matmul``; TF32 stays off, see
              :mod:`repro_torch.device`), ``2 n^3 / seconds``.

Both are timed best-of-N from a steady state (consecutive repeats, minimum
taken): with CUDA events on a card, a spin kernel queued ahead so that the
time is the card's alone, and with ``perf_counter`` on the CPU.  A
successful measurement is cached for the process lifetime, per device.

Knob precedence stays as documented on
:func:`repro_torch.api.build.machine_roofline`: an explicit spec field or
``REPRO_DRAM_BW_GBPS`` / ``REPRO_PEAK_GFLOPS`` env var always wins;
measurement only fills knobs nobody pinned.  ``REPRO_ROOFLINE_MEASURE=0``
opts out entirely (falling back to the per-device defaults) — the test
suite sets it to keep ``"auto"`` decisions deterministic.  The measured
numbers are logged once on logger ``repro_torch.api``.
"""

from __future__ import annotations

import functools
import logging
import os
import time

import torch

from repro_torch.device import resolve_device

logger = logging.getLogger("repro_torch.api")

_ENV_MEASURE = "REPRO_ROOFLINE_MEASURE"

# Sweep operand sized to defeat any plausible LLC (128 MB f32, past the
# H100's 50 MB L2) while keeping the whole calibration ~100 ms at
# laptop-class bandwidth; the GEMM is large enough to reach a steady FMA
# rate but small next to the sweep.
_SWEEP_SHAPE = (2048, 16384)     # 128 MB f32 + re-read per call
_GEMM_N = 512                    # 2 * 512^3 = 268 MFLOP per call
_REPEATS = 5
_WARMUP = 2
# cycles of the spin kernel queued before each timed call on a card (~0.5
# ms): the host issues the call's launches while the card spins, so the
# events time the card's work alone
_SPIN_CYCLES = 1_000_000


def roofline_measurement_enabled() -> bool:
    """Whether ``"auto"`` may spend ~100 ms measuring the machine roofs.

    ``REPRO_ROOFLINE_MEASURE=0`` (or empty/false-y) disables; default on.
    """
    raw = os.environ.get(_ENV_MEASURE, "1").strip().lower()
    return raw not in ("0", "false", "no", "off", "")


def _steady_min(fn, repeats: int = _REPEATS, warmup: int = _WARMUP,
                device=None) -> float:
    """Best-of-``repeats`` seconds per call of ``fn``, timed consecutively
    from a steady state: CUDA events around each call on a CUDA
    ``device`` (a spin kernel queued before the start event, so the time
    is the card's alone), ``perf_counter`` on the CPU, whose ops return
    when done."""
    dev = torch.device("cpu" if device is None else device)
    for _ in range(warmup):
        fn()
    best = float("inf")
    if dev.type != "cuda":
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _device_key(device) -> str:
    """The cache key of a device: ``"cpu"`` or ``"cuda:<index>"``."""
    return str(resolve_device(device))


@functools.lru_cache(maxsize=None)
def _measure_roofline_once(device: str = "cuda") -> tuple[float, float]:
    """The raw calibration on ``device``.  RAISES on failure —
    ``lru_cache`` does not memoize exceptions, so a failed attempt is
    retried on the next call while a successful measurement is cached for
    the process lifetime."""
    from repro_torch.core.backend import pivot_update

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    N, M = _SWEEP_SHAPE
    S = torch.randn((N, M), generator=gen, device=dev)
    q = torch.randn((N,), generator=gen, device=dev)
    q = q / torch.linalg.vector_norm(q)
    norms = (S * S).sum(0)
    acc = torch.zeros((M,), device=dev)
    t_sweep = _steady_min(lambda: pivot_update(q, S, acc, norms),
                          device=dev)
    # one read of S dominates the sweep's traffic (q, acc, norms are
    # O(N + M) next to N*M)
    bw_gbps = (N * M * 4) / t_sweep / 1e9
    del S, norms

    A = torch.randn((_GEMM_N, _GEMM_N), generator=gen, device=dev)
    B = torch.randn((_GEMM_N, _GEMM_N), generator=gen, device=dev)
    t_gemm = _steady_min(lambda: torch.matmul(A, B), device=dev)
    gflops = (2.0 * _GEMM_N ** 3) / t_gemm / 1e9

    logger.info(
        "measured roofline on %s: %.1f GB/s DRAM, %.1f GFLOP/s peak "
        "(one-time ~100 ms calibration; REPRO_ROOFLINE_MEASURE=0 or "
        "REPRO_DRAM_BW_GBPS/REPRO_PEAK_GFLOPS override to skip)",
        dev, bw_gbps, gflops,
    )
    return (float(bw_gbps), float(gflops))


def measured_roofline(device=None) -> tuple[float, float]:
    """Measure (DRAM bandwidth GB/s, peak GFLOP/s) on ``device`` (``cuda``
    unless asked).

    A successful measurement is cached per process and device.  Call
    :func:`roofline_measurement_enabled` first — this function always
    measures.  On failure it returns the ``(0.0, 0.0)`` sentinel; callers
    must treat non-positive values as "not measured".  Failures are NOT
    cached: one transient calibration hiccup must not disable measured
    roofs for the process lifetime, so the next call simply retries.
    """
    try:
        return _measure_roofline_once(_device_key(device))
    except Exception as e:  # never let calibration break a build
        logger.warning("roofline measurement failed (%s); falling back to "
                       "device defaults", e)
        return (0.0, 0.0)


# The process-lifetime cache is an observable behavior (tests and callers
# reset it between scenarios); expose the underlying cache controls on
# the public wrapper.
measured_roofline.cache_clear = _measure_roofline_once.cache_clear
measured_roofline.cache_info = _measure_roofline_once.cache_info


# ------------------------------------------------- LLC self-calibration ----
# The third roofline knob.  _sweep_roofline's "sweep_bytes > cache" test
# decides whether Eq.-(6.3) traffic actually hits DRAM.  The working-set
# sweep below finds the cache size empirically: stream working sets of
# doubling size and locate the bandwidth cliff where they stop fitting in
# the last-level cache.

_CACHE_SIZES_MB = (1, 2, 4, 8, 16, 32, 64, 128)
# constant traffic per timed call (repeats scale inversely with size) so
# small working sets aren't drowned by dispatch overhead
_CACHE_TRAFFIC_MB = 64
# a real LLC->DRAM transition drops streaming rate well over 1.5x; less
# contrast than this is noise
_CACHE_MIN_CONTRAST = 1.5


def _timed_stream_rate(n: int, reps: int, device=None) -> float:
    """Effective streaming GB/s over an ``n``-float working set: ``reps``
    reads of it, ``reps * 4n`` bytes a call.

    On a card the reads are one launch of the ``llc_probe`` kernel (a
    torch op a pass would be launch-bound at the small working sets, and
    hide the cliff); on the CPU its plain version, a loop of
    ``torch.dot``.
    """
    from repro_torch.kernels.llc_probe.ops import llc_probe

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n,), generator=gen, device=dev)
    t = _steady_min(lambda: llc_probe(x, reps), repeats=3, warmup=1,
                    device=dev)
    return (reps * 4.0 * n) / t / 1e9


def _stream_rates(device=None) -> list[float]:
    """``_timed_stream_rate`` at each of ``_CACHE_SIZES_MB``."""
    rates = []
    for mb in _CACHE_SIZES_MB:
        n = mb * (1 << 20) // 4
        reps = max(1, _CACHE_TRAFFIC_MB // mb)
        rates.append(_timed_stream_rate(n, reps, device))
    return rates


@functools.lru_cache(maxsize=None)
def _measure_cache_once(device: str = "cuda") -> int:
    """The raw LLC sweep on ``device``.  Returns the ``0`` sentinel when no
    cliff is visible — that is a STABLE property of the device, so unlike
    a transient calibration exception it IS cached for the process
    lifetime; real exceptions propagate uncached and retry on the next
    call."""
    rates = _stream_rates(device)
    # DRAM floor from the largest working sets; cache ceiling from the
    # fastest point.  No real contrast -> the machine (or this timer)
    # cannot resolve the cache; the caller falls back to defaults.
    dram = min(rates[-2:])
    peak = max(rates)
    if not (dram > 0 and peak / dram >= _CACHE_MIN_CONTRAST):
        logger.info(
            "no LLC bandwidth cliff visible (peak %.1f vs DRAM %.1f GB/s "
            "over %s MB working sets); using the device's default cache "
            "size", peak, dram, list(_CACHE_SIZES_MB))
        return 0
    # the cache edge: last size still streaming above the geometric
    # mean of the cache-resident and DRAM rates
    threshold = (peak * dram) ** 0.5
    cache_mb = max(mb for mb, r in zip(_CACHE_SIZES_MB, rates)
                   if r >= threshold)
    logger.info(
        "measured LLC ~%d MB (stream rates %s GB/s over %s MB working "
        "sets; REPRO_LLC_BYTES overrides)",
        cache_mb, [f"{r:.0f}" for r in rates], list(_CACHE_SIZES_MB),
    )
    return cache_mb * (1 << 20)


def measured_cache_bytes(device=None) -> int:
    """Measure the last-level-cache size of ``device`` (``cuda`` unless
    asked) by working-set sweep.

    Returns the bytes of the largest working set that still streams at
    cache-resident rate, or ``0`` when no cache cliff is detectable
    (callers must treat non-positive as "not measured" and fall back).
    Both outcomes are cached per process and device, while genuine
    measurement exceptions retry on the next call.  Respect
    :func:`roofline_measurement_enabled` before calling — this function
    always measures.
    """
    try:
        return _measure_cache_once(_device_key(device))
    except Exception as e:  # never let calibration break a build
        logger.warning("LLC measurement failed (%s); falling back to "
                       "the device's default cache size", e)
        return 0


measured_cache_bytes.cache_clear = _measure_cache_once.cache_clear
measured_cache_bytes.cache_info = _measure_cache_once.cache_info
