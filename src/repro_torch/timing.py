"""Steady-state timing: the wall-clock method the port's reports use.

Port of :mod:`repro.timing`.  Warm up, then time CONSECUTIVE repeats (hot
allocator and caches — what a production driver loop experiences) and
take the MINIMUM, which rejects load spikes and unlucky thread placement.
A CUDA call returns before the card has finished, so the timed function
must synchronize the device itself (``torch.cuda.synchronize()``, or read
a result back to the host) before it returns.
"""

from __future__ import annotations

import time


def steady_min(fn, per: int = 1, repeats: int = 12, warmup: int = 3) -> float:
    """Best-of-``repeats`` steady-state seconds per iteration.

    ``fn`` performs ``per`` hot-loop iterations and must synchronize the
    device on its outputs before returning.
    """
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best / per


def percentiles(samples, qs=(50.0, 95.0, 99.0)) -> dict:
    """Percentiles of ``samples`` by sorted linear interpolation.

    The one quantile method every latency report uses (serving metrics
    snapshots included).  ``qs`` are percent ranks in [0, 100]; returns
    ``{q: value}`` with the values linearly interpolated between order
    statistics (numpy's default "linear" method), so ``percentiles(s,
    (0, 50, 100))`` gives min / median / max exactly.

    Raises ``ValueError`` on an empty sample set or an out-of-range q —
    an empty latency window is a caller-level condition (report "no
    samples", don't fabricate a 0.0 percentile).
    """
    xs = sorted(float(x) for x in samples)
    if not xs:
        raise ValueError("percentiles() of empty sample set")
    out = {}
    n = len(xs)
    for q in qs:
        fq = float(q)
        if not 0.0 <= fq <= 100.0:
            raise ValueError(f"percentile rank {q!r} outside [0, 100]")
        pos = (fq / 100.0) * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        out[q] = xs[lo] + (xs[hi] - xs[lo]) * frac
    return out
