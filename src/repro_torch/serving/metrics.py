"""Serving observability: counters, gauges, and latency reservoirs.

Port of :mod:`repro.serving.metrics` (no JAX in it: copied as it is).
One :class:`ServingMetrics` instance rides along with each
:class:`~repro_torch.serving.roq.ROQEngine`.  Every event on the request path
increments a counter here (submit / reject / timeout / error / complete,
batch flushes, interpolant-cache hits and misses, router loads and
evictions), per-request latencies and batch occupancies land in bounded
reservoirs, and :meth:`snapshot` rolls the lot into a JSON-friendly dict
with p50/p95/p99 latency via :func:`repro_torch.timing.percentiles` — the same
quantile code the load harness uses, so benchmark rows and engine
snapshots can never disagree on method.

Thread-safety: the engine worker and any number of submitting threads
touch the same instance, so every mutation takes the one internal lock.
The reservoirs keep the most recent ``window`` samples (deque) — a
long-running engine reports *recent* tail latency, not the all-time mix.
"""

from __future__ import annotations

import collections
import threading
import time

from repro_torch.timing import percentiles

# Counter names, fixed so snapshots are schema-stable for dashboards/tests.
COUNTERS = (
    "submitted",        # accepted onto the queue
    "rejected",         # backpressure: queue full at submit time
    "completed",        # future resolved with a result
    "errors",           # future resolved with an exception (incl. injected)
    "timeouts",         # request deadline expired before evaluation
    "batches",          # batch flushes (one interpolant evaluation each)
    "cache_hits",       # warm interpolant-cache entry served the batch
    "cache_misses",     # first batch of a (basis, generation, bucket, dtype)
    "basis_loads",      # router loaded an artifact from disk
    "basis_evictions",  # router dropped an LRU basis under memory pressure
    # --- admission control ---
    "shed",             # deadline-aware shed: hopeless request rejected
    "quota_rejected",   # per-client token bucket empty at submit time
    "degraded_entered",  # admission tightened (watermark crossed)
    "degraded_exited",   # admission relaxed (pressure cleared)
    # --- per-basis circuit breakers ---
    "breaker_rejected",   # request fast-failed on an open breaker
    "breaker_opened",     # CLOSED/HALF_OPEN -> OPEN transitions
    "breaker_half_open",  # OPEN -> HALF_OPEN probe transitions
    "breaker_closed",     # HALF_OPEN -> CLOSED (probe served)
    # --- engine supervision ---
    "worker_deaths",    # exception escaped the batching loop
    "worker_restarts",  # supervision brought the worker back
    # --- hot artifact reload ---
    "reloads",          # router generation swaps (refresh succeeded)
    "reload_failures",  # refresh found a corrupt/unloadable candidate
)


class ServingMetrics:
    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._counts = {name: 0 for name in COUNTERS}
        self._latency_s = collections.deque(maxlen=window)
        self._occupancy = collections.deque(maxlen=window)
        self._queue_depth = 0
        self._gauges: dict[str, float] = {}
        self._started = time.perf_counter()

    # ------------------------------------------------------------ events ----
    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._latency_s.append(float(seconds))

    def observe_batch(self, size: int, bucket: int) -> None:
        """A flush of ``size`` live requests padded to ``bucket`` columns."""
        with self._lock:
            self._counts["batches"] += 1
            self._occupancy.append(size / float(max(bucket, 1)))

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = int(depth)

    def set_gauge(self, name: str, value: float) -> None:
        """Free-form gauges (``degraded``, breaker states, ...) — rolled
        into the snapshot under ``gauges``."""
        with self._lock:
            self._gauges[name] = value

    def recent_p95_ms(self) -> float | None:
        """p95 over the recent-latency window (ms) — the degraded-mode
        watermark input; None before the first completion."""
        with self._lock:
            lat = list(self._latency_s)
        if not lat:
            return None
        return percentiles(lat, (95.0,))[95.0] * 1e3

    # ---------------------------------------------------------- snapshot ----
    def snapshot(self) -> dict:
        """Point-in-time rollup (JSON-serializable).

        ``latency_ms`` holds p50/p95/p99 over the recent-latency window
        (``None`` before the first completion); ``throughput_rps`` is
        completions per wall-second since construction — a coarse
        whole-run rate, not a windowed one (the load harness measures its
        own steady-state rates).
        """
        with self._lock:
            counts = dict(self._counts)
            lat = list(self._latency_s)
            occ = list(self._occupancy)
            depth = self._queue_depth
            gauges = dict(self._gauges)
            elapsed = time.perf_counter() - self._started
        snap = {
            "counters": counts,
            "queue_depth": depth,
            "gauges": gauges,
            "latency_ms": None,
            "batch_occupancy_mean": (sum(occ) / len(occ)) if occ else None,
            "cache_hit_rate": None,
            "throughput_rps": counts["completed"] / elapsed
            if elapsed > 0 else 0.0,
        }
        if lat:
            pct = percentiles(lat, (50.0, 95.0, 99.0))
            snap["latency_ms"] = {
                "p50": pct[50.0] * 1e3,
                "p95": pct[95.0] * 1e3,
                "p99": pct[99.0] * 1e3,
                "n": len(lat),
            }
        probes = counts["cache_hits"] + counts["cache_misses"]
        if probes:
            snap["cache_hit_rate"] = counts["cache_hits"] / probes
        return snap
