"""Admission control for the ROQ serving engine: quotas, shedding, breakers.

Port of :mod:`repro.serving.admission` (no JAX in it: copied as it is).
The engine's bounded queue is the *last* line of overload defense —
by the time :class:`~repro_torch.serving.roq.QueueFullError` fires, every
accepted request is already paying queueing delay.  This module is the
layer in FRONT of ``submit``:

- **Per-client token-bucket quotas** — each ``client_id`` draws from its
  own :class:`TokenBucket` (``client_rate`` req/s refill, ``client_burst``
  capacity); an empty bucket rejects with :class:`QuotaExceededError`
  *before* the request touches the queue, so one chatty client cannot
  starve the rest.  Requests without a ``client_id`` share one anonymous
  bucket.  Quotas are off until a rate is configured.
- **Deadline-aware shedding** — a request whose deadline is *already*
  hopeless given the estimated queue delay (backlog batches x the EWMA
  batch service time, supplied by the engine) is rejected with
  :class:`ShedError` instead of occupying a batch slot it can only
  time out in.  Hopeless work never displaces feasible work.
- **Degraded mode** — when the engine reports pressure past the
  configured watermarks (queue depth fraction, p95 latency), quotas
  tighten by ``degraded_factor`` until pressure clears (with hysteresis,
  so the mode doesn't flap at the watermark).  Entered/exited transitions
  are counted in the serving metrics.
- **Per-basis circuit breakers** — :class:`CircuitBreakerBoard` tracks
  consecutive *batch* failures per basis.  ``threshold`` consecutive
  failures OPEN the breaker: new requests fast-fail with
  :class:`CircuitOpenError` instead of queueing behind a basis that
  cannot serve.  After ``cooldown_s`` the next request flips it
  HALF_OPEN and a bounded probe batch is admitted; a served probe
  CLOSEs the breaker, a failed one re-OPENs it with a fresh cooldown.
  Every transition is counted.

All state is engine-internal and thread-safe; none of it touches the
worker's hot path beyond one lock acquisition per submit.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class ShedError(RuntimeError):
    """Admission shed: the request's deadline is already hopeless given
    the estimated queue delay — rejected instead of queued to time out."""


class QuotaExceededError(RuntimeError):
    """Per-client token bucket empty: the client is over its quota."""


class CircuitOpenError(RuntimeError):
    """The target basis's circuit breaker is open (recent consecutive
    batch failures); requests fast-fail instead of queueing."""


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``.

    Not self-locking — the owning controller serializes access."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = now

    def try_acquire(self, now: float, *, rate_scale: float = 1.0) -> bool:
        """Take one token if available (refilled at ``rate*rate_scale``)."""
        self.tokens = min(
            self.burst,
            self.tokens + (now - self.t_last) * self.rate * rate_scale)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AdmissionController:
    """Quotas + shedding + degraded mode, consulted by ``submit``.

    Args:
      client_rate: per-client steady admission rate (req/s); ``None``
        disables quotas entirely.
      client_burst: bucket capacity (default ``max(2*client_rate, 4)``).
      degraded_factor: multiplier on the refill rate while degraded.
      delay_estimator: callable returning the engine's current estimated
        queue delay in seconds (0 = no backlog / no history yet).
      metrics: a :class:`~repro_torch.serving.metrics.ServingMetrics` (or None)
        that receives the ``degraded_entered``/``degraded_exited``
        counters and the ``degraded`` gauge.
    """

    def __init__(self, *, client_rate: Optional[float] = None,
                 client_burst: Optional[float] = None,
                 degraded_factor: float = 0.5,
                 delay_estimator: Optional[Callable[[], float]] = None,
                 metrics=None):
        if client_rate is not None and client_rate <= 0:
            raise ValueError("client_rate must be positive (or None)")
        self.client_rate = client_rate
        self.client_burst = (float(client_burst) if client_burst is not None
                             else max(2.0 * (client_rate or 0.0), 4.0))
        self.degraded_factor = float(degraded_factor)
        self._delay_estimator = delay_estimator or (lambda: 0.0)
        self._metrics = metrics
        self._buckets: dict = {}
        self._degraded = False
        self._lock = threading.Lock()

    # ----------------------------------------------------------- intake ----
    def admit(self, client_id, deadline: Optional[float],
              now: Optional[float] = None) -> None:
        """Raise :class:`QuotaExceededError` / :class:`ShedError`, or
        return to admit.  ``deadline`` is absolute ``perf_counter`` time
        (None = no deadline, never shed)."""
        if now is None:
            now = time.perf_counter()
        if self.client_rate is not None:
            with self._lock:
                bucket = self._buckets.get(client_id)
                if bucket is None:
                    bucket = TokenBucket(self.client_rate,
                                         self.client_burst, now)
                    self._buckets[client_id] = bucket
                scale = self.degraded_factor if self._degraded else 1.0
                ok = bucket.try_acquire(now, rate_scale=scale)
            if not ok:
                if self._metrics is not None:
                    self._metrics.count("quota_rejected")
                raise QuotaExceededError(
                    f"client {client_id!r} over quota "
                    f"({self.client_rate:g} req/s, burst "
                    f"{self.client_burst:g}"
                    + (", degraded" if self._degraded else "") + ")")
        if deadline is not None:
            est = self._delay_estimator()
            if est > 0.0 and deadline - now < est:
                if self._metrics is not None:
                    self._metrics.count("shed")
                raise ShedError(
                    f"estimated queue delay {est * 1e3:.1f}ms exceeds the "
                    f"request's remaining {max(deadline - now, 0) * 1e3:.1f}"
                    f"ms deadline; shed instead of queued to time out")

    # --------------------------------------------------------- pressure ----
    def set_degraded(self, degraded: bool, reason: str = "") -> bool:
        """Flip degraded mode; returns True if the state changed."""
        with self._lock:
            if degraded == self._degraded:
                return False
            self._degraded = degraded
        if self._metrics is not None:
            self._metrics.count(
                "degraded_entered" if degraded else "degraded_exited")
            self._metrics.set_gauge("degraded", int(degraded))
        return True

    @property
    def degraded(self) -> bool:
        return self._degraded

    def stats(self) -> dict:
        with self._lock:
            return {
                "quotas_enabled": self.client_rate is not None,
                "client_rate": self.client_rate,
                "client_burst": (self.client_burst
                                 if self.client_rate is not None else None),
                "degraded": self._degraded,
                "degraded_factor": self.degraded_factor,
                "clients_tracked": len(self._buckets),
            }


# ------------------------------------------------------------- breakers ----

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class _Breaker:
    __slots__ = ("state", "consecutive_failures", "opened_at",
                 "probes_admitted", "probe_inflight")

    def __init__(self):
        self.state = _CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.probes_admitted = 0
        self.probe_inflight = False


class CircuitBreakerBoard:
    """Per-basis circuit breakers over consecutive batch failures.

    Args:
      threshold: consecutive batch failures that OPEN a basis's breaker.
      cooldown_s: OPEN -> HALF_OPEN after this long without traffic
        being admitted.
      probe_budget: requests admitted in HALF_OPEN before fast-failing
        again (the engine passes ``max_batch`` so the probe is one batch).
      metrics: receives ``breaker_opened`` / ``breaker_half_open`` /
        ``breaker_closed`` / ``breaker_rejected`` counters.
    """

    def __init__(self, *, threshold: int = 5, cooldown_s: float = 5.0,
                 probe_budget: int = 1, metrics=None):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.probe_budget = max(int(probe_budget), 1)
        self._metrics = metrics
        self._breakers: dict[str, _Breaker] = {}
        self._lock = threading.Lock()

    def _count(self, name: str) -> None:
        if self._metrics is not None:
            self._metrics.count(name)

    def allow(self, basis_id: str, now: Optional[float] = None) -> None:
        """Admit a request for ``basis_id`` or raise
        :class:`CircuitOpenError` (counted as ``breaker_rejected``)."""
        if now is None:
            now = time.perf_counter()
        with self._lock:
            br = self._breakers.get(basis_id)
            if br is None or br.state == _CLOSED:
                return
            if br.state == _OPEN:
                if now - br.opened_at < self.cooldown_s:
                    remaining = self.cooldown_s - (now - br.opened_at)
                    self._count("breaker_rejected")
                    raise CircuitOpenError(
                        f"circuit for basis {basis_id!r} is open "
                        f"({br.consecutive_failures} consecutive batch "
                        f"failures); probe in {remaining * 1e3:.0f}ms")
                br.state = _HALF_OPEN
                br.probes_admitted = 0
                br.probe_inflight = False
                self._count("breaker_half_open")
            # HALF_OPEN: admit up to probe_budget requests for ONE probe
            # batch; everything else fast-fails until the probe resolves.
            if br.probes_admitted < self.probe_budget \
                    and not br.probe_inflight:
                br.probes_admitted += 1
                return
            self._count("breaker_rejected")
            raise CircuitOpenError(
                f"circuit for basis {basis_id!r} is half-open with its "
                f"probe batch in flight; fast-failing until it resolves")

    def on_batch_start(self, basis_id: str) -> None:
        """The worker is evaluating a batch for ``basis_id`` — in
        HALF_OPEN this freezes further probe admissions until the batch
        resolves one way or the other."""
        with self._lock:
            br = self._breakers.get(basis_id)
            if br is not None and br.state == _HALF_OPEN:
                br.probe_inflight = True

    def record_success(self, basis_id: str) -> None:
        with self._lock:
            br = self._breakers.get(basis_id)
            if br is None:
                return
            if br.state == _HALF_OPEN:
                self._count("breaker_closed")
            br.state = _CLOSED
            br.consecutive_failures = 0
            br.probe_inflight = False

    def record_failure(self, basis_id: str,
                       now: Optional[float] = None) -> None:
        if now is None:
            now = time.perf_counter()
        with self._lock:
            br = self._breakers.setdefault(basis_id, _Breaker())
            br.consecutive_failures += 1
            br.probe_inflight = False
            if br.state == _HALF_OPEN or (
                    br.state == _CLOSED
                    and br.consecutive_failures >= self.threshold):
                br.state = _OPEN
                br.opened_at = now
                self._count("breaker_opened")

    def state(self, basis_id: str) -> str:
        with self._lock:
            br = self._breakers.get(basis_id)
            return br.state if br is not None else _CLOSED

    def stats(self) -> dict:
        with self._lock:
            return {
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "states": {bid: br.state
                           for bid, br in self._breakers.items()
                           if br.state != _CLOSED
                           or br.consecutive_failures > 0},
            }
