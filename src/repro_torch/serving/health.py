"""Engine health and worker supervision policy for the serving layer.

Port of :mod:`repro.serving.health` (no JAX in it: copied as it is).  An
unsupervised worker thread has one failure mode with no story: an
exception escaping the batching/poll logic (outside the per-batch ``try``)
kills the thread silently — every submitted future hangs forever and
``submit`` keeps accepting new ones into the void.  This module gives the
engine the process supervisor's vocabulary, in process:

- :class:`HealthState` — a thread-safe healthy/unhealthy latch with a
  bounded transition log, surfaced through ``ROQEngine.healthy()`` and
  ``stats()["health"]`` (the readiness signal an ingress or probe reads).
- :class:`RestartPolicy` — the sliding-window restart budget + exponential
  backoff knobs (same semantics as the JAX package's
  ``launch/supervisor.py``: up to ``max_restarts`` within any ``window_s``
  span, ``backoff_base_s * 2**(restarts in window)`` capped at
  ``backoff_cap_s`` between restarts).
- :class:`RestartTracker` — the mechanism: ``next_delay()`` returns the
  backoff to sleep before the next restart, or ``None`` when the budget
  is exhausted (or restarts are disabled) and the engine must stay down.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional


class EngineUnhealthyError(RuntimeError):
    """The engine's worker is dead (or restarting); intake is refused
    until supervision brings it back."""


class HealthState:
    """Thread-safe healthy/unhealthy latch with a transition log."""

    def __init__(self, max_transitions: int = 64):
        self._lock = threading.Lock()
        self._healthy = True
        self._reason = "started"
        self._transitions: collections.deque = collections.deque(
            maxlen=max_transitions)
        self._mark(True, "started")

    def _mark(self, healthy: bool, reason: str) -> None:
        self._transitions.append(
            {"t": time.time(), "healthy": healthy, "reason": reason})

    def set_healthy(self, reason: str) -> None:
        with self._lock:
            if not self._healthy:
                self._mark(True, reason)
            self._healthy, self._reason = True, reason

    def set_unhealthy(self, reason: str) -> None:
        with self._lock:
            if self._healthy:
                self._mark(False, reason)
            self._healthy, self._reason = False, reason

    def healthy(self) -> bool:
        with self._lock:
            return self._healthy

    @property
    def reason(self) -> str:
        with self._lock:
            return self._reason

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "healthy": self._healthy,
                "reason": self._reason,
                "transitions": list(self._transitions),
            }


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Worker restart policy (the process supervisor's semantics, in
    process).

    ``enabled=False`` (or ``max_restarts=0``) means a dead worker stays
    dead: the engine latches unhealthy and refuses intake until closed.
    Backoff doubles per restart *in the window* and is capped; the
    defaults are tuned for an in-process thread (milliseconds), not the
    out-of-process supervisor (seconds).
    """

    enabled: bool = True
    max_restarts: int = 3
    window_s: float = 60.0
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 2.0


class RestartTracker:
    """Sliding-window restart accounting for one supervised worker."""

    def __init__(self, policy: RestartPolicy):
        self.policy = policy
        self._times: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def next_delay(self, now: Optional[float] = None) -> Optional[float]:
        """Backoff seconds before the next permitted restart, or ``None``
        if the budget is exhausted / restarts are disabled.  Calling this
        RECORDS the restart against the window (callers restart iff the
        returned delay is not None)."""
        p = self.policy
        if not p.enabled or p.max_restarts < 1:
            return None
        if now is None:
            now = time.monotonic()
        with self._lock:
            while self._times and now - self._times[0] > p.window_s:
                self._times.popleft()
            if len(self._times) >= p.max_restarts:
                return None
            delay = (min(p.backoff_base_s * (2.0 ** len(self._times)),
                         p.backoff_cap_s)
                     if p.backoff_base_s > 0 else 0.0)
            self._times.append(now)
            return delay

    def restarts_in_window(self, now: Optional[float] = None) -> int:
        if now is None:
            now = time.monotonic()
        with self._lock:
            while self._times and now - self._times[0] > self.policy.window_s:
                self._times.popleft()
            return len(self._times)
