"""Persistent ROQ serving engine: the paper's *online* stage as a service.

Port of :mod:`repro.serving.roq`.  The offline stage builds a reduced
basis once; the whole point is the online stage — many cheap queries
against it.  A request here is a vector ``f`` known only at the basis's
``k`` EIM nodes; the engine answers with
the full N-sample empirical interpolant ``I_k[f] = B @ f[nodes]`` (Alg. 5
of Ref. [6]).  One :class:`ROQEngine` turns that single GEMV into a
persistent batched service:

- ``submit(basis_id, f_nodes, client_id=...)`` runs the admission
  pipeline — engine health, the basis's circuit breaker, the client's
  token-bucket quota, deadline-aware shedding — then puts the request on
  a BOUNDED queue and returns a ``concurrent.futures.Future``.  Every
  rejection is an explicit, distinct error (:class:`EngineClosedError` /
  :class:`~repro_torch.serving.health.EngineUnhealthyError` /
  :class:`~repro_torch.serving.admission.CircuitOpenError` /
  :class:`~repro_torch.serving.admission.QuotaExceededError` /
  :class:`~repro_torch.serving.admission.ShedError` / :class:`QueueFullError`),
  never silent latency.
- A worker thread forms dynamic per-basis batches under the latency /
  throughput dial: flush at ``max_batch`` requests OR ``max_wait_ms``
  after the oldest pending one, whichever first.  Deadlines are enforced
  while requests WAIT, not only at flush: the poll wakes for the earliest
  pending deadline, so ``timeout_s << max_wait_ms`` still times out
  promptly.
- Batches evaluate through a warm :class:`InterpolantCache` keyed by
  ``(basis_id, generation, batch_bucket, dtype)``: batch widths round up
  to power-of-two buckets, so a basis sees O(log2(max_batch)) distinct
  shapes; the generation comes from the router and
  lets :meth:`refresh` hot-swap a rebuilt artifact without poisoning
  warm entries (old-generation batches in flight finish correctly, then
  their entries are retired).
- ``basis_id`` routes through a
  :class:`~repro_torch.serving.router.BasisRouter`
  (multi-artifact working set, LRU under a device-memory budget); router
  evictions drop the matching warm cache entries.
- Per-request timeout and error isolation: a malformed request (wrong
  length, uncastable dtype, unknown basis) fails ALONE via its future;
  its batchmates still serve.  Batch-level failures (injected via
  ``REPRO_FAULT_SERVE_RAISE_AT_BATCH``, the checkpoint fault conventions)
  fail one batch, never the engine — and feed the per-basis circuit
  breaker, so a basis failing ``breaker_threshold`` consecutive batches
  stops burning batch slots until a cooldown probe succeeds.
- The worker runs SUPERVISED: an exception escaping the batching/poll
  logic (simulate with ``REPRO_FAULT_SERVE_KILL_WORKER``) fails every
  pending and queued future with ``EngineUnhealthyError`` — nothing ever
  hangs — flips :meth:`healthy` false, and (per the
  :class:`~repro_torch.serving.health.RestartPolicy`) restarts the worker
  under a sliding restart window with exponential backoff.
- ``close()`` drains: intake stops, everything already accepted is
  served, then the worker exits.  A ``submit`` racing ``close`` can
  never strand its future: both sides re-drain the queue after the
  worker is gone.

Bitwise contract (load-bearing for the tests and the multi-basis
service): padded-bucket evaluation is bit-identical to the unpadded direct
evaluation of the same requests.  Every apply ``B @ F`` goes through
:func:`repro_torch.kernels.roq_apply.ops.roq_apply`: on the card a
hand-written kernel (two routes of the same bits) that sums each output
element over k in one fixed order, so a column's bits never depend on the
batch width (cuBLAS
makes no such promise, and at complex128 breaks it); on the CPU
``torch.matmul``, whose columns keep their bits across widths with the
BLAS PyTorch ships.  Complex stays native (interleaved), not plane-split.
A lone column is padded to width 2, as the reference pads it.  Futures
and :func:`direct_interpolate` return HOST tensors: the answer leaves the
card, as the reference's leaves XLA as numpy.  Asserted across dtypes in
``tests/test_torch_serving.py`` and, on the card, in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Optional

import torch

from repro_torch.kernels.roq_apply.ops import roq_apply
from repro_torch.serving.admission import (
    AdmissionController,
    CircuitBreakerBoard,
)
from repro_torch.serving.health import (
    EngineUnhealthyError,
    HealthState,
    RestartPolicy,
    RestartTracker,
)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.router import BasisRouter

logger = logging.getLogger("repro_torch.serving")


class QueueFullError(RuntimeError):
    """Backpressure: the engine's bounded queue is full; retry or shed."""


class EngineClosedError(RuntimeError):
    """The engine is closed (or closing) and takes no new requests."""


def batch_bucket(n: int) -> int:
    """Padded batch width for a batch of ``n`` requests: the smallest
    power of two >= max(n, 2) (the reference's floor of 2 is kept)."""
    if n < 1:
        raise ValueError(f"batch of {n} requests")
    return 1 << (max(n, 2) - 1).bit_length()


def _as_batch(F, B: torch.Tensor) -> torch.Tensor:
    """A (k, b) or (k,) request batch as a tensor of B's dtype on B's
    device (numpy or tensors from any device)."""
    F = torch.as_tensor(F)
    return F.to(device=B.device, dtype=B.dtype)


def _eval_padded(B: torch.Tensor, F: torch.Tensor, width: int
                 ) -> torch.Tensor:
    """``(B @ Fp)[:, :b]`` with F (k, b) zero-padded to ``width`` columns;
    the result is copied to the host."""
    b = F.shape[1]
    Fp = torch.zeros((F.shape[0], width), dtype=B.dtype, device=B.device)
    Fp[:, :b] = F
    return roq_apply(B, Fp)[:, :b].cpu()


def direct_interpolate(eim, F) -> torch.Tensor:
    """Reference evaluation: unpadded, unbatched-policy-free ``B @ F``.

    ``F`` is (k,) or (k, b) at the EIM nodes (numpy or a tensor); returns a
    host tensor (N,) or (N, b).  This is "direct per-basis evaluation" in
    the acceptance sense — the engine's padded-bucket path must match it
    bit for bit.  A single column is padded to width 2, as in the
    reference.
    """
    B = eim.B.contiguous()
    F = _as_batch(F, B)
    squeeze = F.dim() == 1
    if squeeze:
        F = F[:, None]
    out = _eval_padded(B, F, max(F.shape[1], 2))
    return out[:, 0] if squeeze else out


class InterpolantCache:
    """Warm interpolants keyed ``(basis_id, generation, bucket, dtype)``.

    Holds the contiguous interpolant on the device per (basis, generation)
    plus the set of (bucket, dtype) combinations already served for it; a
    miss pays the first batch of that shape, every later batch in the same
    bucket is warm.  ``evict(basis_id)`` drops every generation (wired to
    router LRU evictions); ``retire(basis_id, below_gen)`` drops only
    generations below a hot-reload floor — an in-flight old-generation
    batch still evaluates correctly, it just no longer repopulates the
    cache.
    """

    def __init__(self):
        self._interp: dict[tuple, torch.Tensor] = {}  # (basis_id, gen) -> B
        self._warm: set[tuple] = set()          # (basis_id, gen, bucket, dt)
        self._floor: dict[str, int] = {}        # basis_id -> min live gen
        self._lock = threading.Lock()

    def evaluate(self, basis_id: str, eim, F: torch.Tensor,
                 generation: int = 0):
        """(out, bucket, was_warm) for a (k, b) request batch ``F`` of the
        interpolant's dtype; ``out`` is the (N, b) host tensor."""
        b = F.shape[1]
        bucket = batch_bucket(b)
        key = (basis_id, generation, bucket, str(F.dtype))
        with self._lock:
            retired = generation < self._floor.get(basis_id, 0)
            warm = key in self._warm
            B = self._interp.get((basis_id, generation))
            if B is None:
                B = eim.B.contiguous()
                if not retired:
                    self._interp[(basis_id, generation)] = B
        out = _eval_padded(B, _as_batch(F, B), bucket)
        with self._lock:
            if not retired:
                self._warm.add(key)
        return out, bucket, warm

    def warm_keys(self, basis_id: str) -> list[tuple]:
        with self._lock:
            return sorted(k for k in self._warm if k[0] == basis_id)

    def evict(self, basis_id: str) -> None:
        with self._lock:
            self._interp = {k: v for k, v in self._interp.items()
                            if k[0] != basis_id}
            self._warm = {k for k in self._warm if k[0] != basis_id}

    def retire(self, basis_id: str, below_gen: int) -> None:
        """Hot-reload floor: drop entries with generation < ``below_gen``
        and refuse to re-admit them (in-flight old-generation batches
        finish, their results stay bitwise-correct, nothing is cached)."""
        with self._lock:
            self._floor[basis_id] = max(
                self._floor.get(basis_id, 0), int(below_gen))
            self._interp = {k: v for k, v in self._interp.items()
                            if k[0] != basis_id or k[1] >= below_gen}
            self._warm = {k for k in self._warm
                          if k[0] != basis_id or k[1] >= below_gen}

    def stats(self) -> dict:
        with self._lock:
            return {"committed_bases": len(self._interp),
                    "warm_entries": len(self._warm)}


@dataclasses.dataclass
class _Request:
    basis_id: str
    f: torch.Tensor
    future: concurrent.futures.Future
    t_submit: float
    deadline: Optional[float]


def _resolve(fut: concurrent.futures.Future, *, result=None,
             error: Optional[BaseException] = None) -> bool:
    """Resolve a future, tolerating caller-side cancellation."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
        return True
    except concurrent.futures.InvalidStateError:
        return False


class ROQEngine:
    """Persistent batched ROQ interpolation service (see module docstring).

    Args:
      router: a :class:`BasisRouter`, or a ``{basis_id: directory |
        ReducedBasis}`` mapping to build one from (budgeted by
        ``REPRO_DEVICE_MEM_BUDGET`` conventions, loading onto ``device``).
      max_batch: flush a basis's pending batch at this many requests.
      max_wait_ms: ... or this long after its oldest pending request —
        the latency/throughput dial (small = low latency, large = big
        batches).
      queue_depth: bounded intake; a full queue rejects with
        :class:`QueueFullError` (explicit backpressure).
      timeout_s: default per-request deadline (None = no deadline),
        overridable per ``submit``.
      client_rate / client_burst: per-client token-bucket quota (req/s
        steady rate + burst capacity) keyed by ``submit``'s
        ``client_id`` (anonymous requests share one bucket); ``None``
        disables quotas.
      degrade_queue_frac: queue-depth watermark (fraction of
        ``queue_depth``) past which admission enters degraded mode and
        quota refill is multiplied by ``degraded_factor`` (cleared with
        hysteresis at half the watermark).
      degrade_p95_ms: optional p95-latency watermark (over the metrics
        window) with the same effect.
      breaker_threshold / breaker_cooldown_s: per-basis circuit breaker —
        this many CONSECUTIVE batch failures open it (requests fast-fail
        with ``CircuitOpenError``); after the cooldown one probe batch is
        admitted half-open.
      restart: a :class:`~repro_torch.serving.health.RestartPolicy` for the
        supervised worker (default: restart up to 3 times per 60 s
        window with exponential backoff).  ``RestartPolicy(enabled=
        False)`` latches the engine unhealthy on worker death instead.
      start: spin up the worker immediately (tests pass False to poke
        the queue unserviced).
      device: where a router built from a mapping loads its artifacts
        (``cuda`` unless ``device="cpu"``).
    """

    def __init__(self, router, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, queue_depth: int = 1024,
                 timeout_s: Optional[float] = None,
                 metrics: Optional[ServingMetrics] = None,
                 client_rate: Optional[float] = None,
                 client_burst: Optional[float] = None,
                 degraded_factor: float = 0.5,
                 degrade_queue_frac: float = 0.75,
                 degrade_p95_ms: Optional[float] = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 5.0,
                 restart: Optional[RestartPolicy] = None,
                 start: bool = True, device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.metrics = metrics if metrics is not None else ServingMetrics()
        if isinstance(router, dict):
            mapping, router = router, BasisRouter(metrics=self.metrics,
                                                  device=device)
            for bid, src in mapping.items():
                router.register(bid, src)
        if router._metrics is None:
            router._metrics = self.metrics
        self.router = router
        self.cache = InterpolantCache()
        prev_evict = router._on_evict
        def _on_evict(bid, _prev=prev_evict):
            self.cache.evict(bid)
            if _prev is not None:
                _prev(bid)
        router._on_evict = _on_evict
        prev_refresh = router._on_refresh
        def _on_refresh(bid, old_gen, new_gen, _prev=prev_refresh):
            self.cache.retire(bid, below_gen=new_gen)
            if _prev is not None:
                _prev(bid, old_gen, new_gen)
        router._on_refresh = _on_refresh
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.timeout_s = timeout_s
        self.degrade_queue_frac = float(degrade_queue_frac)
        self.degrade_p95_ms = degrade_p95_ms
        self.admission = AdmissionController(
            client_rate=client_rate, client_burst=client_burst,
            degraded_factor=degraded_factor,
            delay_estimator=self.estimated_delay_s, metrics=self.metrics)
        self.breakers = CircuitBreakerBoard(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s,
            probe_budget=self.max_batch, metrics=self.metrics)
        self.restart_policy = restart if restart is not None \
            else RestartPolicy()
        self._restarts = RestartTracker(self.restart_policy)
        self._health = HealthState()
        self._queue: queue.Queue = queue.Queue(maxsize=int(queue_depth))
        self._pending: dict[str, list[_Request]] = {}
        self._closed = False
        self._abort = False
        self._wake = threading.Event()
        self._stop_backoff = threading.Event()
        self._batch_ordinal = 0
        self._batch_ewma_s = 0.0
        self._last_pressure_check = 0.0
        self._worker: Optional[threading.Thread] = None
        if start:
            self.start()

    # ----------------------------------------------------------- intake ----
    def submit(self, basis_id: str, f_nodes,
               timeout_s: Optional[float] = None, *,
               client_id=None) -> concurrent.futures.Future:
        """Run the admission pipeline and enqueue one interpolation
        request; returns its future.

        ``f_nodes`` is a numpy array or a tensor on any device.  The future
        resolves to the (N,) interpolant as a host tensor, or raises the
        request's own failure (bad shape/dtype, unknown basis, timeout,
        batch evaluation error, worker death).  Raises synchronously for
        engine- and admission-level conditions, each with its own type:
        closed intake (:class:`EngineClosedError`), dead worker
        (``EngineUnhealthyError``), open circuit for this basis
        (``CircuitOpenError``), client over quota
        (``QuotaExceededError``), hopeless deadline (``ShedError``), and
        a full queue (:class:`QueueFullError`).
        """
        if self._closed:
            raise EngineClosedError("engine is closed to new requests")
        if not self._health.healthy():
            raise EngineUnhealthyError(
                f"engine unhealthy: {self._health.reason}")
        f = torch.as_tensor(f_nodes)
        if f.dim() != 1:
            self.metrics.count("errors")
            raise ValueError(
                f"a request is ONE vector at the EIM nodes; got shape "
                f"{tuple(f.shape)} (batching is the engine's job)")
        now = time.perf_counter()
        if timeout_s is None:
            timeout_s = self.timeout_s
        deadline = None if timeout_s is None else now + float(timeout_s)
        basis_id = str(basis_id)
        self.breakers.allow(basis_id, now)        # CircuitOpenError
        self.admission.admit(client_id, deadline, now)  # Quota / Shed
        req = _Request(basis_id=basis_id, f=f,
                       future=concurrent.futures.Future(), t_submit=now,
                       deadline=deadline)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.count("rejected")
            raise QueueFullError(
                f"serving queue full ({self._queue.maxsize} deep); "
                f"backpressure — retry or shed load") from None
        self.metrics.count("submitted")
        self._wake.set()
        # close()/worker-death race: the intake checks above can pass just
        # before the engine stops serving, landing this request on a queue
        # nothing will ever drain.  Re-check AFTER the enqueue and, unless
        # a live healthy worker is still draining, fail everything queued —
        # a future must resolve exactly one way, never hang.
        if self._closed or not self._health.healthy():
            w = self._worker
            serving = (not self._abort and self._health.healthy()
                       and w is not None and w.is_alive())
            if not serving:
                err = (EngineClosedError("engine closed during submit")
                       if self._closed else EngineUnhealthyError(
                           f"engine unhealthy: {self._health.reason}"))
                self._fail_all_pending(err)
        return req.future

    def warm(self, basis_id: str, buckets=None) -> None:
        """Pre-compile interpolant entries for ``basis_id`` off the
        request path (all power-of-two buckets up to ``max_batch`` by
        default) and fault in the routed basis."""
        entry = self.router.get_entry(basis_id)
        dtype = entry.basis.Q.dtype
        if buckets is None:
            buckets, b = [], 2
            while b < batch_bucket(self.max_batch):
                buckets.append(b)
                b *= 2
            buckets.append(batch_bucket(self.max_batch))
        for b in buckets:
            zeros = torch.zeros((entry.basis.k, int(b)), dtype=dtype,
                                device=entry.basis.Q.device)
            self.cache.evaluate(basis_id, entry.eim, zeros,
                                generation=entry.generation)

    # ------------------------------------------------------- hot reload ----
    def refresh(self, basis_id: str, source=None) -> int:
        """Hot-swap ``basis_id`` to the artifact now on disk (see
        :meth:`BasisRouter.refresh`): CRC-verified candidate, atomic
        generation-counted swap, old-generation warm entries retired,
        in-flight batches unaffected.  Returns the new generation."""
        return self.router.refresh(basis_id, source)

    # ----------------------------------------------------------- worker ----
    def start(self) -> None:
        if self._worker is not None:
            return
        self._worker = threading.Thread(
            target=self._worker_main, name="roq-engine", daemon=True)
        self._worker.start()

    def healthy(self) -> bool:
        """Readiness: True while the (supervised) worker is serving."""
        return self._health.healthy() and not self._closed

    def close(self, drain: bool = True) -> None:
        """Stop intake; serve everything already accepted (``drain=True``)
        or fail it with :class:`EngineClosedError` (``drain=False``);
        join the worker.  Anything still queued after the worker is gone
        — abort leftovers, a racing ``submit``, or a backlog stranded by
        a dead worker — is failed, never left hanging."""
        self._closed = True
        if not drain:
            self._abort = True
        self._wake.set()
        self._stop_backoff.set()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        self._fail_all_pending(EngineClosedError(
            "engine aborted" if self._abort
            else "engine closed during submit"))

    def __enter__(self) -> "ROQEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    def _worker_main(self) -> None:
        """Supervision guard around the batching loop.

        Without it, any exception escaping :meth:`_run` outside the
        per-batch ``try`` would kill the worker with every submitted future
        stranded forever.  A dying loop (a)
        fails every pending AND queued future with
        ``EngineUnhealthyError``, (b) flips the health latch (readiness
        false, ``submit`` refuses), and (c) restarts under the sliding
        restart window + exponential backoff of :attr:`restart_policy`,
        or stays down once the budget is exhausted/disabled.
        """
        while True:
            try:
                self._run()
                return    # clean exit: closed and drained/aborted
            except BaseException as e:  # supervision guard — never hang
                self.metrics.count("worker_deaths")
                logger.exception(
                    "serving worker died in the batching loop: %r", e)
                self._health.set_unhealthy(f"worker died: {e!r}")
                self._fail_inflight(EngineUnhealthyError(
                    f"serving worker died: {e!r}"))
                if self._closed:
                    return
                delay = self._restarts.next_delay()
                if delay is None:
                    p = self.restart_policy
                    self._health.set_unhealthy(
                        f"worker died: {e!r}; restart budget exhausted "
                        f"({p.max_restarts} per {p.window_s:.0f}s) or "
                        f"restarts disabled")
                    return
                if delay > 0:
                    self._stop_backoff.wait(delay)
                if self._closed:
                    return
                self.metrics.count("worker_restarts")
                self._health.set_healthy("worker restarted after death")

    def _run(self) -> None:
        pending = self._pending
        while True:
            if self._abort:
                break
            self._wake.wait(timeout=self._poll_s(pending))
            self._wake.clear()
            if self._abort:
                break
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                pending.setdefault(req.basis_id, []).append(req)
            n_pending = sum(len(v) for v in pending.values())
            self.metrics.set_queue_depth(self._queue.qsize() + n_pending)
            now = time.perf_counter()
            self._update_pressure(now, n_pending)
            self._expire_deadlines(pending, now)
            draining = self._closed and self._queue.empty()
            for bid in list(pending):
                lst = pending[bid]
                while len(lst) >= self.max_batch:
                    self._flush(bid, lst[:self.max_batch])
                    del lst[:self.max_batch]
                if lst and (draining
                            or now - lst[0].t_submit >= self.max_wait_s):
                    self._flush(bid, lst)
                    lst.clear()
                if not lst:
                    del pending[bid]
            if self._closed and self._queue.empty() and not pending:
                break
        if self._abort:
            for lst in pending.values():
                for r in lst:
                    if _resolve(r.future,
                                error=EngineClosedError("engine aborted")):
                        self.metrics.count("errors")
            pending.clear()

    def _poll_s(self, pending) -> float:
        """Sleep until the next max_wait flush OR the earliest pending
        deadline is due (capped so close() and fresh submissions stay
        responsive) — a request with ``timeout_s`` far below
        ``max_wait_ms`` gets its TimeoutError promptly, not at flush."""
        cap = 0.05
        if self._closed:
            return 1e-3
        now = time.perf_counter()
        due = None
        for lst in pending.values():
            if not lst:
                continue
            t = lst[0].t_submit + self.max_wait_s
            due = t if due is None else min(due, t)
            for r in lst:
                if r.deadline is not None and r.deadline < due:
                    due = r.deadline
        if due is None:
            return cap
        return max(1e-4, min(cap, due - now))

    def _expire_deadlines(self, pending, now: float) -> None:
        """Fail requests whose deadline passed while they WAITED — they
        never reach a batch slot, and their TimeoutError is prompt."""
        for bid in list(pending):
            lst = pending[bid]
            if not any(r.deadline is not None and now > r.deadline
                       for r in lst):
                continue
            live = []
            for r in lst:
                if r.deadline is not None and now > r.deadline:
                    if _resolve(r.future, error=TimeoutError(
                            f"request waited past its "
                            f"{r.deadline - r.t_submit:.3f}s deadline")):
                        self.metrics.count("timeouts")
                else:
                    live.append(r)
            lst[:] = live
            if not lst:
                del pending[bid]

    def _update_pressure(self, now: float, n_pending: int = 0) -> None:
        """Degraded-mode watermark check, throttled to ~20 Hz.

        The backlog is queued PLUS pending requests — the worker drains
        the queue into its pending dict before checking, so ``qsize()``
        alone reads ~0 at exactly the wrong moment."""
        if now - self._last_pressure_check < 0.05:
            return
        self._last_pressure_check = now
        frac = ((self._queue.qsize() + n_pending)
                / max(self._queue.maxsize, 1))
        p95 = (self.metrics.recent_p95_ms()
               if self.degrade_p95_ms is not None else None)
        if frac >= self.degrade_queue_frac or (
                p95 is not None and p95 >= self.degrade_p95_ms):
            if self.admission.set_degraded(True):
                logger.warning(
                    "admission degraded: queue %.0f%% of depth, p95=%s ms",
                    frac * 100, f"{p95:.1f}" if p95 is not None else "n/a")
        elif self.admission.degraded and frac <= 0.5 * self.degrade_queue_frac \
                and (p95 is None or p95 < self.degrade_p95_ms):
            if self.admission.set_degraded(False):
                logger.info("admission back to normal (pressure cleared)")

    def estimated_delay_s(self) -> float:
        """Estimated queueing delay for a request admitted NOW: backlog
        batches x the EWMA batch service time.  0.0 with no backlog or
        before the first served batch — shedding only ever fires on
        measured congestion, never cold."""
        ewma = self._batch_ewma_s
        if ewma <= 0.0:
            return 0.0
        # best-effort backlog: queued + whatever the worker already drained
        # into its pending dict (len() reads race benignly under the GIL)
        backlog = self._queue.qsize() + sum(
            len(v) for v in list(self._pending.values()))
        return (backlog / max(self.max_batch, 1)) * ewma

    def _fail_inflight(self, err: BaseException) -> None:
        """Fail everything the worker owned (pending batches) plus the
        whole queue — the worker-death path; nothing may hang."""
        pending, self._pending = self._pending, {}
        for lst in pending.values():
            for r in lst:
                if _resolve(r.future, error=err):
                    self.metrics.count("errors")
        self._fail_all_pending(err)

    def _fail_all_pending(self, err: BaseException) -> None:
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                return
            if _resolve(r.future, error=err):
                self.metrics.count("errors")

    # ------------------------------------------------------------ flush ----
    def _flush(self, basis_id: str, reqs: list) -> None:
        now = time.perf_counter()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                if _resolve(r.future, error=TimeoutError(
                        f"request waited past its "
                        f"{r.deadline - r.t_submit:.3f}s deadline")):
                    self.metrics.count("timeouts")
            else:
                live.append(r)
        if not live:
            return
        try:
            entry = self.router.get_entry(basis_id)
        except Exception as e:  # unknown id, unreadable artifact, ...
            self.breakers.record_failure(basis_id)
            for r in live:
                if _resolve(r.future, error=e):
                    self.metrics.count("errors")
            return
        basis, eim = entry.basis, entry.eim
        dtype = basis.Q.dtype
        good = []
        for r in live:
            if tuple(r.f.shape) != (basis.k,):
                err = ValueError(
                    f"request for {basis_id!r} has shape "
                    f"{tuple(r.f.shape)}, expected ({basis.k},) — one "
                    f"value per EIM node")
            elif not torch.can_cast(r.f.dtype, dtype):
                err = ValueError(
                    f"request dtype {r.f.dtype} does not cast to basis "
                    f"dtype {dtype}")
            else:
                good.append(r)
                continue
            if _resolve(r.future, error=err):
                self.metrics.count("errors")
        if not good:
            return
        # one host-to-device copy for a batch of host requests
        host = all(r.f.device.type == "cpu" for r in good)
        F = torch.stack([r.f if host else r.f.to(basis.Q.device)
                         for r in good], dim=1).to(dtype)
        self._batch_ordinal += 1
        # OUTSIDE the per-batch try: an injected death here escapes the
        # batching logic entirely and must be caught by the supervision
        # guard, not batch error isolation.
        self._maybe_kill_worker(self._batch_ordinal)
        self.breakers.on_batch_start(basis_id)
        t_eval0 = time.perf_counter()
        try:
            self._maybe_inject_batch_fault(self._batch_ordinal)
            self._maybe_slow_batch()
            out, bucket, warm = self.cache.evaluate(
                basis_id, eim, F, generation=entry.generation)
        except Exception as e:
            # batch-level failure: isolated to THIS batch's requests;
            # the engine keeps serving subsequent batches.  Consecutive
            # failures feed the basis's circuit breaker.
            logger.warning("batch %d for %r failed: %s",
                           self._batch_ordinal, basis_id, e)
            self.breakers.record_failure(basis_id)
            for r in good:
                if _resolve(r.future, error=e):
                    self.metrics.count("errors")
            return
        self.breakers.record_success(basis_id)
        t_done = time.perf_counter()
        dt = t_done - t_eval0
        self._batch_ewma_s = dt if self._batch_ewma_s == 0.0 \
            else 0.2 * dt + 0.8 * self._batch_ewma_s
        self.metrics.count("cache_hits" if warm else "cache_misses")
        self.metrics.observe_batch(len(good), bucket)
        for i, r in enumerate(good):
            if _resolve(r.future, result=out[:, i]):
                self.metrics.count("completed")
                self.metrics.observe_latency(t_done - r.t_submit)

    # ------------------------------------------------------ chaos hooks ----
    @staticmethod
    def _maybe_inject_batch_fault(ordinal: int) -> None:
        """Fault hook: ``REPRO_FAULT_SERVE_RAISE_AT_BATCH=n``
        raises a transient error evaluating the n-th batch (at most once
        under ``REPRO_FAULT_ONCE``), exercising batch error isolation."""
        at = os.environ.get("REPRO_FAULT_SERVE_RAISE_AT_BATCH")
        if not at or ordinal != int(at):
            return
        from repro_torch.checkpoint.io import _fault_once

        if _fault_once("serve_raise_at_batch"):
            raise RuntimeError(
                f"injected serving fault at batch {ordinal} "
                f"(REPRO_FAULT_SERVE_RAISE_AT_BATCH)")

    @staticmethod
    def _maybe_kill_worker(ordinal: int) -> None:
        """``REPRO_FAULT_SERVE_KILL_WORKER=n`` raises in the BATCHING
        logic (outside the per-batch try) at the n-th batch — the silent
        worker-death scenario the supervision guard exists for.  At most
        once under ``REPRO_FAULT_ONCE``."""
        at = os.environ.get("REPRO_FAULT_SERVE_KILL_WORKER")
        if not at or ordinal != int(at):
            return
        from repro_torch.checkpoint.io import _fault_once

        if _fault_once("serve_kill_worker"):
            raise RuntimeError(
                f"injected worker death at batch {ordinal} "
                f"(REPRO_FAULT_SERVE_KILL_WORKER)")

    @staticmethod
    def _maybe_slow_batch() -> None:
        """``REPRO_FAULT_SERVE_SLOW_BATCH=<ms>`` stalls every batch
        evaluation — the straggler/overload injection behind the
        degraded-mode and shedding chaos scenarios."""
        ms = os.environ.get("REPRO_FAULT_SERVE_SLOW_BATCH")
        if ms:
            time.sleep(float(ms) / 1e3)

    # ------------------------------------------------------------ status ----
    def stats(self) -> dict:
        """One observability rollup: metrics snapshot + router + cache +
        health/admission/breaker state."""
        snap = self.metrics.snapshot()
        snap["router"] = self.router.stats()
        snap["interpolant_cache"] = self.cache.stats()
        snap["healthy"] = self.healthy()
        snap["health"] = self._health.snapshot()
        snap["admission"] = self.admission.stats()
        snap["breakers"] = self.breakers.stats()
        snap["estimated_delay_ms"] = self.estimated_delay_s() * 1e3
        return snap
