"""Serving of the port: the batched LM engine, and the persistent ROQ
service (the paper's online stage) with its router, admission control,
health supervision and metrics."""

from repro_torch.serving.admission import (
    AdmissionController,
    CircuitBreakerBoard,
    CircuitOpenError,
    QuotaExceededError,
    ShedError,
    TokenBucket,
)
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.health import (
    EngineUnhealthyError,
    HealthState,
    RestartPolicy,
    RestartTracker,
)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.roq import (
    EngineClosedError,
    InterpolantCache,
    QueueFullError,
    ROQEngine,
    batch_bucket,
    direct_interpolate,
)
from repro_torch.serving.router import BasisRouter

__all__ = [
    "ServeEngine",
    "ROQEngine",
    "BasisRouter",
    "ServingMetrics",
    "InterpolantCache",
    "QueueFullError",
    "EngineClosedError",
    "EngineUnhealthyError",
    "ShedError",
    "QuotaExceededError",
    "CircuitOpenError",
    "AdmissionController",
    "CircuitBreakerBoard",
    "TokenBucket",
    "HealthState",
    "RestartPolicy",
    "RestartTracker",
    "batch_bucket",
    "direct_interpolate",
]
