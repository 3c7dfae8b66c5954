"""Serving runtime (reference: ``src/repro/runtime``): the continuous-
batching scheduler and server on the contiguous cache, the serving
config, the cache-lifecycle surface and telemetry."""

from repro_torch.runtime.config import SERVE_CACHE_DTYPE, SERVE_STEP_LEVELS, ServingConfig
from repro_torch.runtime.scheduler import ContinuousScheduler, FinishedRequest, Request
from repro_torch.runtime.serve import BatchedServer, ContinuousBatchingServer
from repro_torch.runtime.telemetry import MetricsRegistry, Telemetry, TelemetryConfig

__all__ = [
    "SERVE_CACHE_DTYPE",
    "SERVE_STEP_LEVELS",
    "ServingConfig",
    "ContinuousScheduler",
    "FinishedRequest",
    "Request",
    "BatchedServer",
    "ContinuousBatchingServer",
    "MetricsRegistry",
    "Telemetry",
    "TelemetryConfig",
]
