"""Runtime (reference: ``src/repro/runtime``): the continuous-batching
scheduler and server on the contiguous or the paged cache pool,
ladder-speculative decoding, the serving config, the cache-lifecycle
surface, telemetry, and the fault-tolerant ``Trainer``."""

from repro_torch.runtime.cachepool import (
    CacheOps,
    ContiguousCacheOps,
    PageAllocator,
    PagedCachePool,
    PrefixCache,
    token_hash_chain,
)
from repro_torch.runtime.config import SERVE_CACHE_DTYPE, SERVE_STEP_LEVELS, ServingConfig
from repro_torch.runtime.scheduler import ContinuousScheduler, FinishedRequest, Request
from repro_torch.runtime.serve import BatchedServer, ContinuousBatchingServer
from repro_torch.runtime.speculative import (
    SPEC_CACHE_DTYPE,
    SPEC_DRAFT_LEVELS,
    LadderSpeculativeDecoder,
    SpeculativeConfig,
    register_spec_steps,
    vanilla_greedy_reference,
)
from repro_torch.runtime.telemetry import MetricsRegistry, Telemetry, TelemetryConfig
from repro_torch.runtime.train_loop import InjectedFailure, Trainer, TrainerConfig

__all__ = [
    "CacheOps",
    "ContiguousCacheOps",
    "PageAllocator",
    "PagedCachePool",
    "PrefixCache",
    "token_hash_chain",
    "SERVE_CACHE_DTYPE",
    "SERVE_STEP_LEVELS",
    "ServingConfig",
    "ContinuousScheduler",
    "FinishedRequest",
    "Request",
    "BatchedServer",
    "ContinuousBatchingServer",
    "SPEC_CACHE_DTYPE",
    "SPEC_DRAFT_LEVELS",
    "LadderSpeculativeDecoder",
    "SpeculativeConfig",
    "register_spec_steps",
    "vanilla_greedy_reference",
    "MetricsRegistry",
    "Telemetry",
    "TelemetryConfig",
    "InjectedFailure",
    "Trainer",
    "TrainerConfig",
]
