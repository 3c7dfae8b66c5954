"""The serving configuration surface.

Reference: ``src/repro/runtime/config.py``.  The same ``ServingConfig``
fields, defaults and validation; this slice serves the contiguous cache
only, so ``cache="paged"`` (and the page/chunk/prefix knobs that need
it) and ``speculative`` raise ``NotImplementedError`` naming ROADMAP.md
queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.arbiter import SlotArbiterConfig
from repro_torch.runtime.telemetry import TelemetryConfig

__all__ = ["ServingConfig", "SERVE_STEP_LEVELS", "SERVE_CACHE_DTYPE"]

#: engine levels the serve steps run at -> model-layer dispatch string
SERVE_STEP_LEVELS = (("q16_16", "fast"), ("f32", "exact"))

#: serving caches are f32 (prefill/decode consistency on the exact rung)
SERVE_CACHE_DTYPE = torch.float32

_ITEM9 = "ROADMAP.md queue 1 item 9 (paged cache and speculative decoding)"


@dataclasses.dataclass
class ServingConfig:
    """One config for both servers (see the reference for every field)."""

    n_slots: int = 4
    max_len: int = 256
    eos_id: Optional[int] = None
    temperature: float = 0.0          # 0 = greedy
    default_level: Any = "f32"
    seed: int = 0
    health_sync_every: int = 8
    arbiter: SlotArbiterConfig = dataclasses.field(
        default_factory=lambda: SlotArbiterConfig(n_levels=len(SERVE_STEP_LEVELS))
    )
    speculative: Optional[Any] = None
    max_new: int = 32
    cache: str = "contiguous"
    page_size: int = 16
    prefill_chunk: Optional[int] = None
    prefix_sharing: bool = False
    n_pages: Optional[int] = None
    telemetry: TelemetryConfig = dataclasses.field(default_factory=TelemetryConfig)

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.max_len < 2:
            raise ValueError("max_len must be >= 2")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.health_sync_every < 1:
            raise ValueError("health_sync_every must be >= 1")
        if self.cache not in ("contiguous", "paged"):
            raise ValueError(f"cache must be 'contiguous' or 'paged', got {self.cache!r}")
        if self.cache == "paged":
            raise NotImplementedError(f"cache='paged' is not ported yet: {_ITEM9}")
        if self.speculative is not None:
            raise NotImplementedError(f"speculative decoding is not ported yet: {_ITEM9}")
        if self.prefill_chunk is not None or self.prefix_sharing or self.n_pages is not None:
            raise ValueError("prefill_chunk / prefix_sharing / n_pages require cache='paged'")
