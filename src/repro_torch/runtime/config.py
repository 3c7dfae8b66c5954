"""The serving configuration surface.

Reference: ``src/repro/runtime/config.py``.  The same ``ServingConfig``
fields, defaults and validation, ``resolved_chunk`` included.  Checks
that need the model (``page_size`` divides every sliding window, prefix
sharing only on all-full-context caches) run where the pool is built
(``runtime/cachepool.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.arbiter import SlotArbiterConfig
from repro_torch.runtime.speculative import SpeculativeConfig
from repro_torch.runtime.telemetry import TelemetryConfig

__all__ = ["ServingConfig", "SERVE_STEP_LEVELS", "SERVE_CACHE_DTYPE"]

#: engine levels the serve steps run at -> model-layer dispatch string
SERVE_STEP_LEVELS = (("q16_16", "fast"), ("f32", "exact"))

#: serving caches are f32 (prefill/decode consistency on the exact rung)
SERVE_CACHE_DTYPE = torch.float32

@dataclasses.dataclass
class ServingConfig:
    """One config for both servers (see the reference for every field).

    ``cache="paged"``: fixed-size pages behind block tables
    (``runtime/cachepool.py``); admission runs chunked prefill in
    ``prefill_chunk``-token segments (default ``page_size``), and
    ``prefix_sharing`` shares full prefix pages (it needs chunk ==
    page_size, so that page contents depend on the token prefix alone).
    ``n_pages`` sizes the full-length page pool (zero page included).
    ``speculative``: a :class:`SpeculativeConfig` enables
    ``Request(speculative=True)``."""

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
    speculative: Optional[SpeculativeConfig] = None
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
            if self.page_size < 1:
                raise ValueError("page_size must be >= 1")
            if self.max_len % self.page_size:
                raise ValueError(
                    f"page_size {self.page_size} must divide max_len {self.max_len}")
        if self.prefill_chunk is not None:
            if self.cache != "paged":
                raise ValueError("prefill_chunk requires cache='paged'")
            if self.prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            if self.max_len % self.prefill_chunk:
                raise ValueError(
                    f"prefill_chunk {self.prefill_chunk} must divide max_len {self.max_len}")
        if self.prefix_sharing:
            if self.cache != "paged":
                raise ValueError("prefix_sharing requires cache='paged'")
            if self.resolved_chunk != self.page_size:
                raise ValueError(
                    "prefix_sharing requires prefill_chunk == page_size: page contents "
                    "must be a deterministic function of the token prefix alone (chunk "
                    "boundaries must land on the page grid regardless of how much "
                    "prefix was matched)")
        if self.n_pages is not None:
            if self.cache != "paged":
                raise ValueError("n_pages requires cache='paged'")
            # one slot's max_len worth of blocks, plus the zero page
            if self.n_pages < self.max_len // self.page_size + 1:
                raise ValueError(
                    f"n_pages {self.n_pages} cannot hold even one slot's "
                    f"{self.max_len // self.page_size} blocks (+1 zero page)")

    @property
    def resolved_chunk(self) -> Optional[int]:
        """The chunked-prefill segment length (None = whole-prompt
        prefill, the contiguous path)."""
        if self.cache != "paged":
            return self.prefill_chunk
        return self.prefill_chunk if self.prefill_chunk is not None else self.page_size
