"""The cache-lifecycle surface of the serving engine — contiguous pool.

Reference: ``src/repro/runtime/cachepool.py`` (``ContiguousCacheOps``).
The ``CacheOps`` protocol, its snapshot/restore pair and the paged pool
(``PagedCachePool``, prefix sharing, copy-on-write) wait for ROADMAP.md
queue 1 item 9, where a second implementation needs them.

The port's operations act IN PLACE on the pool's tensors and return the
same tree: ``read`` hands out a view of the slot (admission prefills
straight into it), ``write`` copies rows in, ``reset`` writes the
pristine fill.
"""

from __future__ import annotations

import torch

from repro_torch.models import init_caches, reset_cache_slot, write_cache_slot
from repro_torch.models.config import ModelConfig

__all__ = ["ContiguousCacheOps"]


class ContiguousCacheOps:
    """Every slot owns ``max_len`` rows of the stacked pool for life."""

    kind = "contiguous"

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.dtype = dtype
        self.device = device

    def alloc(self):
        return init_caches(self.cfg, self.n_slots, self.max_len, dtype=self.dtype,
                           device=self.device)

    def write(self, state, single, slot):
        return write_cache_slot(state, single, slot)

    def read(self, state, slot):
        """A VIEW of the slot's rows (leaves ``(n_periods, 1, ...)``)."""
        def view(node):
            if isinstance(node, dict):
                return {k: view(v) for k, v in node.items()}
            return node[:, slot:slot + 1]
        return view(state)

    def reset(self, state, slot):
        return reset_cache_slot(state, self.cfg, slot)
