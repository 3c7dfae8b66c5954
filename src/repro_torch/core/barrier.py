"""Two-phase mode-transition barrier (paper §4.3.1).

Reference: ``src/repro/core/barrier.py``.  Phase 1 waits for the
in-flight device work (``torch.cuda.synchronize`` on the device of the
last dispatched tensor) and reaches cross-process agreement; phase 2
performs the swap.  Agreement is a ``torch.distributed`` barrier when a
process group is initialised with more than one rank, else a no-op.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

__all__ = ["TwoPhaseBarrier", "multihost_sync"]


def multihost_sync(tag: int = 0) -> None:
    """Cross-process agreement point (no-op with one process)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _quiesce(inflight: Any) -> None:
    """Block until the device work that produced ``inflight`` is done."""
    leaves = inflight if isinstance(inflight, (tuple, list)) else (inflight,)
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


@dataclass
class BarrierEvent:
    quiesce_s: float
    swap_s: float
    total_s: float


@dataclass
class TwoPhaseBarrier:
    """quiesce -> agree -> swap, with per-event timing."""

    sync_fn: Callable[[], None] = multihost_sync
    events: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def transition(self, *, inflight: Any, swap_fn: Callable[[], None]) -> BarrierEvent:
        with self._lock:
            t0 = time.perf_counter()
            if inflight is not None:
                _quiesce(inflight)
            self.sync_fn()
            t1 = time.perf_counter()
            swap_fn()
            t2 = time.perf_counter()
            ev = BarrierEvent(quiesce_s=t1 - t0, swap_s=t2 - t1, total_s=t2 - t0)
            self.events.append(ev)
            return ev
