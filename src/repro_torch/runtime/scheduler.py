"""Continuous-batching admission/eviction scheduler.

Reference: ``src/repro/runtime/scheduler.py`` (numpy only), kept as a
near-copy so the port never imports the JAX package.

The serving engine keeps a FIXED device batch of ``n_slots`` lanes (the
slot-paged KV/SSM pool is allocated once at server build).  Requests
flow through three states:

    pending (FIFO queue)  --admit-->  active (bound to a slot)
                                      --finish-->  done (slot freed)

``ContinuousScheduler`` is the pure host-side core of that loop: it
owns the queue, the slot table and per-request token bookkeeping, and
decides *which* request occupies *which* slot *when* — but touches no
device state.  The server (:class:`repro_torch.runtime.serve.\
ContinuousBatchingServer`) drives it and performs the corresponding
device work (per-slot prefill scatter, pool decode, cache reset).

Termination of a request is any of: EOS sampled (when ``eos_id`` is
configured), its own ``max_new`` budget exhausted, or the shared
``max_len`` context window reached.  Because budgets are per-request,
short requests free their slots early and the next pending request is
admitted — the continuous-batching win over the static
``BatchedServer``, which decodes every lane until the LONGEST request
in the wave finishes.

Invariants (asserted, and pinned by tests/test_scheduler.py):

* a slot is bound to at most one active request at a time;
* admission is FIFO over submission order;
* every submitted request is eventually finished exactly once;
* a finished request's output = prompt + generated tokens (EOS kept,
  like the static server).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Request", "FinishedRequest", "ContinuousScheduler"]


@dataclasses.dataclass
class Request:
    """One serving request.

    ``level``: ladder level name this request runs at (``None`` =
    server default).  The request's precision may be *escalated* above
    this at runtime by the per-slot arbiter, never demoted below it.

    ``speculative``: serve this request through ladder-speculative
    decoding (draft at a cheap rung, verify at f32 — see
    :mod:`repro_torch.runtime.speculative`).  Output is identical to vanilla
    f32 greedy decode; only throughput changes.  Requires the server to
    be built with a ``speculative`` config.
    """

    rid: int
    prompt: List[int]
    max_new: int = 32
    level: Optional[str] = None
    speculative: bool = False

    def __post_init__(self):
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    tokens: List[int]            # prompt + generated (EOS kept)
    n_generated: int
    reason: str                  # 'eos' | 'max_new' | 'max_len'


@dataclasses.dataclass
class _SlotEntry:
    request: Request
    n_generated: int = 0

    @property
    def pos(self) -> int:
        """Next decode position = tokens written to the cache so far."""
        return len(self.request.prompt) + self.n_generated


class ContinuousScheduler:
    def __init__(self, n_slots: int, max_len: int, eos_id: Optional[int] = None,
                 levels: Optional[Tuple[str, ...]] = None, registry=None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.levels = tuple(levels) if levels is not None else None
        self.pending: Deque[Request] = deque()
        self.slots: List[Optional[_SlotEntry]] = [None] * n_slots
        self.finished: Dict[int, FinishedRequest] = {}
        self._submitted: set = set()
        # queue/admission metrics: on the server's registry when given,
        # a private one otherwise (counting is always on — see
        # repro_torch.runtime.telemetry's overhead contract)
        if registry is None:
            from repro_torch.runtime.telemetry import MetricsRegistry
            registry = MetricsRegistry()
        self._m_queue = registry.gauge(
            "queue_depth", "requests pending admission")
        self._m_blocked = registry.counter(
            "admission_blocked_total",
            "admit() calls that left the head request pending",
            labelnames=("reason",))

    # -- submission ---------------------------------------------------------

    def validate(self, req: Request) -> None:
        """All request validation lives here, BEFORE any queue/slot
        state changes: a request that fails after admit() would leave a
        zombie slot entry behind and corrupt the server for every later
        serve() call."""
        if req.rid in self._submitted:
            raise ValueError(f"duplicate request id {req.rid}")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} >= max_len {self.max_len}"
            )
        if (self.levels is not None and req.level is not None
                and req.level not in self.levels):
            raise ValueError(
                f"request {req.rid}: unknown level {req.level!r}; have {self.levels}"
            )

    def submit(self, req: Request) -> None:
        self.validate(req)
        self._submitted.add(req.rid)
        self.pending.append(req)
        self._m_queue.set(len(self.pending))

    def pop_finished(self, rid: int) -> FinishedRequest:
        """Hand a finished request's result out and RELEASE the rid:
        per-request bookkeeping is dropped (the scheduler outlives its
        requests and must not grow with lifetime traffic), and the rid
        becomes reusable for a future submission."""
        fin = self.finished.pop(rid)
        self._submitted.discard(rid)
        return fin

    # -- state views --------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.pending) or any(e is not None for e in self.slots)

    def active_mask(self) -> np.ndarray:
        return np.array([e is not None for e in self.slots], bool)

    def active_slots(self) -> List[int]:
        return [i for i, e in enumerate(self.slots) if e is not None]

    def request_at(self, slot: int) -> Request:
        e = self.slots[slot]
        assert e is not None, f"slot {slot} is empty"
        return e.request

    # -- admission ----------------------------------------------------------

    def admit(self, can_admit=None, limit=None) -> List[Tuple[int, Request]]:
        """Bind pending requests to free slots, FIFO.  Returns the
        (slot, request) pairs the server must now prefill + scatter.

        ``can_admit(request) -> bool`` is an optional CAPACITY predicate
        (the paged pool's free-page check): admission stops at the FIRST
        rejected request — skipping ahead would break FIFO order, and
        the head request becomes admissible again as running requests
        finish and release their pages.

        ``limit`` caps admissions per call.  A capacity-predicated
        caller MUST admit one request per call (``limit=1``) and
        allocate before calling again: the predicate reads free
        capacity at call time, so approving several requests in one
        batch would check them all against the same un-decremented
        free-page count and over-commit the pool.

        A call that leaves the head request pending records WHY in the
        ``admission_blocked_total{reason=...}`` counter: ``capacity``
        (the predicate rejected it) or ``slots_full`` (no free slot) —
        a ``limit`` cut is not blockage (the caller loops)."""
        out = []
        capacity_blocked = False
        limit_cut = False
        for i in range(self.n_slots):
            if not self.pending:
                break
            if limit is not None and len(out) >= limit:
                limit_cut = True
                break
            if self.slots[i] is None:
                if can_admit is not None and not can_admit(self.pending[0]):
                    capacity_blocked = True
                    break
                req = self.pending.popleft()
                self.slots[i] = _SlotEntry(req)
                out.append((i, req))
        if self.pending and not limit_cut:
            if capacity_blocked:
                self._m_blocked.inc(reason="capacity")
            elif all(e is not None for e in self.slots):
                self._m_blocked.inc(reason="slots_full")
        self._m_queue.set(len(self.pending))
        return out

    # -- per-token bookkeeping ---------------------------------------------
    #
    # Token VALUES live in the server's device ring buffer until a
    # request finishes (keeping the decode loop free of per-step host
    # syncs); the scheduler tracks only counts — plus the EOS flag the
    # server passes in when it runs with per-step EOS checks.

    def n_generated(self, slot: int) -> int:
        e = self.slots[slot]
        assert e is not None, f"slot {slot} is empty"
        return e.n_generated

    def position(self, slot: int) -> int:
        """Next decode position of the slot's request (prompt length +
        generated so far) — the server's speculative-headroom check."""
        e = self.slots[slot]
        assert e is not None, f"slot {slot} is empty"
        return e.pos

    def advance(self, slot: int, eos: bool = False) -> Optional[str]:
        """Count one generated token for the slot's request (the first
        comes from prefill, the rest from pool decode steps).  Returns
        the termination reason if this token finishes the request —
        the caller must then :meth:`finish` the slot with the pulled
        token values and reset its device state before reuse."""
        e = self.slots[slot]
        assert e is not None, f"advance on empty slot {slot}"
        e.n_generated += 1
        if eos and self.eos_id is not None:
            return "eos"
        if e.n_generated >= e.request.max_new:
            return "max_new"
        if e.pos >= self.max_len:
            return "max_len"
        return None

    def finish(self, slot: int, generated: List[int], reason: str) -> FinishedRequest:
        """Materialize the finished request (token values pulled from
        the device by the caller) and free the slot."""
        e = self.slots[slot]
        assert e is not None, f"finish on empty slot {slot}"
        assert len(generated) == e.n_generated, (len(generated), e.n_generated)
        fin = FinishedRequest(
            rid=e.request.rid,
            tokens=list(e.request.prompt) + [int(t) for t in generated],
            n_generated=e.n_generated,
            reason=reason,
        )
        assert fin.rid not in self.finished, f"request {fin.rid} finished twice"
        self.finished[fin.rid] = fin
        self.slots[slot] = None
        return fin
