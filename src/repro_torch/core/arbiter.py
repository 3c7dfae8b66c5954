"""Dynamic precision arbiters: the engine's ``PrecisionArbiter`` and the
serving engine's per-slot ``SlotArbiter``.

Reference: ``src/repro/core/arbiter.py`` (``ArbiterConfig``,
``PrecisionArbiter``, ``SlotArbiterConfig`` and ``SlotArbiter``, host
Python and numpy only; copied so the port never imports the JAX
package).

``PrecisionArbiter`` watches loss and gradient-norm telemetry and
recommends transitions along a ladder (cheapest -> most precise), which
the engine executes through its two-phase barrier (hysteresis stepping):
  step UP one rung on a grad-norm spike (> ``spike_factor`` x running
      median) or a loss regression (> ``regress_tol`` over the window);
  jump to the TOP rung on non-finite loss/grad, bypassing the cooldown;
  step DOWN one rung after ``stable_steps`` consecutive healthy steps,
      with a cooldown between switches against flapping.
Spike/regression escalations and all demotions honour the cooldown, and
any unhealthy step resets the ``stable_steps`` demotion counter.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Optional, Tuple

import numpy as np

from repro_torch.core.precision import Mode

__all__ = ["ArbiterConfig", "PrecisionArbiter", "SlotArbiterConfig", "SlotArbiter"]


@dataclass(frozen=True)
class ArbiterConfig:
    spike_factor: float = 8.0        # grad-norm spike threshold vs running median
    regress_tol: float = 0.25        # fractional loss regression that trips escalation
    window: int = 32                 # telemetry window
    stable_steps: int = 64           # healthy steps before stepping back down
    cooldown_steps: int = 16         # minimum steps between switches
    #: ordered cheapest -> most precise; entries are whatever the engine
    #: accepts (Mode compat aliases or ladder level names).
    ladder: Tuple[Any, ...] = (Mode.FAST, Mode.PRECISE)
    start_mode: Any = Mode.FAST      # must be a ladder entry


@dataclass
class PrecisionArbiter:
    config: ArbiterConfig = field(default_factory=ArbiterConfig)

    def __post_init__(self):
        cfg = self.config
        if not cfg.ladder:
            raise ValueError("arbiter ladder must have at least one entry")
        self._ladder = tuple(cfg.ladder)
        try:
            self._idx = self._ladder.index(cfg.start_mode)
        except ValueError:
            raise ValueError(
                f"start_mode {cfg.start_mode!r} is not in the ladder {self._ladder!r}"
            ) from None
        self._losses: Deque[float] = deque(maxlen=cfg.window)
        self._gnorms: Deque[float] = deque(maxlen=cfg.window)
        self._stable = 0
        self._last_switch_step = -(10**9)
        self.decisions: list = []

    @property
    def mode(self) -> Any:
        """The current ladder entry (a Mode for the default ladder)."""
        return self._ladder[self._idx]

    @property
    def ladder(self) -> Tuple[Any, ...]:
        return self._ladder

    @property
    def rung(self) -> int:
        """Index of the current entry (0 = cheapest)."""
        return self._idx

    @staticmethod
    def _median(values) -> float:
        s = sorted(values)
        n = len(s)
        if n == 0:
            return 0.0
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def _unhealthy(self, loss: float, grad_norm: float) -> Optional[str]:
        if not math.isfinite(loss) or not math.isfinite(grad_norm):
            return "non-finite"
        if len(self._gnorms) >= 8:
            med = self._median(self._gnorms)
            if med > 0 and grad_norm > self.config.spike_factor * med:
                return f"grad-spike {grad_norm:.3g} > {self.config.spike_factor}x med {med:.3g}"
        if len(self._losses) >= 8:
            recent = self._median(list(self._losses)[-4:])
            past = self._median(list(self._losses)[:4])
            if past > 0 and recent > past * (1.0 + self.config.regress_tol):
                return f"loss-regression {past:.4g} -> {recent:.4g}"
        return None

    def _switch(self, step: int, idx: int, reason: str):
        self._idx = idx
        self._last_switch_step = step
        self._stable = 0
        entry = self._ladder[idx]
        self.decisions.append((step, entry, reason))
        return entry

    def observe(self, step: int, loss: float, grad_norm: float) -> Optional[Any]:
        """Feed one step's telemetry; returns a ladder entry if a switch
        is recommended, else None.  Non-finite steps are NOT added to the
        telemetry window (they would poison the medians)."""
        reason = self._unhealthy(loss, grad_norm)
        cooled = step - self._last_switch_step >= self.config.cooldown_steps
        forced = reason == "non-finite"

        if reason is None:
            self._losses.append(loss)
            self._gnorms.append(grad_norm)
            self._stable += 1
        else:
            self._stable = 0

        top = len(self._ladder) - 1
        if reason is not None and self._idx < top and (cooled or forced):
            # non-finite jumps straight to the most precise rung; spikes
            # and regressions escalate one rung at a time
            return self._switch(step, top if forced else self._idx + 1, reason)

        if (self._idx > 0 and reason is None and self._stable >= self.config.stable_steps
                and cooled):
            return self._switch(step, self._idx - 1, "stable")

        return None


@dataclass(frozen=True)
class SlotArbiterConfig:
    """Hysteresis policy for PER-REQUEST precision in the continuous-
    batching server (one ladder position per device slot).

    The training arbiter watches loss/grad-norm; a serving request has
    neither, so the per-slot signals are the request's own numerics
    health, pulled with the same (B,)-sized host sync as the EOS check:

    * ``nonfinite`` — any non-finite logit this step (hard failure:
      jump the slot to the TOP rung, bypassing the cooldown);
    * ``amplitude`` — max |logit|; above ``amp_threshold`` the fixed-
      point headroom is at risk (Q16.16 saturates at 2^15), so the slot
      steps UP one rung.

    ``stable_steps`` consecutive healthy steps step a slot back DOWN
    one rung — but never below the slot's *floor* (the rung the request
    asked for at admission): escalations are recoverable, the client's
    requested precision is a contract.  ``cooldown_steps`` separates
    consecutive switches of the same slot (NaN rescue excepted) — the
    same flapping protection as the training arbiter, vectorized.
    """

    n_levels: int = 2
    start_idx: int = 0               # rung a fresh request starts at (0 = cheapest)
    amp_threshold: float = 1e4       # |logit| escalation threshold (Q16.16 headroom)
    stable_steps: int = 8            # healthy steps before stepping back down
    cooldown_steps: int = 4          # min steps between switches of one slot
    #: speculative-decoding acceptance signal: a slot whose measured
    #: draft acceptance rate stays below ``accept_threshold`` for
    #: ``accept_patience`` consecutive measurements escalates its DRAFT
    #: rung one step (cheap drafts that keep getting rejected cost more
    #: than they save — a pure throughput signal; the f32 verify pass
    #: keeps the output distribution fixed regardless).
    accept_threshold: float = 0.5
    accept_patience: int = 4


class SlotArbiter:
    """Vectorized hysteresis state over ``n_slots`` serving slots.

    All state is host-side numpy (the decisions gate which jitted
    level-passes run, so they are host control flow by construction).
    ``observe`` consumes one decode step's per-slot signals and returns
    the updated per-slot level indices.
    """

    def __init__(self, n_slots: int, config: SlotArbiterConfig = SlotArbiterConfig(),
                 on_switch=None):
        if not 0 <= config.start_idx < config.n_levels:
            raise ValueError(f"start_idx {config.start_idx} outside ladder of {config.n_levels}")
        self.config = config
        self.n_slots = n_slots
        #: optional observer ``(step, slot, old_idx, new_idx, reason) ->
        #: None`` called on every switch — the serving telemetry's
        #: escalation counter/trace hook (kept as a plain callback so
        #: core/ stays import-independent of the telemetry layer).
        self.on_switch = on_switch
        self.idx = np.full((n_slots,), config.start_idx, np.int32)
        self.floor = np.full((n_slots,), config.start_idx, np.int32)
        self._stable = np.zeros((n_slots,), np.int32)
        self._low_accept = np.zeros((n_slots,), np.int32)
        self._last_switch = np.full((n_slots,), -(10**9), np.int64)
        #: recent (step, slot, old_idx, new_idx, reason) — bounded: a
        #: long-lived server must not grow state with lifetime traffic
        self.switches: deque = deque(maxlen=256)

    def reset_slot(self, slot: int, start_idx: Optional[int] = None) -> None:
        """Admission: a new request takes over the slot with fresh
        hysteresis state (levels never leak across requests).  The
        request's starting rung becomes the slot's demotion floor."""
        idx = self.config.start_idx if start_idx is None else int(start_idx)
        if not 0 <= idx < self.config.n_levels:
            raise ValueError(f"start_idx {idx} outside ladder of {self.config.n_levels}")
        self.idx[slot] = idx
        self.floor[slot] = idx
        self._stable[slot] = 0
        self._low_accept[slot] = 0
        self._last_switch[slot] = -(10**9)

    def observe(self, step: int, nonfinite, amplitude, active=None,
                acceptance=None) -> np.ndarray:
        """Feed one step's (n_slots,) signals; returns the new per-slot
        level indices.  ``active`` masks out empty slots (their state is
        frozen until the next admission).

        ``acceptance`` (optional, (n_slots,) float): measured speculative
        draft-acceptance rate in [0, 1]; NaN (or a negative value) marks
        slots with no measurement this step — their low-acceptance
        counter is left untouched.  Sustained low acceptance escalates
        one rung; the NaN rescue always takes precedence (a non-finite
        logit means the CURRENT rung's numerics are broken, which is a
        correctness signal, not a throughput one)."""
        cfg = self.config
        nonfinite = np.asarray(nonfinite, bool)
        amplitude = np.asarray(amplitude, np.float32)
        active = np.ones((self.n_slots,), bool) if active is None else np.asarray(active, bool)
        top = cfg.n_levels - 1

        cooled = (step - self._last_switch) >= cfg.cooldown_steps
        unhealthy = nonfinite | (amplitude > cfg.amp_threshold)

        self._stable = np.where(active & ~unhealthy, self._stable + 1, self._stable)
        self._stable[active & unhealthy] = 0

        if acceptance is not None:
            acceptance = np.asarray(acceptance, np.float32)
            measured = active & np.isfinite(acceptance) & (acceptance >= 0.0)
            low = measured & (acceptance < cfg.accept_threshold)
            self._low_accept = np.where(low, self._low_accept + 1, self._low_accept)
            self._low_accept[measured & ~low] = 0

        new_idx = self.idx.copy()
        # NaN rescue: straight to the top rung, no cooldown wait
        rescue = active & nonfinite & (self.idx < top)
        new_idx[rescue] = top
        # amplitude escalation: one rung, cooldown honored
        esc = active & ~nonfinite & (amplitude > cfg.amp_threshold) & (self.idx < top) & cooled
        new_idx[esc] = self.idx[esc] + 1
        # acceptance escalation: sustained low draft acceptance, one
        # rung, cooldown honored; health signals take precedence
        esc_acc = (active & ~unhealthy & (self._low_accept >= cfg.accept_patience)
                   & (self.idx < top) & cooled)
        new_idx[esc_acc] = self.idx[esc_acc] + 1
        self._low_accept[esc_acc] = 0
        # demotion: stable long enough, cooldown honored, floor respected
        dem = (active & ~unhealthy & ~esc_acc & (self.idx > self.floor)
               & (self._stable >= cfg.stable_steps) & cooled)
        new_idx[dem] = self.idx[dem] - 1

        changed = new_idx != self.idx
        self._last_switch[changed] = step
        self._stable[changed] = 0
        for s in np.nonzero(changed)[0]:
            reason = ("non-finite" if rescue[s]
                      else "amplitude" if esc[s]
                      else "acceptance" if esc_acc[s]
                      else "stable")
            self.switches.append((step, int(s), int(self.idx[s]), int(new_idx[s]), reason))
            if self.on_switch is not None:
                self.on_switch(step, int(s), int(self.idx[s]), int(new_idx[s]), reason)
        self.idx = new_idx
        return self.idx
