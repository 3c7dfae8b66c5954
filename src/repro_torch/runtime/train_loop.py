"""Production training loop: the precision engine wired into a
fault-tolerant trainer, on the precision-ladder API.

Reference: ``src/repro/runtime/train_loop.py`` — ``TrainerConfig``,
``InjectedFailure`` and ``Trainer``:

* the train step is registered per precision level
  (``TRAIN_STEP_LEVELS``: the quantized path at ``q16_16``, the model's
  ``"fast"`` mode on K1, K3, K4 and K5; the float path at ``f32``, which
  lowers to the model's bf16 ``"precise"`` mode, as in the reference);
  ``engine.set_level`` between steps is the paper's pointer swap behind
  the two-phase barrier.  ``jit_switch=True`` dispatches through the
  engine's ``switched`` table by the current level's index (the
  reference's ``lax.switch`` executable; eager PyTorch has no trace to
  share);
* the ``PrecisionArbiter`` watches loss and grad norm and moves the
  engine along its ladder;
* checkpoints are atomic and async (``checkpoint.Checkpointer``), and a
  restart resumes from the newest (the data is keyed by step);
* a straggler watchdog keeps an EMA of the step's wall time and records
  steps slower than ``straggler_factor`` times it;
* ``crash_at_step`` injects a failure to exercise the restart path.

The step computes ``train_loss`` and its gradients with
``torch.autograd.grad`` and applies ``adamw_update`` in place (a second
copy of a full-size model's parameters and moments would not fit beside
the first).  ``device=None`` is the card, ``"cpu"`` the plain versions
of the kernels.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.compat import resolve_device
from repro_torch.core.arbiter import ArbiterConfig, PrecisionArbiter
from repro_torch.core.precision import MathEngine, Mode, resolve_level
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, train_loss
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state

__all__ = ["TrainerConfig", "Trainer", "InjectedFailure", "TRAIN_STEP_LEVELS", "make_train_step"]

#: engine levels the train step is implemented at, and the model-layer
#: mode each one lowers to
TRAIN_STEP_LEVELS = (("q16_16", "fast"), ("f32", "precise"))


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    start_mode: Any = Mode.PRECISE    # Mode compat alias or ladder level name
    use_arbiter: bool = False
    arbiter: ArbiterConfig = dataclasses.field(default_factory=ArbiterConfig)
    jit_switch: bool = False          # dispatch by the level's index (no host swap)
    straggler_factor: float = 3.0     # step slower than factor x EMA -> flagged
    crash_at_step: Optional[int] = None  # failure injection (tests)
    seed: int = 0


class InjectedFailure(RuntimeError):
    pass


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mode: str) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    at the model mode ``mode``: loss and gradients of every parameter
    leaf (each must require grad), then AdamW in place.  ``metrics``:
    ``train_loss``'s, ``loss``, ``grad_norm`` and ``lr`` (tensors)."""

    def step(params, opt_state, batch):
        loss, metrics = train_loss(params, batch, cfg, mode=mode)
        grads = torch.autograd.grad(loss, list(_leaves(params)))
        grads = _rebuild(params, iter(grads))
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach(), **om)

    return step


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 data_cfg: Optional[DataConfig] = None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or AdamWConfig(
            lr=1e-3,
            total_steps=tcfg.total_steps,
            warmup_steps=max(1, min(200, tcfg.total_steps // 10)),
        )
        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=min(cfg.max_seq, 64), global_batch=4
        )
        self.data = SyntheticLM(self.data_cfg)
        self.ckpt = Checkpointer(tcfg.ckpt_dir)
        self.engine = MathEngine(tcfg.start_mode)
        self.arbiter = self._make_arbiter(tcfg) if tcfg.use_arbiter else None
        self.history: list = []
        self.straggler_events: list = []
        self._ema_step_s: Optional[float] = None

        self._build_steps()
        self._init_state()

    # -- setup ---------------------------------------------------------------

    @staticmethod
    def _make_arbiter(tcfg: TrainerConfig) -> PrecisionArbiter:
        """The arbiter with its start rung synced to the engine's start
        level; a start level outside its ladder is a config error."""
        acfg = tcfg.arbiter
        start = resolve_level(tcfg.start_mode).name
        by_level = {resolve_level(e).name: e for e in acfg.ladder}
        if start not in by_level:
            raise ValueError(
                f"start_mode {tcfg.start_mode!r} (level {start}) is not in the "
                f"arbiter ladder {acfg.ladder!r}; pass an ArbiterConfig whose "
                f"ladder contains it"
            )
        if resolve_level(acfg.start_mode).name != start:
            acfg = dataclasses.replace(acfg, start_mode=by_level[start])
        return PrecisionArbiter(acfg)

    def _build_steps(self):
        # the dispatch table 𝒟, one step per ladder level
        self.engine.register("train_step", **{
            lv: make_train_step(self.cfg, self.opt_cfg, mode) for lv, mode in TRAIN_STEP_LEVELS})
        levels = tuple(lv for lv, _ in TRAIN_STEP_LEVELS)
        if self.tcfg.jit_switch:
            self._switched_step, self._switch_levels = self.engine.switched("train_step", levels)
        else:
            self._switched_step, self._switch_levels = None, levels

    def _run_step(self, batch):
        if self._switched_step is not None:
            idx = self.engine.level_index(self._switch_levels)
            return self._switched_step[idx](self.params, self.opt_state, batch)
        return self.engine.call("train_step", self.params, self.opt_state, batch)

    def _fresh_params(self) -> dict:
        params = init_params(self.cfg, seed=self.tcfg.seed, device=self.device)
        for leaf in _leaves(params):
            leaf.requires_grad_(True)
        return params

    def _init_state(self):
        latest = self.ckpt.latest_step()
        self.params = self._fresh_params()
        self.opt_state = init_opt_state(self.params)
        if latest is not None:
            state = self.ckpt.restore({"params": self.params, "opt": self.opt_state})
            with torch.no_grad():
                for dst, src in zip(_leaves(self.params), _leaves(state["params"])):
                    dst.copy_(src)
            self.opt_state = state["opt"]
            self.start_step = latest + 1
        else:
            self.start_step = 0

    # -- loop ----------------------------------------------------------------

    def run(self) -> Dict:
        t = self.tcfg
        for step in range(self.start_step, t.total_steps):
            if t.crash_at_step is not None and step == t.crash_at_step:
                raise InjectedFailure(f"injected failure at step {step}")

            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(step).items()}
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._run_step(batch)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            dt = time.perf_counter() - t0

            # straggler watchdog (step 0 seeds the EMA)
            if self._ema_step_s is None:
                self._ema_step_s = dt
            else:
                if dt > t.straggler_factor * self._ema_step_s:
                    self.straggler_events.append({"step": step, "dt": dt,
                                                  "ema": self._ema_step_s})
                self._ema_step_s = 0.9 * self._ema_step_s + 0.1 * dt

            self.history.append(
                {"step": step, "loss": loss, "grad_norm": gnorm,
                 "mode": self.engine.mode.value, "level": self.engine.level.name,
                 "dt": dt}
            )

            if self.arbiter is not None:
                rec = self.arbiter.observe(step, loss, gnorm)
                if rec is not None:
                    latency = self.engine.set_level(rec)
                    self.history[-1]["switched_to"] = getattr(rec, "value", rec)
                    self.history[-1]["switch_us"] = latency

            if t.ckpt_every and (step + 1) % t.ckpt_every == 0:
                self.ckpt.save(step, {"params": self.params, "opt": self.opt_state})

        self.ckpt.wait()
        return {
            "history": self.history,
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "straggler_events": self.straggler_events,
            "switches": self.engine.switch_stats.count,
        }
