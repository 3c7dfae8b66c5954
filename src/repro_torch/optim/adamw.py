"""AdamW with decoupled weight decay, global-norm clipping and a
warmup-cosine schedule, as plain functions on the parameter dict.

Reference: ``src/repro/optim/adamw.py`` — ``AdamWConfig``, ``OptState``,
``init_opt_state``, ``opt_state_specs``, ``lr_schedule``,
``global_norm`` and ``adamw_update``, with the reference's arithmetic in
its order (float32 throughout; the bias corrections ``1 - b**step`` in
f32).  The state mirrors the parameters (``m``, ``v`` per leaf, f32)
plus an int32 step, so the sharding rules that place the parameters
place the state identically (``opt_state_specs``, ``adamw.py:48-57``).
``torch.optim`` is not used.

``adamw_update`` writes the new parameters, ``m`` and ``v`` into the
given leaves, one leaf at a time, and returns the same trees (the
reference returns new ones): a second copy of a full-size model's
parameters and moments would not fit on the card beside the first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "opt_state_specs", "adamw_update",
           "lr_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 200
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor  # 0-dim int32


def _map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    """Leaves in sorted-key order (``jax.tree.leaves``' order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def init_opt_state(params: dict) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32, device=next(_leaves(params)).device)
    return OptState(m=_map(zeros, params), v=_map(zeros, params), step=step)


def opt_state_specs(param_specs_tree) -> OptState:
    """Spec tree of the optimizer state: the parameters' shapes and axes
    in f32 for ``m`` and ``v``, and a 0-dim int32 ``step``."""
    from repro_torch.models.layers import Spec

    def f32(s):
        if isinstance(s, Spec):
            return Spec(s.shape, s.axes, torch.float32, "zeros", s.scale)
        return {k: f32(v) for k, v in s.items()}

    return OptState(m=f32(param_specs_tree), v=f32(param_specs_tree),
                    step=Spec((), (), torch.int32, "zeros"))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_frac * lr``
    (f32, as the reference)."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    total = None
    for g in _leaves(tree):
        s = torch.sum(g.to(torch.float32) ** 2)
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: OptState):
    """Update ``params`` and ``state``'s moments in place; returns
    (params, new state, metrics ``grad_norm``, ``lr``)."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)

    step = state.step + 1
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        if scale is not None:
            g = g * scale
        g = g.to(torch.float32)
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        update = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (update + cfg.weight_decay * pf))
        m.copy_(m2)
        v.copy_(v2)

    _map(upd, params, grads, state.m, state.v)
    return params, OptState(state.m, state.v, step), {"grad_norm": gnorm, "lr": lr}
