"""Optimizers (reference: ``src/repro/optim``): AdamW, and the Q-format
compressed data-parallel gradient mean with its train step."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
    opt_state_specs,
)
from repro_torch.optim.grad_compress import compressed_mean, make_dp_train_step

__all__ = ["AdamWConfig", "OptState", "adamw_update", "compressed_mean", "global_norm",
           "init_opt_state", "lr_schedule", "make_dp_train_step", "opt_state_specs"]
