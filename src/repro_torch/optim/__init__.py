"""Optimizers (reference: ``src/repro/optim``): AdamW.  The data-parallel
gradient compression (``grad_compress.py``) waits for ROADMAP.md queue 1
item 13: it runs inside a data-parallel mesh."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm", "init_opt_state",
           "lr_schedule"]
