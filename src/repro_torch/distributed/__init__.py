"""Sharding rules (reference: ``src/repro/distributed``): logical-axis
rules resolved to DTensor placements on a ``DeviceMesh``."""

from repro_torch.distributed.sharding import (
    NamedSharding,
    RuleSet,
    batch_pspec,
    placements_for,
    serve_rules,
    spec_sharding,
    train_rules,
    tree_shardings,
)

__all__ = ["NamedSharding", "RuleSet", "batch_pspec", "placements_for", "serve_rules",
           "spec_sharding", "train_rules", "tree_shardings"]
