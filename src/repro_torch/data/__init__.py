"""Data pipeline (reference: ``src/repro/data``)."""

from repro_torch.data.pipeline import DataConfig, SyntheticLM, host_shard

__all__ = ["DataConfig", "SyntheticLM", "host_shard"]
