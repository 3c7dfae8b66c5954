"""The decoder model (reference: ``src/repro/models``): the dense GQA +
SwiGLU family of deepseek_7b and gemma2_2b, with the paper's precision
modes dispatched per op (``layers.pdot`` / ``layers.rope_tables``), and
its prefill, decode and segment steps."""

from repro_torch.models.config import LayerSpec, ModelConfig, smoke_config
from repro_torch.models.model import (
    cache_layout,
    commit_segment,
    decode_step,
    init_caches,
    init_params,
    layer_params,
    param_specs,
    prefill_step,
    reset_cache_slot,
    segment_step,
    truncate_cache_slot,
    write_cache_slot,
)

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "smoke_config",
    "cache_layout",
    "commit_segment",
    "decode_step",
    "init_caches",
    "init_params",
    "layer_params",
    "param_specs",
    "prefill_step",
    "reset_cache_slot",
    "segment_step",
    "truncate_cache_slot",
    "write_cache_slot",
]
