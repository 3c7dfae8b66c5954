"""Period-level block composition (attention + SwiGLU MLP).

Reference: ``src/repro/models/transformer.py``.  A period is the
repeating unit of layers; the port carries the dense ``attn`` + ``mlp``
period of deepseek_7b.  MoE, MLA and Mamba periods wait (ROADMAP.md
queue 1 item 10).  The model loops over the stacked periods in Python
(PyTorch runs eagerly; there is no scan to build).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.compat import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import mlp_specs, swiglu_mlp

__all__ = ["period_specs", "period_forward", "init_period_cache"]


def _check_layer(spec: LayerSpec) -> None:
    if spec.kind != "attn" or spec.ffn != "mlp":
        raise NotImplementedError(
            f"layer kind {spec.kind!r} / ffn {spec.ffn!r}: only attn + mlp is ported "
            "(ROADMAP.md queue 1 item 10)")


def period_specs(cfg: ModelConfig) -> dict:
    out = {}
    for i, spec in enumerate(cfg.period):
        _check_layer(spec)
        out[f"pos{i}"] = {"mixer": attn.attn_specs(cfg), "ffn": mlp_specs(cfg.d_model, cfg.d_ff)}
    return out


def init_period_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                      device=None) -> dict:
    device = resolve_device(device)
    out = {}
    for i, spec in enumerate(cfg.period):
        _check_layer(spec)
        out[f"pos{i}"] = attn.init_attn_cache(cfg, spec, batch, max_len, dtype, device)
    return out


def period_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                   mode: str = "precise", caches: Optional[dict] = None, prefill: bool = False,
                   lane_mask: Optional[torch.Tensor] = None,
                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   seg_aux: Optional[dict] = None,
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Apply one period; returns (x, caches) with ``caches`` updated in
    place (the same dict).  ``rope``: the pass's (sin, cos) tables, handed
    to every attention layer (see ``attention.attention_forward``).
    ``seg_aux``: a dict that a segment pass fills with each layer's
    rollback state under ``seg_aux[f"pos{i}"]`` (the rows the segment
    overwrote; the reference records its SSM layers' states there)."""
    for i, spec in enumerate(cfg.period):
        p = params[f"pos{i}"]
        cache_i = caches.get(f"pos{i}") if caches is not None else None
        layer_aux = {} if seg_aux is not None else None
        h, _ = attn.attention_forward(
            p["mixer"], x, cfg, spec, positions=positions, mode=mode, cache=cache_i,
            prefill=prefill, lane_mask=lane_mask, rope=rope, seg_aux=layer_aux,
        )
        if seg_aux is not None:
            seg_aux[f"pos{i}"] = layer_aux
        x = x + h
        x = x + swiglu_mlp(p["ffn"], x, mode, cfg.rms_eps)
    return x, caches
