"""Period-level block composition: attention with a SwiGLU MLP or a
Mixture-of-Experts block behind it.

Reference: ``src/repro/models/transformer.py``.  A period is the
repeating unit of layers; the port carries ``attn`` layers with
``ffn == "mlp"`` (deepseek_7b, gemma2_2b, command_r_35b) or ``"moe"``
(granite_moe_3b_a800m, mixtral_8x22b).  MLA and Mamba periods wait
(ROADMAP.md queue 1 item 10).  The model loops over the stacked periods
in Python (PyTorch runs eagerly; there is no scan to build).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.compat import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import mlp_specs, swiglu_mlp

__all__ = ["period_specs", "period_forward", "init_period_cache"]


def _check_layer(spec: LayerSpec) -> None:
    if spec.kind != "attn" or spec.ffn not in ("mlp", "moe"):
        raise NotImplementedError(
            f"layer kind {spec.kind!r} / ffn {spec.ffn!r}: only attn + mlp / moe is ported "
            "(ROADMAP.md queue 1 item 10)")


def _ffn_specs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.ffn == "moe":
        return moe_mod.moe_specs(cfg)
    return mlp_specs(cfg.d_model, cfg.d_ff)


def period_specs(cfg: ModelConfig) -> dict:
    out = {}
    for i, spec in enumerate(cfg.period):
        _check_layer(spec)
        out[f"pos{i}"] = {"mixer": attn.attn_specs(cfg), "ffn": _ffn_specs(cfg, spec)}
    return out


def init_period_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                      device=None, quantized: bool = False) -> dict:
    """Cache tree of ONE period; ``quantized``: int8 k/v payloads with
    per-(row, kv-head) exponents (``attention.init_attn_cache``)."""
    device = resolve_device(device)
    out = {}
    for i, spec in enumerate(cfg.period):
        _check_layer(spec)
        out[f"pos{i}"] = attn.init_attn_cache(cfg, spec, batch, max_len, dtype, device,
                                              quantized=quantized)
    return out


def period_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                   mode: str = "precise", caches: Optional[dict] = None, prefill: bool = False,
                   lane_mask: Optional[torch.Tensor] = None,
                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   seg_aux: Optional[dict] = None, aux: bool = True,
                   ) -> Tuple[torch.Tensor, Optional[dict], Optional[torch.Tensor]]:
    """Apply one period; returns (x, caches, aux losses (2,)) with
    ``caches`` updated in place (the same dict) and ``aux`` the sum of
    the period's MoE losses (zeros without MoE; None with ``aux=False``,
    which serving passes: it reads no loss).
    ``rope``: the pass's (sin, cos) tables, handed to every attention
    layer (see ``attention.attention_forward``).  ``seg_aux``: a dict
    that a segment pass fills with each layer's rollback state under
    ``seg_aux[f"pos{i}"]`` (the rows the segment overwrote; the
    reference records its SSM layers' states there)."""
    total = torch.zeros((2,), dtype=torch.float32, device=x.device) if aux else None
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
        if spec.ffn == "moe":
            h, a = moe_mod.moe_forward(p["ffn"], x, cfg, mode, aux=aux)
            if aux:
                total = total + a
        else:
            h = swiglu_mlp(p["ffn"], x, mode, cfg.rms_eps)
        x = x + h
    return x, caches, total
