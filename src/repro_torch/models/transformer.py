"""Period-level block composition: a mixer (GQA attention, MLA or a
Mamba-2 SSD layer) with a SwiGLU MLP, a Mixture-of-Experts block or no
feed-forward behind it.

Reference: ``src/repro/models/transformer.py``.  A period is the
repeating unit of layers: one ``attn`` layer with ``ffn == "mlp"``
(deepseek_7b, command_r_35b; two for gemma2_2b's local / global pair) or
``"moe"`` (granite_moe_3b_a800m, mixtral_8x22b), one ``mla`` + ``mlp``
layer (minicpm3_4b), one ``mamba`` layer without a feed-forward
(mamba2_1_3b), or jamba's eight (attention at position 0, mamba at 1-7,
MoE on odd positions and an MLP on even ones).  The model loops over the
stacked periods in Python (PyTorch runs eagerly; there is no scan to
build).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.compat import replicated_like, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import mlp_specs, no_constrain, swiglu_mlp

__all__ = ["period_specs", "period_forward", "init_period_cache"]


def _mixer_specs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.kind == "attn":
        return attn.attn_specs(cfg)
    if spec.kind == "mla":
        return attn.mla_specs(cfg)
    if spec.kind == "mamba":
        return ssm_mod.ssm_specs(cfg)
    raise ValueError(spec.kind)


def _ffn_specs(cfg: ModelConfig, spec: LayerSpec) -> Optional[dict]:
    if spec.ffn == "mlp":
        return mlp_specs(cfg.d_model, cfg.d_ff)
    if spec.ffn == "moe":
        return moe_mod.moe_specs(cfg)
    return None


def period_specs(cfg: ModelConfig) -> dict:
    out = {}
    for i, spec in enumerate(cfg.period):
        entry = {"mixer": _mixer_specs(cfg, spec)}
        f = _ffn_specs(cfg, spec)
        if f is not None:
            entry["ffn"] = f
        out[f"pos{i}"] = entry
    return out


def init_period_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                      device=None, quantized: bool = False) -> dict:
    """Cache tree of ONE period; ``quantized``: int8 k/v payloads with
    per-(row, kv-head) exponents (``attention.init_attn_cache``; GQA
    layers only, as in the reference).  SSM caches are f32 whatever
    ``dtype`` is, as the reference's are."""
    device = resolve_device(device)
    out = {}
    for i, spec in enumerate(cfg.period):
        if spec.kind == "attn":
            out[f"pos{i}"] = attn.init_attn_cache(cfg, spec, batch, max_len, dtype, device,
                                                  quantized=quantized)
        elif spec.kind == "mla":
            out[f"pos{i}"] = attn.init_mla_cache(cfg, batch, max_len, dtype, device)
        elif spec.kind == "mamba":
            out[f"pos{i}"] = ssm_mod.init_ssm_cache(cfg, batch, device=device)
        else:
            raise ValueError(spec.kind)
    return out


def period_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                   mode: str = "precise", caches: Optional[dict] = None, prefill: bool = False,
                   lane_mask: Optional[torch.Tensor] = None,
                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   seg_aux: Optional[dict] = None, aux: bool = True,
                   constrain=no_constrain) -> Tuple[torch.Tensor, Optional[dict], Optional[torch.Tensor]]:
    """Apply one period; returns (x, caches, aux losses (2,)) with
    ``caches`` updated in place (the same dict) and ``aux`` the sum of
    the period's MoE losses (zeros without MoE; None with ``aux=False``,
    which serving passes: it reads no loss).
    ``rope``: the pass's (sin, cos) tables, handed to every attention
    and MLA layer (see ``attention.attention_forward``).  ``seg_aux``: a
    dict that a segment pass fills with each layer's rollback state under
    ``seg_aux[f"pos{i}"]`` (the rows an attention or MLA segment
    overwrote; an SSM layer's per-position states, conv history and
    pre-segment state, see ``ssm.ssm_forward``).  ``constrain``: the
    sharded cells' layout hook, handed to every layer and applied to the
    residual after each mixer and feed-forward (``transformer.py:122``,
    ``:130``)."""
    total = (replicated_like(x, torch.zeros((2,), dtype=torch.float32, device=x.device))
             if aux else None)
    for i, spec in enumerate(cfg.period):
        p = params[f"pos{i}"]
        cache_i = caches.get(f"pos{i}") if caches is not None else None
        layer_aux = {} if seg_aux is not None else None
        if spec.kind == "attn":
            h, _ = attn.attention_forward(
                p["mixer"], x, cfg, spec, positions=positions, mode=mode, cache=cache_i,
                prefill=prefill, lane_mask=lane_mask, rope=rope, seg_aux=layer_aux,
                constrain=constrain,
            )
        elif spec.kind == "mla":
            h, _ = attn.mla_forward(
                p["mixer"], x, cfg, positions=positions, mode=mode, cache=cache_i,
                prefill=prefill, lane_mask=lane_mask, rope=rope, seg_aux=layer_aux,
                constrain=constrain,
            )
        else:
            h, _ = ssm_mod.ssm_forward(p["mixer"], x, cfg, mode=mode, cache=cache_i,
                                       prefill=prefill, lane_mask=lane_mask, seg_aux=layer_aux,
                                       constrain=constrain)
        if seg_aux is not None:
            seg_aux[f"pos{i}"] = layer_aux
        x = constrain(x + h, "residual")
        if "ffn" not in p:
            continue
        if spec.ffn == "moe":
            h, a = moe_mod.moe_forward(p["ffn"], x, cfg, mode, aux=aux, constrain=constrain)
            if aux:
                total = total + a
        else:
            h = swiglu_mlp(p["ffn"], x, mode, cfg.rms_eps)
        x = constrain(x + h, "residual")
    return x, caches, total
