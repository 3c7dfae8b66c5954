"""K4: flash-attention forward, with its written-out backward (reference:
``src/repro/kernels/flashattn``; the backward: ``models/attention.py::chunked_attention``)."""

from repro_torch.kernels.flashattn.flashattn import (
    KEY_TILE,
    NEG_INF,
    FlashAttentionFn,
    bf16_close,
    flash_attention,
    flash_attention_backward,
    flash_attention_plain,
    p_rounding_case,
)

__all__ = ["KEY_TILE", "NEG_INF", "FlashAttentionFn", "bf16_close", "flash_attention",
           "flash_attention_backward", "flash_attention_plain", "p_rounding_case"]
