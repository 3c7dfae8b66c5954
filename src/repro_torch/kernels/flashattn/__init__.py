"""K4: flash-attention forward (reference: ``src/repro/kernels/flashattn``)."""

from repro_torch.kernels.flashattn.flashattn import (
    KEY_TILE,
    NEG_INF,
    bf16_close,
    flash_attention,
    flash_attention_plain,
    p_rounding_case,
)

__all__ = ["KEY_TILE", "NEG_INF", "bf16_close", "flash_attention", "flash_attention_plain",
           "p_rounding_case"]
