"""K4: flash-attention forward (reference: ``src/repro/kernels/flashattn``)."""

from repro_torch.kernels.flashattn.flashattn import NEG_INF, flash_attention, flash_attention_plain

__all__ = ["NEG_INF", "flash_attention", "flash_attention_plain"]
