"""K2: fused FAST SwiGLU (reference: ``src/repro/kernels/fused_mlp``),
and its grouped entry for the MoE experts."""

from repro_torch.kernels.fused_mlp.fused_mlp import (
    fused_swiglu,
    fused_swiglu_grouped,
    fused_swiglu_plain,
    swiglu_body_q16,
)

__all__ = ["fused_swiglu", "fused_swiglu_plain", "fused_swiglu_grouped", "swiglu_body_q16"]
