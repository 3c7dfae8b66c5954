"""The CORDIC kernels (reference: ``src/repro/kernels/cordic``): K3
sincos (``cordic.py``) and the universal family K5-K7 (``universal.py``,
K6 and K7 with float entries too), with the float-boundary ops in
``ops.py``."""

from repro_torch.kernels.cordic.cordic import (
    cordic_sincos,
    cordic_sincos_plain,
    rope_freq_limbs,
    rope_sincos_plain,
    rope_sincos_q16,
)
from repro_torch.kernels.cordic.universal import (
    FLOAT_EDGES,
    UNARY_OPS,
    atan2_24_f32,
    atan2_24_f32_plain,
    atan2_f32,
    atan2_f32_plain,
    atan2_q16,
    atan2_q16_plain,
    div_f32,
    div_f32_plain,
    div_q16,
    div_q16_plain,
    universal_unary,
    universal_unary_plain,
)

__all__ = ["cordic_sincos", "cordic_sincos_plain", "rope_freq_limbs", "rope_sincos_plain",
           "rope_sincos_q16", "UNARY_OPS", "atan2_q16", "atan2_q16_plain", "div_q16",
           "div_q16_plain", "universal_unary", "universal_unary_plain", "atan2_f32",
           "atan2_f32_plain", "atan2_24_f32", "atan2_24_f32_plain", "div_f32", "div_f32_plain",
           "FLOAT_EDGES"]
