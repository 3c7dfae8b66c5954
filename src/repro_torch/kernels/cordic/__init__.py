"""The CORDIC kernels (reference: ``src/repro/kernels/cordic``): K3
sincos (``cordic.py``) and the universal family K5-K7 (``universal.py``),
with the float-boundary ops in ``ops.py``."""

from repro_torch.kernels.cordic.cordic import (
    cordic_sincos,
    cordic_sincos_plain,
    rope_freq_limbs,
    rope_sincos_plain,
    rope_sincos_q16,
)
from repro_torch.kernels.cordic.universal import (
    UNARY_OPS,
    atan2_q16,
    atan2_q16_plain,
    div_q16,
    div_q16_plain,
    universal_unary,
    universal_unary_plain,
)

__all__ = ["cordic_sincos", "cordic_sincos_plain", "rope_freq_limbs", "rope_sincos_plain",
           "rope_sincos_q16", "UNARY_OPS", "atan2_q16", "atan2_q16_plain", "div_q16",
           "div_q16_plain", "universal_unary", "universal_unary_plain"]
