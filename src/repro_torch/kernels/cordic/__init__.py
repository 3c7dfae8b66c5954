"""K3: CORDIC sincos (reference: ``src/repro/kernels/cordic``, the
``cordic.py`` kernel; the universal-family kernels wait)."""

from repro_torch.kernels.cordic.cordic import (
    cordic_sincos,
    cordic_sincos_plain,
    rope_freq_limbs,
    rope_sincos_plain,
    rope_sincos_q16,
)

__all__ = ["cordic_sincos", "cordic_sincos_plain", "rope_freq_limbs", "rope_sincos_plain",
           "rope_sincos_q16"]
