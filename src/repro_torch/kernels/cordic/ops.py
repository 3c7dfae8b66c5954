"""Public float-boundary ops over the CORDIC kernels.

Reference: ``src/repro/kernels/cordic/ops.py``.  Floats are quantized to
Q16.16 (``core.qformat.to_fixed``), go through K3 (``sincos``,
``rope_tables``) or K5 (``unary_op``) — the kernel on a CUDA tensor, its
plain version on a CPU tensor — and come back as float32.  K6
(``atan2``) and K7 (``div``) take the float boundary inside: their float
entries read and write float32 in one pass, bit for bit that chain.
``atan2_24`` is the engine's ``q8_24`` atan2
(``src/repro/core/cordic.py::cordic_atan2_24``) on K6.
"""

from __future__ import annotations

import torch

from repro_torch.core.cordic import HYPER_STAGES, ITER_Q24, exact_rope_phase_q16
from repro_torch.core.qformat import Q16_16, from_fixed, to_fixed
from repro_torch.kernels.cordic.cordic import cordic_sincos
from repro_torch.kernels.cordic.universal import atan2_24_f32, atan2_f32, div_f32, universal_unary

__all__ = ["sincos", "rope_tables", "atan2", "atan2_24", "div", "unary_op"]


def _q(x) -> torch.Tensor:
    return to_fixed(x, Q16_16).contiguous()


def sincos(theta, iterations: int = 16):
    """float angles -> (sin, cos) float32 through K3."""
    sin_q, cos_q = cordic_sincos(_q(theta), iterations=iterations)
    return from_fixed(sin_q, Q16_16), from_fixed(cos_q, Q16_16)


def rope_tables(positions, f_hi, f_lo, iterations: int = 16, dtype=torch.float32):
    """Exact-phase RoPE tables: the Q0.64 phase, then K3; (S,) positions
    and (half,) uint32 frequency limbs -> (S, half) sin, cos in ``dtype``."""
    theta_q = exact_rope_phase_q16(positions[..., None], f_hi[None, :], f_lo[None, :])
    sin_q, cos_q = cordic_sincos(theta_q.contiguous(), iterations=iterations)
    return from_fixed(sin_q, Q16_16, dtype=dtype), from_fixed(cos_q, Q16_16, dtype=dtype)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32).contiguous()


def atan2(y, x, iterations: int = 16):
    """float (y, x) -> atan2 float32 through K6, Q16.16 inside."""
    return atan2_f32(_f32(y), _f32(x), iterations=iterations)


def atan2_24(y, x, iterations: int = ITER_Q24):
    """float (y, x) -> atan2 float32 on the Q8.24 grid through K6.  The
    operands are normalised by max(|y|, |x|) first, so any f32 magnitude
    fits the Q8.24 word (atan2 is scale-invariant)."""
    return atan2_24_f32(_f32(y), _f32(x), iterations=iterations)


def div(num, den, iterations: int = 17):
    """float (num, den) -> num / den float32 through K7 (saturates at the
    Q16.16 envelope)."""
    return div_f32(_f32(num), _f32(den), iterations=iterations)


def unary_op(w, op: str, stages: int = HYPER_STAGES):
    """float -> float universal unary op (sqrt, exp, log, tanh, sigmoid)
    through K5."""
    return from_fixed(universal_unary(_q(w), op, stages=stages), Q16_16)
