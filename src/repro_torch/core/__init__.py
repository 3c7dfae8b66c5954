"""The engine core (reference: ``src/repro/core``): Q-format arithmetic,
power-of-two quantization, CORDIC bodies, the precision ladder with its
two-phase barrier, and the per-slot arbiter."""

from repro_torch.core.arbiter import SlotArbiter, SlotArbiterConfig
from repro_torch.core.precision import MathEngine, Mode, PrecisionLevel, PrecisionPolicy, resolve_level
from repro_torch.core.quantization import QTensor, QuantizedWeightCache, dequantize_pow2, quantize_pow2

__all__ = [
    "SlotArbiter",
    "SlotArbiterConfig",
    "MathEngine",
    "Mode",
    "PrecisionLevel",
    "PrecisionPolicy",
    "resolve_level",
    "QTensor",
    "QuantizedWeightCache",
    "dequantize_pow2",
    "quantize_pow2",
]
