"""The paper's primary contribution: the Dynamic Precision Math Engine.

Reference: ``src/repro/core``, whose exports are re-exported here for
every name the port has:

C1  Q-format fixed-point core          -> qformat.py
C2  CORDIC trigonometry                -> cordic.py (kernels K3, K5-K7)
C3  deferred-shift tiled matmul        -> linalg.py (+ kernels/linalg)
C4  runtime precision switching        -> precision.py / barrier.py
      + dynamic arbitration            -> arbiter.py
Tensor-scale Q formats                 -> quantization.py

Not here: ``PrecisionContext`` (the engine dispatches through
per-level tables instead) and the float-boundary CORDIC functions
(``cordic_atan2`` and family: the engine's ops, in
``kernels.cordic.ops``).
"""

from repro_torch.core.arbiter import (
    ArbiterConfig,
    PrecisionArbiter,
    SlotArbiter,
    SlotArbiterConfig,
)
from repro_torch.core.barrier import TwoPhaseBarrier, multihost_sync
from repro_torch.core.cordic import (
    ATAN_TABLE_Q16,
    CORDIC_K_INV_Q16,
    HYPER_STAGES,
    ITER_Q24,
    angle_consts,
    atan2_q24,
    cordic_rotate_q16,
    cordic_sincos,
    cordic_sincos24,
    cordic_sincos_q16,
    exact_rope_phase_q16,
    hyper_gain_inverse,
    hyperbolic_schedule,
    rope_inv_freq_q64,
)
from repro_torch.core.linalg import (
    derive_tile_size,
    matmul_float,
    qmatmul_deferred,
    qmatmul_per_element,
)
from repro_torch.core.precision import (
    MODE_ALIASES,
    OP_SET,
    MathEngine,
    Mode,
    PrecisionLevel,
    PrecisionPolicy,
    ladder,
    ladder_names,
    level,
    register_level,
    resolve_level,
)
from repro_torch.core.qformat import (
    Q0_7,
    Q1_15,
    Q8_8,
    Q8_24,
    Q16_16,
    QFormat,
    from_fixed,
    q_add,
    q_add_sat,
    q_mul,
    q_mul_sat,
    q_sub,
    q_sub_sat,
    static_footprint_bytes,
    to_fixed,
)
from repro_torch.core.quantization import (
    QTensor,
    QuantizedWeightCache,
    compress_with_feedback,
    dequantize_pow2,
    quantize_pow2,
    quantize_q16,
)

__all__ = [k for k in dir() if not k.startswith("_")]
