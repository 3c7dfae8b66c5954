"""K1: Q-format int8 matmul (reference: ``src/repro/kernels/qmatmul``),
its grouped entry for the MoE experts (ragged rows: ``live_rows``), and
the float ops over it
(``ops``: ``qmatmul_float`` and the straight-through ``qdot_ste``)."""

from repro_torch.kernels.qmatmul.qmatmul import (
    EPILOGUES,
    MAX_K,
    live_rows,
    qmatmul,
    qmatmul_grouped,
    qmatmul_plain,
)
from repro_torch.kernels.qmatmul.ops import DotFastSTE, qdot_ste, qmatmul_float

__all__ = ["EPILOGUES", "MAX_K", "qmatmul", "qmatmul_plain", "qmatmul_grouped", "live_rows",
           "DotFastSTE", "qdot_ste", "qmatmul_float"]
