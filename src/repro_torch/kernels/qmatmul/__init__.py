"""K1: Q-format int8 matmul (reference: ``src/repro/kernels/qmatmul``),
and its grouped entry for the MoE experts."""

from repro_torch.kernels.qmatmul.qmatmul import (
    EPILOGUES,
    MAX_K,
    qmatmul,
    qmatmul_grouped,
    qmatmul_plain,
)

__all__ = ["EPILOGUES", "MAX_K", "qmatmul", "qmatmul_plain", "qmatmul_grouped"]
