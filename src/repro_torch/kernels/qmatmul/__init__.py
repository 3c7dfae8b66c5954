"""K1: Q-format int8 matmul (reference: ``src/repro/kernels/qmatmul``)."""

from repro_torch.kernels.qmatmul.qmatmul import EPILOGUES, MAX_K, qmatmul, qmatmul_plain

__all__ = ["EPILOGUES", "MAX_K", "qmatmul", "qmatmul_plain"]
