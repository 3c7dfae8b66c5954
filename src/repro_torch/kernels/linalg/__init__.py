"""The deferred-correction Q-format matmul, C3 (reference:
``src/repro/core/linalg.py``, plain JAX there; a hand-written kernel
here, ``kernels/csrc/linalg.cu``)."""

from repro_torch.kernels.linalg.deferred import qmatmul_deferred, qmatmul_deferred_plain

__all__ = ["qmatmul_deferred", "qmatmul_deferred_plain"]
